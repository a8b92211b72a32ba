"""Shared helpers of the multi-device plan tests (the port's sharding specs,
meshes, dry run and roofline against the JAX package's).

The JAX package's `launch/dryrun.py` sets XLA_FLAGS to 512 host devices
when it is imported (`roofline` and `perf` import it). The backend of this
process has started by then (`jax.devices()` first), so the flag changes
nothing here; it is restored at once so that no later subprocess of the
worker inherits it.

The port's production meshes live on torch's fake process group, one
default group a process: those parts run in a child process (`run_child`)
that prints one JSON line."""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _import_keeping_xla_flags(module: str):
    import importlib
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(module)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@functools.lru_cache(maxsize=None)
def ref_dryrun():
    return _import_keeping_xla_flags("repro.launch.dryrun")


@functools.lru_cache(maxsize=None)
def ref_roofline():
    return _import_keeping_xla_flags("repro.launch.roofline")


def abstract_mesh(shape, names):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(shape), tuple(names))


def run_child(code: str, timeout: int = 300):
    """Run `code` in a fresh interpreter (the port on the CPU, torch
    single-threaded) and return the JSON object it prints last."""
    prelude = "import torch\ntorch.set_num_threads(1)\n"
    out = subprocess.run(
        [sys.executable, "-c", prelude + code], capture_output=True,
        text=True, timeout=timeout, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
