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
import socket
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


def start_ranks(code: str, arg) -> list:
    """Four processes running `code` as ranks 0-3 of a gloo group at a
    free localhost port (argv: rank, port, arg)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                              str(arg)], cwd=str(ROOT), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for r in range(4)]


# `launch/dryrun.py:replication` of reduced archs on the fake (2, 4) mesh at
# global batch 2: (shape, [arch ids]) -> {arch: record}
TP_CHILD = """
import json
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh(dryrun.TP_MESH, ("data", "model"))
print(json.dumps({a: dryrun.replication(a, %r, mesh, 2) for a in %r}))
"""


def check_ratio(rec, arch_id, shape):
    """A `TP_CHILD` record: counted per device with its collectives, at
    most its bound."""
    from repro_torch.launch import dryrun
    assert (rec["arch"], rec["shape"], rec["global_batch"], rec["mesh"]) \
        == (arch_id, shape, 2, "2x4")
    assert rec["count_basis"] == "per-device"
    assert "collective_error" not in rec
    assert rec["bound"] == max(1.10, dryrun.REFERENCE_RATIOS.get(
        (arch_id, shape), 0.0))
    assert rec["ratio"] <= rec["bound"], rec["top_ops"]
    # the device counted (at a busiest rank of the query-sequence split)
    # does at least its share of the step
    assert rec["ratio"] >= 0.999
    assert rec["link_bytes"] > 0
    assert not dryrun.tp_ratio_fails(rec)
