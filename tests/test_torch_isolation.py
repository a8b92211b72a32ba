"""The port stands alone: no module of `repro_torch`, and neither
`chip_smoke.py` nor the port's examples, imports jax or the JAX package,
and the default config refuses to fall back to the CPU when there is no
GPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                            .parts).replace(".__init__", "")
                  for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.kmeans" in mods
    assert "repro_torch.kernels.modmatmul" in mods
    for m in ("repro_torch.core.sparse", "repro_torch.core.he",
              "repro_torch.kernels.spmm", "repro_torch.kernels.ops",
              "repro_torch.kernels.ref", "repro_torch.kernels.esd",
              "repro_torch.kernels.argmin", "repro_torch.launch.kmeans_step",
              "repro_torch.launch.pipeline", "repro_torch.serve.service",
              "repro_torch.core.fraud", "repro_torch.core.normalize",
              "repro_torch.core.channel", "repro_torch.core.faultpoints",
              "repro_torch.checkpoint.store", "repro_torch.checkpoint.fit",
              "repro_torch.checkpoint.serve", "repro_torch.serve.wire",
              "repro_torch.launch.two_party", "repro_torch.obs",
              "repro_torch.obs.trace", "repro_torch.obs.metrics",
              "repro_torch.launch.supervisor",
              "repro_torch.launch.serve_kmeans",
              "repro_torch.configs", "repro_torch.configs.base",
              *(f"repro_torch.configs.{a}" for a in (
                  "command_r_35b", "deepseek_v2_236b", "gemma2_27b",
                  "granite_34b", "granite_moe_3b_a800m", "llama3_405b",
                  "llava_next_34b", "recurrentgemma_2b", "rwkv6_1b6",
                  "seamless_m4t_medium")),
              "repro_torch.models.layers", "repro_torch.models.recurrent",
              "repro_torch.models.lm", "repro_torch.models.tree",
              "repro_torch.serving.decode", "repro_torch.training.adamw",
              "repro_torch.training.compression",
              "repro_torch.training.train_step",
              "repro_torch.data.pipeline", "repro_torch.launch.train",
              "repro_torch.launch.serve", "repro_torch.models.sharding",
              "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
              "repro_torch.launch.roofline", "repro_torch.launch.perf",
              "repro_torch.configs.kmeans_fraud"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


def test_plans_import_neither_jax_nor_repro_nor_a_group():
    """The dry run, roofline and perf modules pull in no jax and no JAX
    package, and importing them starts no process group and no CUDA."""
    code = (
        "import sys, torch\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.launch.perf\n"
        "import torch.distributed as dist\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad), dist.is_initialized(),\n"
        "      torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"], out.stdout


def _imported_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted((ROOT / "examples").glob("*_torch.py")),
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_default_fit_refuses_cpu_fallback(monkeypatch):
    """With no GPU the default config (backend="cuda", device="cuda")
    raises instead of quietly running on the CPU."""
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(16, 4))
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        SecureKMeans(KMeansConfig(k=2, iters=1)).fit(x[:, :2], x[:, 2:])
    # asking for the cuda backend on CPU data raises too
    with pytest.raises(ValueError, match="backend='cuda' runs on"):
        KMeansConfig(k=2, iters=1, device="cpu")


def test_lm_entry_points_refuse_cpu_fallback(monkeypatch):
    """The LM launchers, `init_params` and `init_cache` default to cuda and
    raise without a GPU instead of running on the CPU."""
    from repro_torch.configs.base import all_archs
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import run
    from repro_torch.models.lm import init_params
    from repro_torch.serving.decode import init_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = all_archs()["granite-34b"].reduced
    for call in (lambda: run("granite-34b", steps=1, verbose=False),
                 lambda: serve("granite-34b", gen=1, verbose=False),
                 lambda: init_params(cfg, 0),
                 lambda: init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            call()


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_lm_launchers_default_to_cuda(module):
    """`python -m` each launcher with no --device on a machine without a
    GPU exits non-zero with the refusal; with --device cpu it runs."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    args = [sys.executable, "-m", module, "--arch", "granite-34b"]
    small = (["--steps", "2", "--batch", "2", "--seq", "16"]
             if module.endswith("train")
             else ["--batch", "1", "--prompt-len", "2", "--gen", "2"])
    out = subprocess.run(args + small, capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode != 0 and "needs a CUDA GPU" in out.stderr
    out = subprocess.run(args + small + ["--device", "cpu"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
