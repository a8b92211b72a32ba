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
              "repro_torch.kernels.argmin"):
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
