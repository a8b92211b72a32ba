"""The LM substrate on the card against the CPU: forward, lm_loss, one
train step and decode for a few reduced configs on one CPU-drawn tree
carried to both devices, the MoE dispatch and combine and a whole train
step bit for bit repeatable with no non-deterministic op
(`torch.use_deterministic_algorithms(True, warn_only=True)` warns on each),
and the sliced AdamW update equal to the whole-leaf one. Needs an NVIDIA
GPU; skipped without one. Imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_lm_cuda.py

Tolerances: bf16 hidden states and logits within a relative L2 error of
0.05 (tests/test_models.py's MoE-vs-dense value), the loss within rtol
1e-3; f32 values within rtol 1e-4 (the resume test's); the first AdamW
step's parameters within 2 lr_1 plus one ulp (Adam's first step is
lr_1 sign(g))."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.base import all_archs
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.tree import flatten_with_path, leaves, tree_map
from repro_torch.serving.decode import init_cache, serve_step
from repro_torch.training import adamw
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train_step import init_state, make_train_step

pytestmark = pytest.mark.cuda
DEVICES = ("cpu", "cuda")
LR1 = AdamWConfig().lr * 2 / AdamWConfig().warmup_steps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # the f32 router and recurrences in full FP32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(want, got) -> float:
    w, g = want.double().cpu(), got.double().cpu()
    return float((g - w).norm() / max(float(w.norm()), 1e-30))


def _batch(cfg, device, f32=False, b=2, t=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t)))}
    if f32:
        del batch["tokens"]
        batch["embeds"] = torch.from_numpy(
            rng.normal(0, 1, (b, t, cfg.d_model))).float()
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.n_patches, cfg.d_model))).to(
                torch.float32 if f32 else torch.bfloat16)
    return {k: v.to(device) for k, v in batch.items()}


def _trees(cfg, f32=False):
    tree = lm.params_to_numpy(lm.init_params(cfg, 0, device="cpu"))
    out = {}
    for dev in DEVICES:
        p = lm.params_from_numpy(tree, dev)
        if f32:
            p = tree_map(lambda t: t.float(), p)
            p["head"] = p["head"].to(torch.bfloat16)
        out[dev] = p
    return out


def _step(cfg, params, batch):
    opt = AdamWConfig()
    return make_train_step(cfg, opt)(params, init_state(params, opt), batch)


@pytest.mark.parametrize("arch", ["granite-34b", "gemma2-27b",
                                  "granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "rwkv6-1.6b", "recurrentgemma-2b"])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_reduced_gpu_equals_cpu(cuda, arch, f32):
    cfg = all_archs()[arch].reduced
    p = _trees(cfg, f32)
    b = {dev: _batch(cfg, dev, f32) for dev in DEVICES}
    with torch.no_grad():
        h = {dev: lm.forward(p[dev], cfg, tokens=b[dev].get("tokens"),
                             embeds=b[dev].get("embeds"),
                             patch_embeds=b[dev].get("patch_embeds"))
             for dev in DEVICES}
    if f32:
        np.testing.assert_allclose(h["cuda"].cpu().numpy(),
                                   h["cpu"].numpy(), rtol=2e-3, atol=2e-3)
    else:
        assert _rel_l2(h["cpu"], h["cuda"]) <= 0.05
    step = {dev: _step(cfg, p[dev], b[dev]) for dev in DEVICES}
    rtol = 1e-4 if f32 else 1e-3
    np.testing.assert_allclose(float(step["cuda"][2]["loss"]),
                               float(step["cpu"][2]["loss"]), rtol=rtol)
    if f32:
        np.testing.assert_allclose(float(step["cuda"][2]["grad_norm"]),
                                   float(step["cpu"][2]["grad_norm"]),
                                   rtol=rtol)
        for a, g in zip(leaves(step["cpu"][1]["adam"]["m"]),
                        leaves(step["cuda"][1]["adam"]["m"])):
            assert _rel_l2(a, g) <= 2e-3      # the gradients, as m = 0.1 g
    eps = 2.0 ** -23 if f32 else 2.0 ** -7
    for (path, a), (_, g) in zip(flatten_with_path(step["cpu"][0]),
                                 flatten_with_path(step["cuda"][0])):
        a, g = a.double(), g.double().cpu()
        assert bool(((g - a).abs() <= 2 * LR1 * 1.001 + eps * a.abs())
                    .all()), path


@pytest.mark.parametrize("arch", ["granite-34b", "gemma2-27b",
                                  "deepseek-v2-236b", "rwkv6-1.6b",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_reduced_decode_gpu_equals_cpu(cuda, arch):
    cfg = all_archs()[arch].reduced
    p = _trees(cfg)
    enc = 8 if cfg.enc_dec else 0
    cache = {dev: init_cache(cfg, 2, 8, enc_len=enc, device=dev)
             for dev in DEVICES}
    toks = _batch(cfg, "cpu", t=4, seed=3)["tokens"]
    for pos in range(4):
        logits = {}
        for dev in DEVICES:
            logits[dev], cache[dev] = serve_step(
                p[dev], cfg, cache[dev], toks[:, pos:pos + 1].to(dev), pos)
        assert _rel_l2(logits["cpu"], logits["cuda"]) <= 0.05


def _nondeterministic_warnings(fn):
    """Runs fn under deterministic-algorithms warn mode; returns the
    warnings that name a non-deterministic op (cuBLAS's workspace
    configuration warning aside: a matmul on one stream repeats)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.use_deterministic_algorithms(False)
    bad = [str(w.message) for w in seen
           if "deterministic" in str(w.message)
           and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]
    return out, bad


@pytest.mark.parametrize("dispatch", ["global", "per_example"])
def test_moe_dispatch_and_combine_deterministic(cuda, dispatch):
    cfg = dataclasses.replace(all_archs()["granite-moe-3b-a800m"].reduced,
                              moe_dispatch=dispatch)
    moe = lm.unstack(lm.init_params(cfg, 0, device=cuda)["groups"][0]["b0"]
                     ["moe"])[0]
    x0 = torch.randn(4, 64, cfg.d_model, generator=torch.Generator(
        cuda).manual_seed(1), device=cuda).to(torch.bfloat16)

    def once():
        x = x0.clone().requires_grad_(True)
        w = [moe["w_gate"].clone().requires_grad_(True),
             moe["router"].clone().requires_grad_(True)]
        out = L.moe_mlp({**moe, "w_gate": w[0], "router": w[1]}, x, cfg)
        grads = torch.autograd.grad(out.float().square().sum(), [x, *w])
        return out, grads

    (out1, g1), bad = _nondeterministic_warnings(once)
    assert not bad, bad
    out2, g2 = once()
    assert torch.equal(out1, out2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_train_step_deterministic(cuda):
    """Two train steps from one state give the same words (the resume
    check of chip_smoke phase 9c rests on it)."""
    cfg = all_archs()["granite-moe-3b-a800m"].reduced
    params = lm.init_params(cfg, 0, device=cuda)
    batch = _batch(cfg, cuda, t=64)
    (p1, _, m1), bad = _nondeterministic_warnings(
        lambda: _step(cfg, params, batch))
    assert not bad, bad
    p2, _, m2 = _step(cfg, params, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b)


def test_adamw_sliced_update_equals_whole_leaf(cuda, monkeypatch):
    gen = torch.Generator(cuda).manual_seed(2)
    params = {"w": torch.randn(6, 33, 17, generator=gen, device=cuda).to(
        torch.bfloat16), "b": torch.randn(5, generator=gen, device=cuda)}
    grads = [{k: torch.randn(v.shape, generator=gen, device=cuda)
              for k, v in params.items()} for _ in range(3)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)

    def run():
        p, st = params, adamw.init_opt_state(params, cfg)
        for g in grads:
            p, st = adamw.apply_updates(p, g, st, cfg)
        return p, st

    whole = run()
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 40)
    sliced = run()
    for a, b in zip(leaves(whole), leaves(sliced)):
        assert torch.equal(a, b)
