"""tests/test_models.py on the PyTorch port, on the CPU: per-arch smoke
(reduced configs, one forward and one train step, shape and NaN asserts)
and numerical consistency within the reference test's own tolerances:
flash == naive attention (2e-3), decode == teacher-forced forward (0.15,
argmax equal), chunked CE == direct CE (rtol 1e-5), and the MoE dispatch
invariants (padding inert, per-example == global within 0.02, sort-based
== brute force within 0.05); and the port's own: the MoE gradients
through its gather-both-ways dispatch equal plain autograd in f32."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import all_archs
from repro_torch.models import layers as L
from repro_torch.models.lm import (_pin_batch, ce_loss, forward, init_params,
                                   unstack)
from repro_torch.models.tree import leaves, unflatten_like
from repro_torch.serving.decode import init_cache, serve_step
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train_step import init_state, make_train_step

ARCHS = list(all_archs().items())
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch: the tensors are small, and the suite runs
    several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, b=2, t=64, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t)))}
    if cfg.enc_dec:
        batch["enc_inputs"] = torch.from_numpy(
            rng.normal(0, 1, (b, t, cfg.d_model))).to(torch.bfloat16)
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.n_patches, cfg.d_model))).to(
                torch.bfloat16)
    return batch


def _moe_params(cfg):
    params = init_params(cfg, 0, device=CPU)
    return unstack(params["groups"][0]["b0"]["moe"])[0]


# ---------------------------------------------------------------------------
# per-arch smoke: reduced config, one forward + one train step on CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,spec", ARCHS, ids=[a for a, _ in ARCHS])
def test_arch_smoke_forward_and_train(arch_id, spec):
    cfg = spec.reduced
    params = init_params(cfg, 0, device=CPU)
    batch = _batch(cfg)
    with torch.no_grad():
        hidden = forward(params, cfg, tokens=batch["tokens"],
                         enc_inputs=batch.get("enc_inputs"),
                         patch_embeds=batch.get("patch_embeds"))
    assert hidden.shape == (2, 64, cfg.d_model)
    assert bool(torch.isfinite(hidden.float()).all())
    step = make_train_step(cfg, AdamWConfig())
    state = init_state(params, AdamWConfig())
    new_params, _, metrics = step(params, state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    # params actually moved
    delta = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(leaves(params), leaves(new_params)))
    assert delta > 0


@pytest.mark.parametrize("arch_id,spec", ARCHS, ids=[a for a, _ in ARCHS])
def test_arch_smoke_decode(arch_id, spec):
    cfg = spec.reduced
    params = init_params(cfg, 0, device=CPU)
    cache = init_cache(cfg, 2, 32, enc_len=16 if cfg.enc_dec else 0,
                       device=CPU)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for pos in range(3):
        logits, cache = serve_step(params, cfg, cache, tok, pos)
    assert logits.shape == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# decode == teacher-forced forward (the KV cache/state paths are exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["granite-34b", "gemma2-27b",
                                     "deepseek-v2-236b", "rwkv6-1.6b",
                                     "recurrentgemma-2b",
                                     "granite-moe-3b-a800m"])
def test_decode_matches_forward(arch_id):
    # generous MoE capacity: the forward path drops overflow tokens by design
    # (cap_factor 1.25); exact decode==forward needs no drops
    cfg = dataclasses.replace(all_archs()[arch_id].reduced,
                              capacity_factor=8.0)
    params = init_params(cfg, 0, device=CPU)
    rng = np.random.default_rng(1)
    t = 8
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t)))
    with torch.no_grad():
        hidden = forward(params, cfg, tokens=tokens, remat=False)
        logits_fwd = (hidden[:, -1].to(torch.bfloat16)
                      @ params["head"]).float()
    cache = init_cache(cfg, 1, t, device=CPU)
    for pos in range(t):
        logits_dec, cache = serve_step(params, cfg, cache,
                                       tokens[:, pos:pos + 1], pos)
    np.testing.assert_allclose(logits_dec.numpy(), logits_fwd.numpy(),
                               rtol=0.15, atol=0.15)
    assert int(logits_dec.argmax(-1)[0]) == int(logits_fwd.argmax(-1)[0])


# ---------------------------------------------------------------------------
# attention: flash-chunked == naive; window masking
# ---------------------------------------------------------------------------

def _naive_attention(q, k, v, causal, window, scale, cap):
    b, tq, h, dk = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, tq, hkv, g, dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    s = L.softcap(s, cap)
    qp, kp = torch.arange(tq), torch.arange(k.shape[1])
    mask = torch.ones((tq, k.shape[1]), dtype=torch.bool)
    if causal:
        mask &= kp[None] <= qp[:, None]
    if window:
        mask &= kp[None] > qp[:, None] - window
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, -1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, tq, h, v.shape[-1])


@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                               (True, 16, None),
                                               (True, None, 50.0),
                                               (False, None, None)])
def test_flash_matches_naive(causal, window, cap):
    rng = np.random.default_rng(0)
    b, t, h, hkv, d = 2, 100, 4, 2, 16
    q = torch.from_numpy(rng.normal(0, 1, (b, t, h, d))).float()
    k = torch.from_numpy(rng.normal(0, 1, (b, t, hkv, d))).float()
    v = torch.from_numpy(rng.normal(0, 1, (b, t, hkv, d))).float()
    got = L.flash_attention(q, k, v, causal=causal, window=window,
                            scale=0.25, cap=cap, kv_chunk=32)
    want = _naive_attention(q, k, v, causal, window, 0.25, cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# chunked CE == direct CE
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_direct():
    cfg = all_archs()["granite-34b"].reduced
    params = init_params(cfg, 0, device=CPU)
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(0, 1, (2, 64, cfg.d_model))).to(
        torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    got = ce_loss(params, cfg, h, labels, chunk=16)
    logits = (h @ params["head"]).float()
    lse = torch.logsumexp(logits, -1)
    true = torch.gather(logits, -1, labels[..., None])[..., 0]
    want = (lse - true).mean()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE dispatch invariants
# ---------------------------------------------------------------------------

def test_moe_capacity_and_padding():
    cfg = all_archs()["granite-moe-3b-a800m"].reduced
    moe_p = _moe_params(cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 32, cfg.d_model))).to(
        torch.bfloat16)
    out = L.moe_mlp(moe_p, x, cfg)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out.float()).all())
    # padded experts exist in weights but receive nothing: zeroing their
    # weights must not change the output
    ep = moe_p["w_gate"].shape[0]
    assert ep % 16 == 0 and ep >= cfg.n_experts
    moe_p2 = dict(moe_p)
    for nm in ("w_gate", "w_up", "w_down"):
        w = moe_p[nm].clone()
        w[cfg.n_experts:] = 0
        moe_p2[nm] = w
    out2 = L.moe_mlp(moe_p2, x, cfg)
    np.testing.assert_allclose(out.float().numpy(), out2.float().numpy())


def test_moe_per_example_matches_global():
    """The per-example (local-sort) dispatch == global dispatch when no
    tokens are dropped (generous capacity)."""
    base = dataclasses.replace(all_archs()["granite-moe-3b-a800m"].reduced,
                               capacity_factor=8.0)
    moe_p = _moe_params(base)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (3, 16, base.d_model))).to(
        torch.bfloat16)
    got_g = L.moe_mlp(moe_p, x, base).float().numpy()
    cfg_pe = dataclasses.replace(base, moe_dispatch="per_example")
    got_pe = L.moe_mlp(moe_p, x, cfg_pe).float().numpy()
    np.testing.assert_allclose(got_g, got_pe, rtol=0.02, atol=0.02)


def test_moe_matches_dense_reference():
    """Sort-based dispatch == brute-force per-token expert evaluation
    (with generous capacity so nothing is dropped)."""
    cfg = dataclasses.replace(all_archs()["granite-moe-3b-a800m"].reduced,
                              capacity_factor=8.0)
    moe_p = _moe_params(cfg)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (1, 16, cfg.d_model))).to(
        torch.bfloat16)
    got = L.moe_mlp(moe_p, x, cfg).float().numpy()

    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf.float() @ moe_p["router"].float(), -1)
    gate, ids = torch.topk(probs, cfg.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    want = np.zeros_like(got).reshape(-1, cfg.d_model)
    for tkn in range(xf.shape[0]):
        for j in range(cfg.top_k):
            e = int(ids[tkn, j])
            h = xf[tkn: tkn + 1]
            ge = torch.nn.functional.silu(h @ moe_p["w_gate"][e]) \
                * (h @ moe_p["w_up"][e])
            want[tkn] += float(gate[tkn, j]) * (
                ge @ moe_p["w_down"][e]).float().numpy()[0]
    np.testing.assert_allclose(got.reshape(-1, cfg.d_model), want,
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dispatch", ["global", "per_example"])
def test_moe_gradients_match_brute_force(dispatch):
    """The dispatch and combine gather in both directions (`_GatherRows`):
    their gradients equal plain autograd through a per-token evaluation of
    the chosen experts, in f32 within 2e-3 (the f32 tolerance of
    test_flash_matches_naive), generous capacity so nothing is dropped."""
    cfg = dataclasses.replace(all_archs()["granite-moe-3b-a800m"].reduced,
                              capacity_factor=8.0, moe_dispatch=dispatch)
    moe_p = {k: v.float() for k, v in _moe_params(cfg).items()}
    x0 = torch.randn(3, 16, cfg.d_model,
                     generator=torch.Generator().manual_seed(0))

    def grads(fn):
        x = x0.clone().requires_grad_(True)
        w = {k: v.clone().requires_grad_(True) for k, v in moe_p.items()}
        out = fn(w, x)
        return torch.autograd.grad(out.square().sum(), [x, *w.values()])

    def brute(w, x):
        xf = x.reshape(-1, cfg.d_model)
        gate, ids = L._router(w, xf[None], cfg)
        gate, ids = gate[0], ids[0]
        out = torch.zeros_like(xf)
        for j in range(cfg.top_k):
            e = ids[:, j]
            h = torch.nn.functional.silu(
                torch.einsum("nd,ndf->nf", xf, w["w_gate"][e])) \
                * torch.einsum("nd,ndf->nf", xf, w["w_up"][e])
            out = out + gate[:, j:j + 1] * torch.einsum(
                "nf,nfd->nd", h, w["w_down"][e])
        return out.reshape(x.shape)

    got = grads(lambda w, x: L.moe_mlp(w, x, cfg))
    want = grads(brute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-3 * float(w.abs().max()))


def test_remat_policies_give_the_same_gradients():
    """remat off, "none" (checkpoint each unit) and "dots" (a selective
    checkpoint that keeps matmul outputs) recompute the same function: the
    same loss and gradients, word for word."""
    base = all_archs()["gemma2-27b"].reduced
    params = init_params(base, 0, device=CPU)
    batch = _batch(base, t=32)
    out = []
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        cfg = dataclasses.replace(base, remat_policy=policy)
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        tree = unflatten_like(params, flat)
        hidden = forward(tree, cfg, tokens=batch["tokens"], remat=remat)
        loss = ce_loss(tree, cfg, hidden, batch["labels"])
        out.append((loss.detach(), torch.autograd.grad(loss, flat)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for a, b in zip(grads, out[0][1]):
            assert torch.equal(a, b)


def test_act_axes_refused_without_a_mesh():
    """act_axes pins only DTensors to a mesh: a plain or meta tensor has no
    mesh, so the pin is refused (the tensor passes as it is) and the
    forward with act_axes=("data",) is the forward without."""
    base = all_archs()["granite-34b"].reduced
    cfg = dataclasses.replace(base, act_axes=("data",))
    for x in (torch.zeros(2, 4), torch.empty(2, 4, device="meta")):
        assert _pin_batch(x, cfg) is x
    params = init_params(cfg, 0, device=CPU)
    tokens = torch.arange(8, dtype=torch.long).reshape(2, 4) % base.vocab_size
    with torch.no_grad():
        pinned = forward(params, cfg, tokens=tokens)
        plain = forward(params, base, tokens=tokens)
    assert torch.equal(pinned, plain)
