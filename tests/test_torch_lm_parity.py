"""The LM substrate of the PyTorch port against the JAX package, on the
CPU: configs (repr, fingerprint, parameter counts) for all 20 configs,
and each module on the same inputs: flash attention, the chunked CE, the
MoE router and dispatch, RWKV6 time-mix and RG-LRU with their states, and
decode over 4 positions for every reduced config, on the reference's
parameters carried across (`params_from_numpy`).

Tolerances, none looser than tests/test_models.py's:
- f32 math on the same inputs (flash attention, the group norm): 2e-3,
  the flash-vs-naive tolerance; the chunked CE: rtol 1e-5;
- one module on the same bf16 inputs (MoE, RWKV, RG-LRU; their f32
  states too, which are sums over bf16 projections): rtol = atol = 0.02,
  the per-example-vs-global tolerance; router ids equal;
- decode logits (bf16 model, 4 positions): relative L2 error <= 0.05 (the
  MoE-vs-dense value) and the argmax equal wherever the reference's top
  two logits are more than 2 x 0.15 apart (the decode-vs-forward bound).
  A whole bf16 model is compared by its relative L2 error, not element by
  element: XLA keeps bf16 dot outputs in f32 where an f32 op consumes
  them, the port rounds them as written, and ill-conditioned steps (RWKV's
  group norm on the first tokens) amplify a one-ulp input difference in a
  few elements, as they do between the reference's own jit and eager runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import config_fingerprint as jax_fingerprint
from repro.configs.base import all_archs as jax_archs
from repro.models import layers as JL
from repro.models import lm as JM
from repro.models import recurrent as JR
from repro.serving import decode as JD
from repro_torch.checkpoint.store import config_fingerprint
from repro_torch.configs.base import all_archs
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.models import recurrent as R
from repro_torch.models.tree import flatten_with_path, leaves
from repro_torch.serving import decode as D

from _lm_parity import (as_np, jax_batch, jax_params,  # noqa: F401
                        one_torch_thread,
                        port_batch, port_params, rel_l2)

ARCH_IDS = sorted(jax_archs())
CONFIGS = [(a, w) for a in ARCH_IDS for w in ("config", "reduced")]


def _bf16(x: np.ndarray):
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(as_np(j))).to(torch.bfloat16)


def _block(arch: str, kind_pred, cfg_replace=None):
    """One stacked block of the reduced config, repeat 0, in both
    packages: (jax cfg, port cfg, jax block params, port block params)."""
    jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
    jp = jax_params(jc)
    tp = port_params(jp)
    if cfg_replace:
        jc = dataclasses.replace(jc, **cfg_replace)
        tc = dataclasses.replace(tc, **cfg_replace)
    for gi, grp in enumerate(jc.groups):
        for bi, kind in enumerate(grp.unit):
            if kind_pred(kind):
                pj = jax.tree.map(lambda a: a[0], jp["groups"][gi][f"b{bi}"])
                pt = M.unstack(tp["groups"][gi][f"b{bi}"])[0]
                return jc, tc, pj, pt
    raise LookupError(arch)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,which", CONFIGS,
                         ids=[f"{a}-{w}" for a, w in CONFIGS])
def test_config_repr_fingerprint_and_counts(arch, which):
    jc = getattr(jax_archs()[arch], which)
    tc = getattr(all_archs()[arch], which)
    assert repr(tc) == repr(jc)
    assert config_fingerprint(tc) == jax_fingerprint(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert all_archs()[arch].skip_shapes == jax_archs()[arch].skip_shapes


def test_shape_only_tree_matches_reference_leaves():
    """Keys, shapes and dtypes of every reduced config's tree."""
    for arch in ARCH_IDS:
        jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
        want = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
                for p, a in jax.tree_util.tree_flatten_with_path(
                    JM.init_params_shape_only(jc))[0]]
        got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in flatten_with_path(M.init_params_shape_only(tc))]
        assert got == want, arch
        drawn = M.init_params(tc, 3, device="cpu")
        assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for p, t in flatten_with_path(drawn)] == want


# ---------------------------------------------------------------------------
# attention and loss on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,cap,q_offset", [
    (True, None, None, 0), (True, 16, None, 0), (True, None, 50.0, 0),
    (False, None, None, 0), (True, 24, None, 40)])
def test_flash_attention_matches_reference(causal, window, cap, q_offset):
    rng = np.random.default_rng(0)
    b, t, h, hkv, d = 2, 100, 4, 2, 16
    q = rng.normal(0, 1, (b, t - q_offset, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, hkv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=0.25, cap=cap,
              q_offset=q_offset, kv_chunk=32, q_chunk=48)
    want = jax.jit(lambda q, k, v: JL.flash_attention(q, k, v, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = L.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-3,
                               atol=2e-3)


def test_ce_loss_matches_reference():
    jc, tc = jax_archs()["gemma2-27b"].reduced, all_archs()[
        "gemma2-27b"].reduced            # final softcap on
    jp = jax_params(jc)
    tp = port_params(jp)
    rng = np.random.default_rng(2)
    hj, ht = _bf16(rng.normal(0, 1, (2, 64, jc.d_model)))
    labels = rng.integers(0, jc.vocab_size, (2, 64))
    want = jax.jit(lambda p, h, lab: JM.ce_loss(p, jc, h, lab, chunk=16))(
        jp, hj, jnp.asarray(labels))
    got = M.ce_loss(tp, tc, ht, torch.from_numpy(labels), chunk=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE: router ids first, then values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dispatch", [
    ("granite-moe-3b-a800m", "global"), ("granite-moe-3b-a800m",
                                         "per_example"),
    ("deepseek-v2-236b", "global"), ("deepseek-v2-236b", "per_example")])
def test_moe_router_ids_then_values(arch, dispatch):
    jc, tc, pj, pt = _block(arch, lambda k: k in ("moe_attn", "mla"),
                            {"moe_dispatch": dispatch})
    rng = np.random.default_rng(6)
    xj, xt = _bf16(rng.normal(0, 1, (2, 32, jc.d_model)))
    logits = (xj.reshape(-1, jc.d_model).astype(jnp.float32)
              @ pj["moe"]["router"].astype(jnp.float32))
    _, ids_j = jax.lax.top_k(jax.nn.softmax(logits, -1), jc.top_k)
    _, ids_t = L._router(pt["moe"], xt.reshape(1, -1, tc.d_model), tc)
    ids_j, ids_t = np.asarray(ids_j), ids_t[0].numpy()
    bad = np.nonzero((ids_j != ids_t).any(-1))[0]
    assert bad.size == 0, (f"router ids differ at tokens {bad.tolist()}: "
                           f"reference {ids_j[bad].tolist()}, port "
                           f"{ids_t[bad].tolist()}")
    want = jax.jit(JL.moe_mlp, static_argnums=2)(pj["moe"], xj, jc)
    got = L.moe_mlp(pt["moe"], xt, tc)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=0.02,
                               atol=0.02)


# ---------------------------------------------------------------------------
# recurrences alone, with their states
# ---------------------------------------------------------------------------

def test_rwkv_time_mix_and_channel_mix_with_state():
    jc, tc, pj, pt = _block("rwkv6-1.6b", lambda k: k == "rwkv")
    rng = np.random.default_rng(7)
    x1j, x1t = _bf16(rng.normal(0, 1, (2, 40, jc.d_model)))   # pads a chunk
    x2j, x2t = _bf16(rng.normal(0, 1, (2, 9, jc.d_model)))
    tm = jax.jit(JR.rwkv_time_mix, static_argnums=2)
    oj, sj = tm(pj, x1j, jc)
    ot, st = R.rwkv_time_mix(pt, x1t, tc)
    np.testing.assert_allclose(as_np(ot), as_np(oj), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(as_np(st[1]), as_np(sj[1]), rtol=0.02,
                               atol=0.02)
    # the carried state continues the sequence
    oj2, sj2 = tm(pj, x2j, jc, state=sj)
    ot2, st2 = R.rwkv_time_mix(pt, x2t, tc, state=st)
    np.testing.assert_allclose(as_np(ot2), as_np(oj2), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(as_np(st2[1]), as_np(sj2[1]), rtol=0.02,
                               atol=0.02)
    assert np.array_equal(as_np(st2[0]), as_np(sj2[0]))
    cj, pcj = jax.jit(JR.rwkv_channel_mix, static_argnums=2)(
        pj, x2j, jc, prev=sj[0])
    ct, pct = R.rwkv_channel_mix(pt, x2t, tc, prev=st[0])
    np.testing.assert_allclose(as_np(ct), as_np(cj), rtol=0.02, atol=0.02)
    assert np.array_equal(as_np(pct), as_np(pcj))
    # the population variance (ddof 0)
    y = rng.normal(0, 1, (2, 5, 2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        as_np(R._group_norm(torch.from_numpy(y), pt["ln_x_scale"], 1e-6)),
        as_np(JR._group_norm(jnp.asarray(y), pj["ln_x_scale"], 1e-6)),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t", [1, 37])
def test_rg_lru_with_state(t):
    jc, tc, pj, pt = _block("recurrentgemma-2b", lambda k: k == "rglru")
    rng = np.random.default_rng(8)
    x1j, x1t = _bf16(rng.normal(0, 1, (2, 21, jc.d_model)))
    x2j, x2t = _bf16(rng.normal(0, 1, (2, t, jc.d_model)))
    lru = jax.jit(JR.rg_lru, static_argnums=2)
    oj, sj = lru(pj, x1j, jc)
    ot, st = R.rg_lru(pt, x1t, tc)
    np.testing.assert_allclose(as_np(ot), as_np(oj), rtol=0.02, atol=0.02)
    assert np.array_equal(as_np(st[0]), as_np(sj[0]))   # the conv tail
    np.testing.assert_allclose(as_np(st[1]), as_np(sj[1]), rtol=0.02,
                               atol=0.02)
    oj2, sj2 = lru(pj, x2j, jc, state=sj)
    ot2, st2 = R.rg_lru(pt, x2t, tc, state=st)
    np.testing.assert_allclose(as_np(ot2), as_np(oj2), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(as_np(st2[1]), as_np(sj2[1]), rtol=0.02,
                               atol=0.02)


def test_linear_scan_matches_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t in float64."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 1.0, (3, 45, 7))
    b = rng.normal(0, 1, (3, 45, 7))
    aa, bb = R._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h = np.zeros((3, 7))
    prod = np.ones((3, 7))
    for i in range(45):
        h = a[:, i] * h + b[:, i]
        prod = prod * a[:, i]
        np.testing.assert_allclose(bb[:, i].numpy(), h, rtol=1e-12)
        np.testing.assert_allclose(aa[:, i].numpy(), prod, rtol=1e-12)


# ---------------------------------------------------------------------------
# decode over 4 positions, every reduced config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_step_matches_reference(arch):
    jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
    jp = jax_params(jc)
    tp = port_params(jp)
    tokens = jax_batch(jc, b=2, t=4, seed=3)["tokens"]
    enc_len = 8 if jc.enc_dec else 0
    cj = JD.init_cache(jc, 2, 8, enc_len=enc_len)
    ct = D.init_cache(tc, 2, 8, enc_len=enc_len, device="cpu")
    step = jax.jit(lambda p, c, tok, pos: JD.serve_step(p, jc, c, tok, pos))
    tt = port_batch({"tokens": tokens})["tokens"]
    for pos in range(4):
        lj, cj = step(jp, cj, tokens[:, pos:pos + 1], jnp.int32(pos))
        lt, ct = D.serve_step(tp, tc, ct, tt[:, pos:pos + 1], pos)
        want, got = as_np(lj), as_np(lt)
        assert rel_l2(want, got) <= 0.05, (arch, pos, rel_l2(want, got))
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 0.3
        assert np.array_equal(want.argmax(-1)[clear], got.argmax(-1)[clear])
    # the caches carry the same state
    for lj_c, lt_c in zip(jax.tree.leaves(cj), leaves(ct)):
        assert lj_c.shape == tuple(lt_c.shape)
        if lj_c.dtype == jnp.int32:
            assert np.array_equal(np.asarray(lj_c), lt_c.numpy())
        else:
            assert rel_l2(lj_c, lt_c) <= 0.05
