"""The LM substrate's training side on the PyTorch port, on the CPU:
tests/test_fault_tolerance.py's checkpoint-store, resume, data,
compression and AdamW tests and tests/test_durability.py's CheckpointStore
test on the port, test_extensions.py's serve test, and the port against
the JAX package: data batches and int8 compression word for word,
CheckpointStore files restored by the other package with equal values,
AdamW moments and parameters within stated bounds, the sliced AdamW update
equal to the whole-leaf one, and the entry points' refusal to run on a
missing GPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs.base import all_archs as jax_archs
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLMStream as JaxStream
from repro.training import adamw as jax_adamw
from repro.training import compression as jax_compression
from repro.training.train_step import init_state as jax_init_state
from repro_torch.checkpoint.store import CheckpointStore, config_fingerprint
from repro_torch.configs.base import all_archs
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.launch.serve import serve
from repro_torch.launch.train import run
from repro_torch.models.lm import init_params
from repro_torch.models.tree import flatten_with_path, leaves
from repro_torch.training import adamw, compression
from repro_torch.training.adamw import AdamWConfig, apply_updates, init_opt_state
from repro_torch.training.train_step import init_state

from _lm_parity import (as_np, jax_params, one_torch_thread,  # noqa: F401
                        port_params)

CPU = "cpu"


# ---------------------------------------------------------------------------
# checkpoint store (test_fault_tolerance.py, on the port)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, 1, (4, 8))).float(),
            "b": [torch.from_numpy(rng.integers(0, 9, (3,))),
                  {"c": torch.from_numpy(rng.normal(0, 1, (2, 2))).to(
                      torch.bfloat16)}]}


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3, fingerprint="fp")
    t = _tree()
    store.save(10, t)
    out = store.restore(10, t)
    for a, b in zip(leaves(t), leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_keep_n_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _tree())
    assert store.all_steps() == [3, 4]


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=5)
    store.save(1, _tree())
    # a crashed writer leaves a .tmp dir: restore must not see it
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert store.latest_step() == 1


def test_checkpoint_fingerprint_mismatch_refused(tmp_path):
    s1 = CheckpointStore(str(tmp_path), fingerprint="model-A")
    s1.save(5, _tree())
    s2 = CheckpointStore(str(tmp_path), fingerprint="model-B")
    with pytest.raises(ValueError, match="fingerprint"):
        s2.restore(5, _tree())


def test_checkpoint_structure_mismatch_refused(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        store.restore(1, {"a": torch.zeros(4, 8)})


def test_store_save_still_atomic_with_fsync(tmp_path):
    """test_durability.py's CheckpointStore test: numpy leaves."""
    store = CheckpointStore(str(tmp_path / "st"), keep=2)
    tree = {"w": np.arange(6.0).reshape(2, 3)}
    p = store.save(3, tree)
    assert os.path.isdir(p) and not p.endswith(".tmp")
    got = store.restore(3, {"w": np.zeros((2, 3))})
    np.testing.assert_array_equal(got["w"], tree["w"])


def test_resume_after_preemption(tmp_path):
    """Kill at step 7, resume from the step-5 checkpoint, final state equals
    an uninterrupted run (exactly-once step semantics via deterministic
    data + pure train step)."""
    d1 = str(tmp_path / "interrupted")
    kw = dict(steps=10, batch=2, seq=32, verbose=False, seed=1, device=CPU)
    out = run("granite-34b", ckpt_dir=d1, ckpt_every=5,
              simulate_preemption_at=7, **kw)
    assert out["preempted_at"] == 7
    out = run("granite-34b", ckpt_dir=d1, ckpt_every=5, **kw)
    assert out["resumed_from"] == 5
    ref = run("granite-34b", ckpt_dir=None, **kw)
    np.testing.assert_allclose(out["losses"][-1], ref["losses"][-1],
                               rtol=1e-4)
    assert ref["p50_ms"] > 0 and ref["p95_ms"] >= ref["p50_ms"]


def test_restore_onto_other_device_and_dtype(tmp_path):
    """Checkpoints hold full arrays: restore casts to the like tree's dtypes
    and puts each leaf on the like leaf's device."""
    store = CheckpointStore(str(tmp_path))
    cfg = all_archs()["granite-34b"].reduced
    params = init_params(cfg, 0, device=CPU)
    store.save(1, params)
    like = {k: v for k, v in params.items()}
    out = store.restore(1, like)
    for a, b in zip(leaves(params), leaves(out)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoint files cross the packages both ways
# ---------------------------------------------------------------------------

def test_checkpoint_files_cross_both_ways(tmp_path):
    arch = "rwkv6-1.6b"                  # bf16 and f32 leaves
    jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
    fp = config_fingerprint(tc)
    jp = jax_params(jc)
    tp = port_params(jp)
    jtree = {"params": jp, "state": jax_init_state(jp,
                                                    jax_adamw.AdamWConfig())}
    ttree = {"params": tp, "state": init_state(tp, AdamWConfig())}
    ttree["state"]["adam"]["step"] += 7
    ttree["state"]["adam"]["m"]["head"] += 0.25
    # the port writes, the reference reads into its own like-tree
    CheckpointStore(str(tmp_path / "p2j"), fingerprint=fp).save(7, ttree)
    got_j = JaxStore(str(tmp_path / "p2j"), fingerprint=fp).restore(7, jtree)
    # the reference writes, the port reads
    JaxStore(str(tmp_path / "j2p"), fingerprint=fp).save(7, got_j)
    got_t = CheckpointStore(str(tmp_path / "j2p"), fingerprint=fp).restore(
        7, {"params": init_params(tc, 1, device=CPU),
            "state": init_state(init_params(tc, 1, device=CPU),
                                AdamWConfig())})
    want = flatten_with_path(ttree)
    jflat = jax.tree_util.tree_flatten_with_path(got_j)[0]
    assert [p for p, _ in want] == [jax.tree_util.keystr(p)
                                    for p, _ in jflat]
    for (path, t), (_, j), (_, t2) in zip(want, jflat,
                                          flatten_with_path(got_t)):
        assert str(j.dtype) == str(t.dtype).removeprefix("torch."), path
        assert np.array_equal(as_np(j), as_np(t)), path
        assert t2.dtype == t.dtype and torch.equal(t2, t), path
    manifest = (tmp_path / "p2j" / "step_00000007" / "manifest.json")
    assert '"[\'state\'][\'adam\'][\'step\']"' in manifest.read_text()
    # a file of another config is refused in either package
    with pytest.raises(ValueError, match="fingerprint"):
        JaxStore(str(tmp_path / "p2j"), fingerprint="other").restore(7, jtree)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_across_restarts():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=4, seed=3)
    s1, s2 = SyntheticLMStream(cfg), SyntheticLMStream(cfg)
    for step in (0, 5, 1000):
        b1, b2 = s1.batch(step), s2.batch(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(s1.batch(1)["tokens"], s1.batch(2)["tokens"])


def test_data_has_learnable_signal():
    cfg = DataConfig(vocab_size=64, seq_len=64, global_batch=16, seed=0)
    s = SyntheticLMStream(cfg)
    toks = s.batch(0)["tokens"]
    hits = (s.next_of[toks[:, :-1]] == toks[:, 1:]).mean()
    assert hits > 0.5


@pytest.mark.parametrize("seed,vocab", [(0, 512), (7, 8192), (3, 49155)])
def test_data_batches_equal_reference(seed, vocab):
    mine = SyntheticLMStream(DataConfig(vocab, 33, 3, seed=seed))
    ref = JaxStream(JaxDataConfig(vocab, 33, 3, seed=seed))
    for step in (0, 1, 20, 12345):
        a, b = mine.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# gradient compression (error feedback)
# ---------------------------------------------------------------------------

def test_compression_roundtrip_small_error():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(0, 0.1, (64, 64))).float()}
    r = compression.init_residuals(g)
    dq, r2 = compression.compress_with_feedback(g, r)
    err = float((dq["w"] - g["w"]).abs().max())
    assert err <= float(g["w"].abs().max()) / 127 + 1e-6
    np.testing.assert_allclose(r2["w"].numpy(), (g["w"] - dq["w"]).numpy(),
                               atol=1e-7)


def test_compression_error_feedback_converges():
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.normal(0, 1, (32,))).float()
    for compressed in (False, True):
        w = {"w": torch.zeros(32)}
        r = compression.init_residuals(w)
        for _ in range(200):
            g = {"w": w["w"] - target}
            if compressed:
                g, r = compression.compress_with_feedback(g, r)
            w = {"w": w["w"] - 0.1 * g["w"]}
        err = float((w["w"] - target).abs().max())
        assert err < 1e-2, (compressed, err)


def test_compression_words_equal_reference():
    """quantize, dequantize and the residuals word for word, over several
    error-feedback steps, bf16 and f32 leaves, ties at .5 included."""
    rng = np.random.default_rng(2)
    g_np = {"a": rng.normal(0, 0.1, (64, 33)).astype(np.float32),
            "b": (np.arange(-254, 256, 2, dtype=np.float32) / 4)}
    gj = {"a": jnp.asarray(g_np["a"], jnp.bfloat16),
          "b": jnp.asarray(g_np["b"])}
    gt = {"a": torch.from_numpy(g_np["a"]).to(torch.bfloat16),
          "b": torch.from_numpy(g_np["b"])}
    q_j, s_j = jax_compression.quantize(gj["b"])
    q_t, s_t = compression.quantize(gt["b"])
    assert np.array_equal(np.asarray(q_j), q_t.numpy())
    assert float(s_j) == float(s_t)
    rj = jax_compression.init_residuals(gj)
    rt = compression.init_residuals(gt)
    for _ in range(3):
        dqj, rj = jax_compression.compress_with_feedback(gj, rj)
        dqt, rt = compression.compress_with_feedback(gt, rt)
        for k in ("a", "b"):
            assert np.array_equal(np.asarray(dqj[k]), dqt[k].numpy())
            assert np.array_equal(np.asarray(rj[k]), rt[k].numpy())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_bf16_moments_track_f32():
    rng = np.random.default_rng(2)
    p0 = {"w": torch.from_numpy(rng.normal(0, 0.1, (128,))).float()}
    target = torch.from_numpy(rng.normal(0, 1, (128,))).float()
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = AdamWConfig(lr=1e-2, moment_dtype=dt, weight_decay=0.0,
                          warmup_steps=1)
        p = dict(p0)
        st = init_opt_state(p, cfg)
        for _ in range(300):
            g = {"w": p["w"] - target}
            p, st = apply_updates(p, g, st, cfg)
        outs[dt] = p["w"].numpy()
    err = np.abs(outs[torch.float32] - outs[torch.bfloat16]).max()
    assert err < 0.1
    assert np.abs(outs[torch.bfloat16] - target.numpy()).max() < 0.1


def _adamw_case(seed):
    rng = np.random.default_rng(seed)
    p = {"stacked": rng.normal(0, 0.05, (5, 6, 7)).astype(np.float32),
         "ln": np.zeros(9, np.float32),
         "f32": rng.normal(0, 1, (11, 4)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(4)]
    return p, grads


def _port_adamw_run(p, grads, cfg):
    params = {k: torch.from_numpy(v).to(
        torch.float32 if k == "f32" else torch.bfloat16)
        for k, v in p.items()}
    st = init_opt_state(params, cfg)
    for g in grads:
        params, st = apply_updates(
            params, {k: torch.from_numpy(v) for k, v in g.items()}, st, cfg)
    return params, st


def test_adamw_sliced_update_equals_whole_leaf(monkeypatch):
    """Slices of a few rows (and of a part of a row) write the words of
    the whole-leaf update."""
    p, grads = _adamw_case(3)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    whole = _port_adamw_run(p, grads, cfg)
    for elements in (1, 7, 42, 100):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", elements)
        sliced = _port_adamw_run(p, grads, cfg)
        for a, b in zip(leaves(whole), leaves(sliced)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment):
    """Four steps on the same gradients. The arithmetic is the reference's,
    op for op, in f32: moments within rtol 1e-5 (the chunked-CE tolerance:
    XLA may contract a multiply-add); parameters within one ulp of their
    dtype plus 1e-5 of the step."""
    p, grads = _adamw_case(4)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                 moment_dtype=getattr(jnp, moment))
    tcfg = AdamWConfig(lr=1e-2, warmup_steps=2,
                       moment_dtype=getattr(torch, moment))
    jp = {k: jnp.asarray(v, jnp.float32 if k == "f32" else jnp.bfloat16)
          for k, v in p.items()}
    jst = jax_adamw.init_opt_state(jp, jcfg)
    for g in grads:
        jp, jst = jax_adamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
    tp, tst = _port_adamw_run(p, grads, tcfg)
    assert int(tst["step"]) == int(jst["step"]) == 4
    for k in p:
        for mom in ("m", "v"):
            np.testing.assert_allclose(as_np(tst[mom][k]),
                                       as_np(jst[mom][k]), rtol=1e-5,
                                       atol=1e-7)
        eps = 2.0 ** -23 if k == "f32" else 2.0 ** -7
        want = as_np(jp[k]).astype(np.float64)
        assert (np.abs(as_np(tp[k]) - want)
                <= eps * np.abs(want) + 1e-5 * 1e-2).all(), k


# ---------------------------------------------------------------------------
# serve() (test_extensions.py) and the entry points' device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-34b", "rwkv6-1.6b",
                                  "deepseek-v2-236b"])
def test_serve_launcher(arch):
    out = serve(arch, reduced=True, batch=2, prompt_len=8, gen=6,
                verbose=False, device=CPU)
    assert out["finite"]
    assert out["tokens"].shape == (2, 6)
    out2 = serve(arch, reduced=True, batch=2, prompt_len=8, gen=6,
                 verbose=False, device=CPU)
    np.testing.assert_array_equal(out["tokens"], out2["tokens"])


def test_train_compress_runs():
    out = run("granite-moe-3b-a800m", steps=3, batch=2, seq=16,
              compress=True, verbose=False, device=CPU)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


def test_microbatches_match_one_batch():
    """microbatches=2 accumulates the same gradient as the whole batch (the
    loss is a mean over equal halves), f32 accumulation."""
    from repro_torch.training.train_step import make_train_step
    cfg = all_archs()["granite-34b"].reduced
    params = init_params(cfg, 0, device=CPU)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
             for k in ("tokens", "labels")}
    opt = AdamWConfig()
    _, st1, m1 = make_train_step(cfg, opt)(params, init_state(params, opt),
                                           batch)
    _, st2, m2 = make_train_step(cfg, opt, microbatches=2)(
        params, init_state(params, opt), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=0.02)
