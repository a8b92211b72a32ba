"""The port's checkpointed, resumable fits against the JAX package's: a torch
fit killed at any published cut and resumed (backend="torch", CPU) ends
with the uninterrupted JAX fit's shares, iterations, dealer counters and
CommLog per tag and phase, on demand, pooled and streamed, both
partitions, dense and sparse; minibatch at batch and iteration
boundaries, pipeline on and off; bank-fed fits; the same fingerprint in
both packages; checkpoints that cross packages; and the checkpointer's
own rules (torn and temporary steps, `step_at_or_before`, keep-N, the
fingerprint refused). The contracts are those of the reference's
tests/test_checkpoint_resume.py and tests/test_durability.py."""
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from repro.checkpoint.fit import FitCheckpointer as JFitCheckpointer
from repro.core import kmeans as JK
from repro.core import triples as JT
from repro_torch.checkpoint.fit import (FingerprintMismatch, FitCheckpointer,
                                        FitState)
from repro_torch.checkpoint.store import (config_fingerprint, fsync_path,
                                          fsync_tree)
from repro_torch.core import triples as T
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans


def _blobs(n, d, k, seed, sparse_frac=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.normal(0, 0.3, (n, d))
    if sparse_frac:
        x = x * (rng.random((n, d)) >= sparse_frac)
    return x


def _split(x, partition):
    n, d = x.shape
    if partition == "vertical":
        return x[:, :d // 2], x[:, d // 2:]
    return x[:n // 2], x[n // 2:]


def _data(partition="vertical", sparse=False):
    return _split(_blobs(48, 4, 2, seed=11, sparse_frac=0.5 if sparse
                         else 0.0), partition)


def _common(**kw):
    return dict(dict(k=2, iters=3, seed=5), **kw)


def _port(**kw):
    return SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                     **_common(**kw)))


def _jax(**kw):
    return JK.SecureKMeans(JK.KMeansConfig(backend="xla", **_common(**kw)))


@functools.lru_cache(maxsize=None)
def _reference(partition="vertical", sparse=False, **kw):
    """The uninterrupted JAX fit of `_data(partition, sparse)`."""
    return _jax(partition=partition, sparse=sparse, **kw).fit(
        *_data(partition, sparse))


def _words(share) -> tuple:
    if isinstance(share[0], torch.Tensor):
        return shares_to_numpy(share)
    return tuple(np.asarray(s, np.uint64) for s in share)


def _assert_same_fit(got, want) -> None:
    """Shares, iterations, dealer counters, CommLog per tag and phase."""
    for field in ("centroids", "assignment"):
        for g, w in zip(_words(getattr(got, field)),
                        _words(getattr(want, field))):
            np.testing.assert_array_equal(g, w)
    assert got.iters_run == want.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(got.dealer, attr) == getattr(want.dealer, attr), attr
    for phase in ("online", "offline"):
        assert got.log.by_tag(phase) == want.log.by_tag(phase), phase


def _resume_from(step: int, src_dir, tmp_path, km, a, b, dealer=None,
                 checkpointer=FitCheckpointer):
    """Copy ONE published step into a fresh directory and resume from it
    (no further saves)."""
    d2 = tmp_path / f"resume_{step}_{checkpointer.__module__}"
    d2.mkdir()
    name = f"step_{step:010d}"
    shutil.copytree(os.path.join(src_dir, name), str(d2 / name))
    return km.fit(a, b, checkpoint=checkpointer(str(d2), every=10**9),
                  resume=True, dealer=dealer)


def _check_all_steps(tmp_path, want, *, partition="vertical", sparse=False,
                     batch_every=None, dealer_factory=None, **kw):
    """A checkpointed torch fit equals `want`; so does a resume from each
    step it published. Returns the steps."""
    a, b = _data(partition, sparse)
    km = _port(partition=partition, sparse=sparse, **kw)

    def dealer():
        return dealer_factory() if dealer_factory else None

    d = str(tmp_path / "ck")
    ck = FitCheckpointer(d, every=1, batch_every=batch_every, keep=0)
    _assert_same_fit(km.fit(a, b, checkpoint=ck, dealer=dealer()), want)
    steps = ck.all_steps()
    assert steps, "no checkpoints were published"
    for s in steps:
        _assert_same_fit(_resume_from(s, d, tmp_path, km, a, b,
                                      dealer=dealer()), want)
    return steps


# ---------------------------------------------------------------------------
# full batch: every offline mode, both partitions, dense and sparse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offline", ["on_demand", "pooled", "streamed"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_fullbatch_resume_equals_reference(tmp_path, partition, sparse,
                                           offline):
    """Resumed from each iteration boundary, the torch fit ends with the
    uninterrupted JAX fit's words (the JAX pooled and streamed fits equal
    its on-demand fit, shares, counters and CommLog both phases)."""
    want = _reference(partition, sparse)
    steps = _check_all_steps(tmp_path, want, partition=partition,
                             sparse=sparse, offline=offline)
    assert steps == [1_000_000, 2_000_000]     # boundaries only, never last


def test_resumed_he_seconds_equal_reference_resume(tmp_path):
    """A checkpoint holds no he_seconds in either package: the resumed
    sparse fit counts the exchanges it ran, bit for bit the JAX package's
    resumed fit."""
    a, b = _data("vertical", True)
    d = str(tmp_path / "ck")
    _port(sparse=True, offline="pooled").fit(
        a, b, checkpoint=FitCheckpointer(d, every=1, keep=0))
    rt = _resume_from(1_000_000, d, tmp_path,
                      _port(sparse=True, offline="pooled"), a, b)
    rj = _resume_from(1_000_000, d, tmp_path,
                      _jax(sparse=True, offline="pooled"), a, b,
                      checkpointer=JFitCheckpointer)
    assert rt.he_seconds == rj.he_seconds > 0.0
    _assert_same_fit(rt, rj)


# ---------------------------------------------------------------------------
# minibatch: mid-iteration (sequential) and iteration boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_minibatch_batch_boundary_resume(tmp_path, partition):
    """Sequential executor, a checkpoint after every batch: resumed from a
    cut in the middle of an iteration (partial sums and completed batches'
    assignment shares restored)."""
    kw = dict(offline="streamed", batch_size=16, pipeline=False)
    want = _reference(partition, **kw)
    steps = _check_all_steps(tmp_path, want, partition=partition,
                             batch_every=1, **kw)
    assert any(s % 1_000_000 for s in steps), "no mid-iteration cuts"


@pytest.mark.parametrize("pipeline", [False, True], ids=["seq", "pipe"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_minibatch_iteration_boundary_resume(tmp_path, sparse, pipeline):
    kw = dict(offline="pooled", batch_size=16, pipeline=pipeline)
    want = _reference("vertical", sparse, **kw)
    steps = _check_all_steps(tmp_path, want, sparse=sparse, **kw)
    assert steps == [1_000_000, 2_000_000]


def test_batch_checkpoint_on_pipelined_executor_rejected(tmp_path):
    """Mid-iteration cuts are canonical only on the sequential executor:
    the reference's ValueError."""
    a, b = _data()
    ck = FitCheckpointer(str(tmp_path / "ck"), every=1, batch_every=1)
    km = _port(offline="streamed", batch_size=16, pipeline=True)
    with pytest.raises(ValueError, match="pipeline"):
        km.fit(a, b, checkpoint=ck)


# ---------------------------------------------------------------------------
# bank-fed fits: the bank's queues realigned on resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [None, 16], ids=["full", "minibatch"])
def test_bank_fed_resume(tmp_path, batch_size):
    """A fit from a freshly provisioned bank, resumed from each cut, ends
    with the JAX package's bank-fed fit's words (the bank's queues skip
    what the interrupted run consumed: `BankDealer.skip`, or
    `BankSlotDealer(start_slot=)`)."""
    kw = dict(offline="streamed", batch_size=batch_size) if batch_size \
        else {}
    a, b = _data()
    key, plan, _ = _port(**kw).plan_fit(a.shape, b.shape)
    jkm = _jax(**kw)
    jkey, jplan, _ = jkm.plan_fit(a.shape, b.shape)
    jbank = JT.TripleBank(seed=5)
    jbank.provision(jkey, jplan, copies=1)
    want = jkm.fit(a, b, dealer=jbank.dealer(jkey))

    def dealer_factory():
        bank = T.TripleBank(seed=5, device="cpu")
        bank.provision(key, plan, copies=1)
        return bank.dealer(key)

    _check_all_steps(tmp_path, want, dealer_factory=dealer_factory, **kw)


@pytest.mark.parametrize("start_slot", [0, 1, 3, 6])
def test_bank_slot_dealer_start_slot_equals_reference(start_slot):
    """`BankSlotDealer(start_slot=)` drops the consumed slots' entries and
    serves the rest word for word as the JAX package's does."""
    rng = np.random.default_rng(4)
    slots = [[("matmul", ((3, 2), (2, 4))), ("mul", (5,)), ("bin", (2, 3))]
             [:1 + int(rng.integers(3))] for _ in range(6)]
    tplans = [T.TriplePlan([T.PlanRequest(k, s, "t") for k, s in sl])
              for sl in slots]
    jplans = [JT.TriplePlan([JT.PlanRequest(k, s, "t") for k, s in sl])
              for sl in slots]
    key = ("slots",)
    tbank = T.TripleBank(seed=3, device="cpu")
    tbank.provision(key, T.TriplePlan([r for p in tplans
                                       for r in p.requests]))
    jbank = JT.TripleBank(seed=3)
    jbank.provision(key, JT.TriplePlan([r for p in jplans
                                        for r in p.requests]))
    td = T.BankSlotDealer(tbank, key, tplans, start_slot=start_slot)
    jd = JT.BankSlotDealer(jbank, key, jplans, start_slot=start_slot)
    for i in range(start_slot, len(slots)):
        tv, jv = td.acquire(i), jd.acquire(i)
        for kind, shape in slots[i]:
            if kind == "matmul":
                got, want = tv.matmul_triple(*shape), jv.matmul_triple(*shape)
                pairs = [(got.u, want.u), (got.v, want.v), (got.z, want.z)]
            elif kind == "mul":
                got, want = tv.mul_triple(shape), jv.mul_triple(shape)
                pairs = [(got.u, want.u), (got.v, want.v), (got.z, want.z)]
            else:
                got, want = tv.bin_triple(shape), jv.bin_triple(shape)
                pairs = [(got.u, want.u), (got.v, want.v), (got.z, want.z)]
            for g, w in pairs:
                for gi, wi in zip(_words(g), _words(w)):
                    np.testing.assert_array_equal(gi, wi)
    assert td.remaining() == jd.remaining()
    assert tbank.consumed_counts() == jbank.consumed_counts()
    with pytest.raises(IndexError):
        T.BankSlotDealer(tbank, key, tplans, start_slot=len(slots) + 1)


# ---------------------------------------------------------------------------
# across packages: one fingerprint, one file format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(partition="horizontal", sparse=True),
    dict(offline="streamed", batch_size=16, pipeline=False),
    dict(offline="pooled", tol=1e-3, iters=5)],
    ids=["dense", "sparse_h", "minibatch", "tol"])
def test_fingerprint_equals_reference(kw):
    sparse = kw.get("sparse", False)
    a, b = _data(kw.get("partition", "vertical"), sparse)
    got = _port(**kw)._fit_fingerprint(a.shape, b.shape)
    assert got == _jax(**kw)._fit_fingerprint(a.shape, b.shape)
    assert len(got) == 16 and got == config_fingerprint(
        _port(**kw)._fit_plan_key(a.shape, b.shape)
        + ("fit-ckpt", 5, kw.get("offline", "on_demand"), "random_data",
           kw.get("tol")))
    # pipeline is not part of a fit's identity; the seed is
    assert _port(**dict(kw, pipeline=False))._fit_fingerprint(
        a.shape, b.shape) == got
    assert _port(**dict(kw, seed=6))._fit_fingerprint(a.shape, b.shape) \
        != got


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kw", [
    dict(offline="pooled"),
    dict(offline="streamed", batch_size=16, pipeline=False)],
    ids=["pooled", "minibatch"])
def test_checkpoint_crosses_packages(tmp_path, writer, kw):
    """A checkpoint the JAX package wrote resumes in the port, and one the
    port wrote resumes in the JAX package; both end with the uninterrupted
    JAX fit's words. The files are the same: npz of uint64 words and the
    JSON manifest."""
    a, b = _data()
    batch_every = 1 if kw.get("batch_size") else None
    d = str(tmp_path / "ck")
    if writer == "jax":
        _jax(**kw).fit(a, b, checkpoint=JFitCheckpointer(
            d, every=1, batch_every=batch_every, keep=0))
        ck = FitCheckpointer(d)
    else:
        _port(**kw).fit(a, b, checkpoint=FitCheckpointer(
            d, every=1, batch_every=batch_every, keep=0))
        ck = JFitCheckpointer(d)
    steps = ck.all_steps()
    assert len(steps) >= 2
    st = ck.load(steps[-1])
    assert st.mu0.dtype == np.uint64 and st.fingerprint
    reader_km, reader_ck = (_port(**kw), FitCheckpointer) \
        if writer == "jax" else (_jax(**kw), JFitCheckpointer)
    want = _reference(**kw)
    for s in (steps[0], steps[-1]):
        _assert_same_fit(_resume_from(s, d, tmp_path, reader_km, a, b,
                                      checkpointer=reader_ck), want)


def test_words_at_and_above_two_to_the_63_cross_unchanged(tmp_path):
    """uint64 words >= 2^63 (negative int64 words on the device) reach the
    file and come back as the same 64 bits."""
    words = np.array([[0, 1, 2**63, 2**64 - 1]], np.uint64)
    ck = FitCheckpointer(str(tmp_path / "ck"))
    ck.save(FitState(iteration=1, batch=0, mu0=words, mu1=words[:, ::-1],
                     counters={"n_matmul": 1, "n_mul": 2, "n_bin": 3},
                     comm={"bytes": [["online", "S1", 8]],
                           "rounds": [["online", "S1", 1]]},
                     advance={("mul", (5,)): 7}))
    for reader in (FitCheckpointer, JFitCheckpointer):
        st = reader(str(tmp_path / "ck")).latest()
        np.testing.assert_array_equal(st.mu0, words)
        np.testing.assert_array_equal(st.mu1, words[:, ::-1])
        assert st.advance == {("mul", (5,)): 7}
    from repro_torch.core.kmeans import _upload_u64
    back = _upload_u64(st.mu0, "cpu")
    assert back.dtype == torch.int64
    np.testing.assert_array_equal(back.numpy().view(np.uint64), words)


# ---------------------------------------------------------------------------
# the checkpointer's rules
# ---------------------------------------------------------------------------

def _fit_with_checkpoints(tmp_path):
    a, b = _data()
    km = _port()
    d = str(tmp_path / "ck")
    ck = FitCheckpointer(d, every=1, keep=0)
    return km, a, b, d, ck, km.fit(a, b, checkpoint=ck)


def _state(it):
    return FitState(iteration=it, batch=0,
                    mu0=np.zeros((2, 4), np.uint64),
                    mu1=np.zeros((2, 4), np.uint64),
                    counters={"n_matmul": 0, "n_mul": 0, "n_bin": 0},
                    comm={"bytes": [], "rounds": []}, advance={})


def test_tmp_dirs_skipped_and_keep_n(tmp_path):
    d = str(tmp_path / "ck")
    ck = FitCheckpointer(d, every=1, keep=2)
    for it in (1, 2, 3, 4):
        ck.save(_state(it))
    # a torn writer's tmp dir is invisible to discovery, and recycled
    tmp = os.path.join(d, "step_0005000000.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        f.write("{half-written")
    assert ck.all_steps() == [3_000_000, 4_000_000]   # keep=2 pruned 1, 2
    assert ck.latest().iteration == 4
    ck.save(_state(5))
    assert not os.path.exists(tmp)
    assert ck.all_steps() == [4_000_000, 5_000_000]


@pytest.mark.parametrize("torn", ["state.npz", "manifest.json"])
def test_torn_newest_step_falls_back_and_resumes(tmp_path, torn):
    """A published step whose file is torn is skipped with a warning; the
    fit resumed from the previous step ends equal to the clean fit."""
    km, a, b, d, ck, ref = _fit_with_checkpoints(tmp_path)
    steps = ck.all_steps()
    with open(os.path.join(d, f"step_{steps[-1]:010d}", torn), "wb") as f:
        f.write(b"{\x00half")
    with pytest.warns(UserWarning, match="unreadable"):
        assert ck.latest().step == steps[-2]
    with pytest.warns(UserWarning):
        res = km.fit(a, b, checkpoint=FitCheckpointer(d), resume=True)
    _assert_same_fit(res, ref)
    for s in steps:
        with open(os.path.join(d, f"step_{s:010d}", "state.npz"),
                  "wb") as f:
            f.write(b"junk")
    with pytest.warns(UserWarning):
        assert ck.latest() is None


def test_step_at_or_before_and_resume_step(tmp_path):
    km, a, b, d, ck, ref = _fit_with_checkpoints(tmp_path)
    steps = ck.all_steps()                   # [1_000_000, 2_000_000]
    assert ck.step_at_or_before(steps[-1]) == steps[-1]
    assert ck.step_at_or_before(steps[-1] + 5) == steps[-1]
    assert ck.step_at_or_before(steps[0] + 1) == steps[0]
    assert ck.step_at_or_before(steps[0] - 1) is None
    assert ck.step_at_or_before(-1) is None
    # the negotiated step: rewind to an older published step, or start
    # fresh when none is at or before it; all end equal
    for agreed in (steps[0], steps[0] + 1, -1):
        res = km.fit(a, b, checkpoint=FitCheckpointer(d),
                     resume_step=agreed)
        _assert_same_fit(res, ref)


def test_fingerprint_mismatch_refused(tmp_path):
    km, a, b, d, ck, _ = _fit_with_checkpoints(tmp_path)
    with pytest.raises(FingerprintMismatch, match="fingerprint"):
        FitCheckpointer(d, fingerprint="some-other-config").latest()
    with pytest.raises(ValueError, match="fingerprint"):
        _port(seed=6).fit(a, b, checkpoint=FitCheckpointer(d), resume=True)


def test_resume_guard_rails(tmp_path):
    a, b = _data()
    with pytest.raises(ValueError, match="resume"):
        _port().fit(a, b, resume=True)
    # a fit that finished publishes nothing after its last iteration, so a
    # checkpoint at the last iteration is someone else's
    d = str(tmp_path / "ck")
    km = _port(iters=2)
    fp = km._fit_fingerprint(a.shape, b.shape)
    FitCheckpointer(d, fingerprint=fp).save(_state(2))
    with pytest.raises(ValueError, match="nothing left"):
        km.fit(a, b, checkpoint=FitCheckpointer(d), resume=True)
    # a mid-iteration cut resumes only a minibatch fit
    d2 = str(tmp_path / "ck2")
    st = _state(0)
    st.batch = 1
    FitCheckpointer(d2, fingerprint=fp).save(st)
    with pytest.raises(ValueError, match="minibatch"):
        km.fit(a, b, checkpoint=FitCheckpointer(d2), resume=True)


def test_fsync_helpers(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "f.txt").write_text("hi")
    fsync_tree(str(tmp_path))
    fsync_path(str(tmp_path / "a" / "b" / "f.txt"))
    fsync_path(str(tmp_path / "missing"))    # best effort, no raise
