"""Minibatch Lloyd and the pipelined executor of the port against the JAX
package's (backend="xla"), word for word: the minibatch fit's shares,
iterations, dealer counters, per-tag online and offline traffic, modelled
he_seconds and pool bytes; the SlotDealer's served words for any
acquisition order; the executor's phase order; the batch layout helpers.
The contracts are those of the reference's tests/test_pipeline.py."""
import numpy as np
import pytest
import torch

from repro.core import kmeans as JK
from repro.core import triples as JT
from repro.launch import pipeline as JPL
from repro.core.sharing import AShare as JAShare
from repro_torch.core import kmeans as KM
from repro_torch.core import ring
from repro_torch.core import triples as T
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.core.sharing import AShare
from repro_torch.launch import kmeans_step as KS
from repro_torch.launch.pipeline import PipelineError, StageTask, run_pipeline


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


def _port(**common):
    return SecureKMeans(KMeansConfig(backend="torch", device="cpu", **common))


def _same_words(rt, r2) -> None:
    """Two port fits agree in shares, iterations, counters and traffic."""
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(rt, field)[i], getattr(r2, field)[i])
    assert rt.iters_run == r2.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(r2.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == r2.log.by_tag(phase), phase


def _assert_equals_reference(rj, rt) -> None:
    for field in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(rt, field))
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(getattr(rj, field)[i], np.uint64))
    assert rt.iters_run == rj.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(rj.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == rj.log.by_tag(phase), phase
    assert rt.he_seconds == rj.he_seconds
    assert rt.dealer.pool_bytes == rj.dealer.pool_bytes
    assert rt.offline_modelled_ot_seconds == rj.offline_modelled_ot_seconds
    assert rt.dealer.remaining() == rj.dealer.remaining()


def _fit_pair(partition, sparse, n=48, d=4, k=2, iters=2, seed=9, **extra):
    x = _blobs(n, d, k, seed=seed, sparse_frac=0.5 if sparse else 0.0)
    a, b = _split(x, partition)
    common = dict(k=k, iters=iters, partition=partition, sparse=sparse,
                  seed=5, **extra)
    rj = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common)).fit(a, b)
    return rj, _port(**common).fit(a, b)


# ---------------------------------------------------------------------------
# the minibatch fit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [16, 17], ids=["divides", "remainder"])
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "seq"])
@pytest.mark.parametrize("offline", ["pooled", "streamed"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_minibatch_fit_equals_reference(partition, sparse, offline, pipeline,
                                        batch_size):
    """Shares, iterations, dealer counters, per-tag traffic, he_seconds
    bit for bit and pool bytes equal the reference's minibatch fit, for a
    batch size that divides n and one that leaves a remainder."""
    rj, rt = _fit_pair(partition, sparse, offline=offline, pipeline=pipeline,
                       batch_size=batch_size)
    _assert_equals_reference(rj, rt)
    assert rt.loop_seconds == rt.online_seconds
    assert rt.offline_dealer_seconds >= rt.offline_plan_seconds > 0.0


def test_minibatch_sparse_k10_he_seconds_equal_reference():
    """At k=10 the order in which the exchanges' float HE times are summed
    shows in the last bit: each batch stage's time is summed on its own ctx
    and added to the fit's in stage order (pipelined: batch t+1's exchange
    #1 before batch t's #2), as the reference adds it."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.3, (280, 64)) + rng.integers(0, 3, (280, 1))
    x *= rng.random(x.shape) >= 0.9
    common = dict(k=10, iters=2, seed=3, sparse=True, offline="pooled",
                  batch_size=70, pipeline=True)
    rj = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common)).fit(
        x[:, :32], x[:, 32:])
    rt = _port(**common).fit(x[:, :32], x[:, 32:])
    _assert_equals_reference(rj, rt)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_minibatch_at_n_equals_full_batch_pooled(partition, sparse):
    """batch_size >= n (one batch) replays the port's full-batch pooled fit
    word for word, its offline traffic included — in either order of the
    two fits, with the plan cache warm: the batch geometry equals the
    full-batch one, and neither hands back the other's plan."""
    n = 48
    x = _blobs(n, 4, 2, seed=11, sparse_frac=0.5 if sparse else 0.0)
    a, b = _split(x, partition)
    base = dict(k=2, iters=2, partition=partition, sparse=sparse, seed=5,
                offline="pooled")
    KM.clear_plan_cache()
    r_full = _port(**base).fit(a, b)
    r_mb = _port(**base, batch_size=n).fit(a, b)
    r_big = _port(**base, batch_size=10 * n).fit(a, b)
    KM.clear_plan_cache()
    r_mb_cold = _port(**base, batch_size=n).fit(a, b)
    r_full_warm = _port(**base).fit(a, b)
    for r in (r_mb, r_big, r_mb_cold, r_full_warm):
        _same_words(r_full, r)
        assert r.he_seconds == r_full.he_seconds


def test_minibatch_pipeline_does_not_change_a_word():
    """pipeline=True and False, pooled and streamed: identical shares,
    counters and traffic (he_seconds may differ in the last bit: the
    exchanges' times are added in another order), and the split agrees
    with the full-batch fit on the labels."""
    x = _blobs(48, 4, 2, seed=9)
    a, b = x[:, :2], x[:, 2:]
    base = dict(k=2, iters=2, seed=5, batch_size=17)
    ref = _port(**base, offline="pooled", pipeline=False).fit(a, b)
    for pipe in (True, False):
        for off in ("pooled", "streamed"):
            r = _port(**base, offline=off, pipeline=pipe).fit(a, b)
            _same_words(ref, r)
    full = _port(k=2, iters=2, seed=5, offline="pooled").fit(a, b)
    assert ref.labels_plain().tolist() == full.labels_plain().tolist()
    np.testing.assert_allclose(ref.centroids_plain(), full.centroids_plain(),
                               atol=1e-3)


def test_minibatch_tol_early_stop_closes_the_worker():
    """A tol early stop leaves surplus in the streamed SlotDealer, never an
    error, and the fit's `finally` has stopped the worker; the result
    equals the reference's."""
    rj, rt = _fit_pair("vertical", False, n=120, d=4, k=3, iters=40, seed=4,
                       tol=1e-6, offline="streamed", batch_size=40)
    assert rt.iters_run < 40
    _assert_equals_reference(rj, rt)
    assert any(v > 0 for v in rt.dealer.remaining().values())
    assert rt.dealer._worker is None and rt.dealer._closed
    rt.dealer.close()                       # idempotent


def test_minibatch_geometry_reuse():
    """A many-batch fit records ONE program pair per distinct batch
    geometry (full + remainder) plus one finalize — never one per batch —
    and clear_program_cache empties all three caches."""
    KS.clear_program_cache()
    x = _blobs(80, 4, 2, seed=3)
    _port(k=2, iters=2, seed=5, offline="pooled", batch_size=16).fit(
        x[:, :2], x[:, 2:])                   # 5 equal batches
    assert len(KS._BATCH_PROGRAM_CACHE) == 1
    assert len(KS._FINALIZE_CACHE) == 1
    _port(k=2, iters=2, seed=5, offline="pooled", batch_size=32).fit(
        x[:, :2], x[:, 2:])                   # 32, 32, 16
    assert len(KS._BATCH_PROGRAM_CACHE) == 2   # the 16-row one is reused
    assert len(KS._FINALIZE_CACHE) == 1        # keyed by (k, d, n)
    KS.fit_programs("vertical", False, (16, 2), (16, 2), 2, backend="torch",
                    device="cpu")
    KS.clear_program_cache()
    assert not (KS._PROGRAM_CACHE or KS._BATCH_PROGRAM_CACHE
                or KS._FINALIZE_CACHE)


def test_minibatch_requires_planned_offline_and_the_fast_path():
    x = _blobs(24, 4, 2, seed=1)
    for cfg in (dict(), dict(offline="on_demand")):
        with pytest.raises(ValueError, match="pooled"):
            _port(k=2, iters=1, batch_size=8, **cfg).fit(x[:, :2], x[:, 2:])
        with pytest.raises(ValueError, match="pooled"):
            JK.SecureKMeans(JK.KMeansConfig(k=2, iters=1, batch_size=8,
                                            backend="xla", **cfg)) \
                .fit(x[:, :2], x[:, 2:])
    for cfg in (dict(vectorized=False), dict(f=16)):
        with pytest.raises(ValueError, match="fast path"):
            _port(k=2, iters=1, batch_size=8, offline="pooled", **cfg) \
                .fit(x[:, :2], x[:, 2:])


def test_minibatch_batch_programs_equal_reference():
    """The batch and finalize programs consume the reference's schedules,
    request for request (at the batch geometries of the fits above, which
    the reference has built already)."""
    from repro.launch import kmeans_step as JKS
    for part, sa, sb in (("vertical", (16, 2), (16, 2)),
                         ("horizontal", (8, 4), (8, 4))):
        for sparse in (False, True):
            progs = KS.fit_batch_programs(part, sparse, sa, sb, 2,
                                          backend="torch", device="cpu")
            jprogs = JKS.fit_batch_programs(part, sparse, sa, sb, 2,
                                            backend="xla")
            assert progs.s1_requests == jprogs.s1_requests
            assert progs.s3p_requests == jprogs.s3p_requests
    fin = KS.finalize_program(2, 4, 48, backend="torch", device="cpu")
    assert fin.requests == JKS.finalize_program(2, 4, 48,
                                                backend="xla").requests


# ---------------------------------------------------------------------------
# batch layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition,na,nb,bs", [
    ("vertical", 10, 10, 4), ("vertical", 10, 10, 100),
    ("vertical", 10, 10, 1), ("horizontal", 9, 7, 4),
    ("horizontal", 10, 10, 4), ("horizontal", 5, 29, 8),
    ("horizontal", 3, 3, 100)])
def test_minibatch_bounds_equal_reference(partition, na, nb, bs):
    bounds = KM._minibatch_bounds(partition, na, nb, bs)
    assert bounds == JK._minibatch_bounds(partition, na, nb, bs)
    for side, total in ((0, na), (1, nb)):
        spans = [b[side] for b in bounds]
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(h0 == l1 for (_, h0), (l1, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_assemble_assignment_equals_reference(partition):
    """[all A rows; all B rows] (horizontal) or batch order (vertical) from
    per-batch outputs, as the reference stitches them."""
    rng = np.random.default_rng(2)
    rows = [(3, 2), (2, 2), (4, 1)]
    words = [[rng.integers(0, 1 << 64, (ra + rb, 2), dtype=np.uint64)
              for _ in range(2)] for ra, rb in rows]
    batches = [{"a_rows": ra} for ra, _ in rows]
    got = KM._assemble_assignment(
        partition, [AShare(*(ring.from_u64_numpy(w) for w in p))
                    for p in words], batches)
    import jax.numpy as jnp
    want = JK._assemble_assignment(
        partition, [JAShare(*(jnp.asarray(w) for w in p)) for p in words],
        batches)
    for i in (0, 1):
        np.testing.assert_array_equal(ring.to_u64_numpy(got[i]),
                                      np.asarray(want[i], np.uint64))


# ---------------------------------------------------------------------------
# SlotDealer
# ---------------------------------------------------------------------------

_SHAPES = {"matmul": ((5, 3), (3, 2)), "mul": (4, 3), "bin": (2, 7),
           "rand": (6,), "seed": ()}


def _slot_plans(mod, seed, n_slots=6, per_slot=3):
    rng = np.random.default_rng(seed)
    kinds = list(_SHAPES)
    return [mod.TriplePlan([mod.PlanRequest(k, _SHAPES[k], "t")
                            for k in rng.choice(kinds, per_slot)])
            for _ in range(n_slots)]


def _serve(view, plan) -> list:
    out = []
    for r in plan.requests:
        if r.kind == "matmul":
            t = view.matmul_triple(*r.shape)
            out += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
        elif r.kind == "mul":
            t = view.mul_triple(r.shape)
            out += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
        elif r.kind == "bin":
            t = view.bin_triple(r.shape)
            out += [t.u.b0, t.u.b1, t.v.b0, t.v.b1, t.z.b0, t.z.b1]
        elif r.kind == "rand":
            out.append(view.rand(r.shape))
        else:
            out.append(np.uint64(view.mask_seed()))
    return [ring.to_u64_numpy(a) if isinstance(a, torch.Tensor)
            else np.asarray(a, np.uint64) for a in out]


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("start_slot", [0, 2])
@pytest.mark.parametrize("group_bytes", [0, "auto"])
@pytest.mark.parametrize("stream", [False, True], ids=["pooled", "streamed"])
def test_slot_dealer_equals_reference_any_order(monkeypatch, stream,
                                                group_bytes, start_slot):
    """Acquiring slots out of order (the pipelined lead) serves the
    reference SlotDealer's words, counters, offline tallies and pool bytes,
    and PooledDealer's words over the concatenated plan, with slots
    generated one at a time or merged into groups of GROUP_TRANCHE_BYTES;
    start_slot skips the slots an earlier run consumed."""
    plans, jplans = _slot_plans(T, 8), _slot_plans(JT, 8)
    concat = T.TriplePlan([r for p in plans for r in p.requests])
    pooled = T.PooledDealer(concat, seed=13)
    want = [_serve(pooled, p) for p in plans]
    if group_bytes == 0:
        monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", 0)
    kw = dict(seed=13, stream=stream, start_slot=start_slot)
    dealer = T.SlotDealer(plans, **kw)
    jdealer = JT.SlotDealer(jplans, group_bytes=group_bytes, **kw)
    order = [s for s in [0, 2, 1, 4, 3, 5] if s >= start_slot]
    for i in order:
        got = _serve(dealer.acquire(i), plans[i])
        _same(got, want[i])
        _same(got, _serve(jdealer.acquire(i), jplans[i]))
    for attr in ("n_matmul", "n_mul", "n_bin", "modelled_ot_seconds"):
        assert getattr(dealer, attr) == getattr(jdealer, attr), attr
    if stream:
        # the worker's peak depends on how it races the consumer
        slot_max = max(8 * p.pool_words() for p in plans)
        assert 0 < dealer.pool_bytes <= (4 + len(plans)) * slot_max
    else:
        assert dealer.pool_bytes == jdealer.pool_bytes
    assert dealer.log.by_tag("offline") == jdealer.log.by_tag("offline")
    assert dealer.remaining() == jdealer.remaining()
    assert all(v == 0 for v in dealer.remaining().values())
    assert dealer._live_bytes == 0 and dealer._live_slots == 0
    dealer.close()
    jdealer.close()
    with pytest.raises(IndexError):
        T.SlotDealer(plans, start_slot=7)


def test_slot_dealer_worker_matches_reference_inline_generation(
        monkeypatch):
    """The streamed worker, slot by slot within SLOT_WINDOW live slots,
    serves the words the reference generates inline on acquire."""
    monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", 0)
    plans, jplans = _slot_plans(T, 21, n_slots=8), _slot_plans(JT, 21,
                                                                n_slots=8)
    dealer = T.SlotDealer(plans, seed=4, stream=True)
    jdealer = JT.SlotDealer(jplans, seed=4, stream=True, async_gen=False,
                            window=T.SLOT_WINDOW, group_bytes=0)
    got = [w for i in range(len(plans))
           for w in _serve(dealer.acquire(i), plans[i])]
    want = [w for i in range(len(jplans))
            for w in _serve(jdealer.acquire(i), jplans[i])]
    _same(got, want)
    assert dealer.pool_bytes <= T.SLOT_WINDOW * max(8 * p.pool_words()
                                                    for p in plans)
    dealer.close()
    assert dealer._worker is None


def test_slot_dealer_forward_acquire_past_window_no_deadlock(monkeypatch):
    """acquire(i) far beyond the backpressure window generates through to
    slot i (a waiting caller overrides the window), with canonical words."""
    monkeypatch.setattr(T, "SLOT_WINDOW", 2)
    monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", 0)
    plans = [T.TriplePlan([T.PlanRequest("mul", (8, 8), "t")])
             for _ in range(10)]
    dealer = T.SlotDealer(plans, seed=2, stream=True)
    got = dealer.acquire(7).mul_triple((8, 8))
    pooled = T.PooledDealer(T.TriplePlan([r for p in plans
                                          for r in p.requests]), seed=2)
    for _ in range(8):                   # the 8th draw is slot 7's word
        want = pooled.mul_triple((8, 8))
    assert torch.equal(got.u.s0, want.u.s0)
    assert torch.equal(got.z.s1, want.z.s1)
    dealer.close()


@pytest.mark.parametrize("stream", [False, True], ids=["pooled", "streamed"])
def test_slot_dealer_exhaustion_and_reacquire(stream):
    plans = [T.TriplePlan([T.PlanRequest("mul", (2, 2), "t")])] * 2
    dealer = T.SlotDealer(plans, seed=1, stream=stream)
    v = dealer.acquire(0)
    v.mul_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="exhausted"):
        v.mul_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="never"):
        dealer.acquire(1).bin_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="already"):
        dealer.acquire(0)
    with pytest.raises(IndexError):
        dealer.acquire(7)
    dealer.close()


def test_slot_dealer_worker_exception_reaches_the_consumer(monkeypatch):
    plans = [T.TriplePlan([T.PlanRequest("mul", (2, 2), "t")])] * 3
    real = T._gen_tranche_split
    calls = []

    def failing(rngs, counts_list, device, staging=None):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("upload failed")
        return real(rngs, counts_list, device, staging)

    monkeypatch.setattr(T, "_gen_tranche_split", failing)
    monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", 0)
    dealer = T.SlotDealer(plans, seed=3, stream=True)
    dealer.acquire(0).mul_triple((2, 2))
    with pytest.raises(RuntimeError, match="worker failed"):
        dealer.acquire(1)
    dealer.close()
    assert dealer._worker is None


def test_slot_dealer_closed_refuses_and_frees():
    plans = [T.TriplePlan([T.PlanRequest("rand", (3,), "t")])] * 4
    dealer = T.SlotDealer(plans, seed=1, stream=False)
    dealer.acquire(0).rand((3,))
    dealer.close()
    assert dealer._live_bytes == 0 and dealer._live_slots == 0
    with pytest.raises(T.PoolExhaustedError, match="closed"):
        dealer.acquire(1)
    assert dealer.remaining() == {("rand", (3,)): 3}


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _tasks(trace, n=3, fail_at=None):
    def mk(t):
        def launch(p, t=t):
            trace.append(("launch", t))
            if (t, "launch") == fail_at:
                raise ValueError(f"task {t}")
            return p + 1

        def pre(t=t):
            trace.append(("pre", t))
            if (t, "pre") == fail_at:
                raise ValueError(f"task {t}")
            return t * 10

        return StageTask(
            pre=pre, launch=launch,
            mid=lambda p, o, t=t: trace.append(("mid", t)) or o + p,
            post=lambda p, o, m, t=t: trace.append(("post", t)) or m)
    return [mk(t) for t in range(n)]


@pytest.mark.parametrize("pipeline", [False, True], ids=["seq", "pipe"])
def test_run_pipeline_phase_order_equals_reference(pipeline):
    """The same results and the same phase order as the reference's
    executor; pipelined, the only reordering is pre(t+1) before mid(t)."""
    trace, jtrace = [], []
    out = run_pipeline(_tasks(trace), pipeline=pipeline)
    jout = JPL.run_pipeline(_tasks(jtrace), pipeline=pipeline)
    assert out == jout == [1, 21, 41]
    assert trace == jtrace
    for t in range(3):
        assert trace.index(("pre", t)) < trace.index(("launch", t)) \
            < trace.index(("mid", t)) < trace.index(("post", t))
    if pipeline:
        assert trace.index(("pre", 1)) < trace.index(("mid", 0))
    else:
        assert trace.index(("pre", 1)) > trace.index(("post", 0))


@pytest.mark.parametrize("fail_at", [(1, "pre"), (1, "launch"), (0, "launch"),
                                     (2, "pre")])
@pytest.mark.parametrize("pipeline", [False, True], ids=["seq", "pipe"])
def test_run_pipeline_capture_errors_equals_reference(pipeline, fail_at):
    """capture_errors: a failing task yields a PipelineError in its place,
    the others still run, and no pre runs twice — as in the reference;
    without it the first failure propagates."""
    trace, jtrace = [], []
    out = run_pipeline(_tasks(trace, fail_at=fail_at), pipeline=pipeline,
                       capture_errors=True)
    jout = JPL.run_pipeline(_tasks(jtrace, fail_at=fail_at),
                            pipeline=pipeline, capture_errors=True)
    assert trace == jtrace
    assert len(out) == len(jout) == 3
    for got, want in zip(out, jout):
        if isinstance(want, JPL.PipelineError):
            assert isinstance(got, PipelineError)
            assert got.index == want.index
            assert str(got.exc) == str(want.exc)
        else:
            assert got == want
    assert all(trace.count(("pre", t)) == 1 for t in range(3))
    with pytest.raises(ValueError, match=f"task {fail_at[0]}"):
        run_pipeline(_tasks([], fail_at=fail_at), pipeline=pipeline)
