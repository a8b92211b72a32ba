"""The port's offline phase against the JAX package's: the planner's
schedule, the pooled and streaming dealers' words, the S1/S3 programs'
schedules and whole pooled / streamed fits (backend="torch", CPU) against
the reference (backend="xla"), word for word: shares, dealer counters,
CommLog bytes and rounds per tag and phase, and modelled he_seconds."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import kmeans as JK
from repro.core import triples as JT
from repro.launch import kmeans_step as JKS
from repro_torch.core import kmeans as KM
from repro_torch.core import ring
from repro_torch.core import triples as T
from repro_torch.core.backend import CudaBackend, TorchBackend, get_backend
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.launch import kmeans_step as KS

SHAPES = {"matmul": ((5, 3), (3, 2)), "mul": (4, 3), "bin": (2, 7),
          "rand": (6,), "seed": ()}
KINDS = list(SHAPES)


def _schedule(seed: int, length: int) -> list:
    """A random interleaved request schedule over a few shape-classes (two
    of them of one kind)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for kind in rng.choice(KINDS + ["mul2"], size=length):
        if kind == "mul2":
            reqs.append(T.PlanRequest("mul", (5,), "b"))
        else:
            reqs.append(T.PlanRequest(str(kind), SHAPES[kind], "t"))
    return reqs


def _consume(dealer, requests) -> list:
    """Serve a schedule; every served word as uint64 numpy."""
    out = []
    for r in requests:
        if r.kind == "matmul":
            t = dealer.matmul_triple(*r.shape, tag=r.tag)
            out += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
        elif r.kind == "mul":
            t = dealer.mul_triple(r.shape, tag=r.tag)
            out += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
        elif r.kind == "bin":
            t = dealer.bin_triple(r.shape, tag=r.tag)
            out += [t.u.b0, t.u.b1, t.v.b0, t.v.b1, t.z.b0, t.z.b1]
        elif r.kind == "rand":
            out.append(dealer.rand(r.shape))
        else:
            out.append(np.uint64(dealer.mask_seed()))
    return [ring.to_u64_numpy(a) if isinstance(a, torch.Tensor)
            else np.asarray(a, np.uint64) for a in out]


def _same_words(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _jplan(requests) -> "JT.TriplePlan":
    return JT.TriplePlan([JT.PlanRequest(*r) for r in requests])


# ---------------------------------------------------------------------------
# dealers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,length", [(0, 1), (1, 7), (2, 16), (3, 24),
                                         (4, 40)])
def test_pooled_equals_trusted_and_reference_pooled(seed, length):
    """Every served word of a bulk-generated pool equals the on-demand
    dealer's and the reference's pooled dealer's; the offline tallies,
    the modelled OT time and the pool's bytes agree too."""
    requests = _schedule(seed, length)
    plan = T.TriplePlan(requests)
    pooled = T.PooledDealer(plan, seed=seed)
    got = _consume(pooled, requests)
    _same_words(got, _consume(T.TrustedDealer(seed=seed), requests))
    jpooled = JT.PooledDealer(_jplan(requests), seed=seed)
    _same_words(got, _consume(jpooled, requests))
    assert pooled.log.by_tag("offline") == jpooled.log.by_tag("offline")
    assert pooled.modelled_ot_seconds == jpooled.modelled_ot_seconds
    assert pooled.pool_bytes == jpooled.pool_bytes
    assert (pooled.n_matmul, pooled.n_mul, pooled.n_bin) == \
        (jpooled.n_matmul, jpooled.n_mul, jpooled.n_bin)
    assert all(v == 0 for v in pooled.remaining().values())


@pytest.mark.parametrize("draw_words", [1, 50, 400])
def test_pooled_draws_in_chunks_equal_one_draw(monkeypatch, draw_words):
    """A class drawn a few requests at a time (at most DRAW_WORDS words a
    draw, at least one request) serves the words of one draw."""
    requests = _schedule(12, 30)
    plan = T.TriplePlan(requests)
    want = _consume(T.PooledDealer(plan, seed=6), requests)
    monkeypatch.setattr(T, "DRAW_WORDS", draw_words)
    _same_words(_consume(T.PooledDealer(plan, seed=6), requests), want)
    stream = T.StreamingPooledDealer(T.TriplePlan(requests[:10]), 3, seed=6)
    _same_words(_consume(stream, requests[:10] * 3),
                _consume(T.PooledDealer(T.TriplePlan(requests[:10] * 3),
                                        seed=6), requests[:10] * 3))


@pytest.mark.parametrize("skip", [1, 3])
def test_pooled_advance_equals_trusted_and_reference(skip):
    """`advance` starts each class stream past the requests an earlier run
    consumed: the same words as an advanced on-demand dealer and as the
    reference's advanced pool."""
    requests = _schedule(9, 20)
    plan = T.TriplePlan(requests)
    adv = {key: skip * c for key, c in plan.class_counts().items()}
    got = _consume(T.PooledDealer(plan, seed=4, advance=adv), requests)
    _same_words(got, _consume(T.TrustedDealer(seed=4, advance=adv),
                              requests))
    _same_words(got, _consume(JT.PooledDealer(_jplan(requests), seed=4,
                                              advance=adv), requests))
    # the stream really moved: the first pass's words differ
    first = _consume(T.PooledDealer(plan, seed=4), requests)
    assert any(not np.array_equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("group", [1, 2, 3, 7, "auto"])
@pytest.mark.parametrize("async_gen", [True, False], ids=["async", "sync"])
def test_streaming_equals_pooled(group, async_gen):
    """Per-iteration tranches, grouped or not, generated on the worker or
    inline, serve exactly the words of the bulk pool over all iterations
    (the stacked draws concatenate), and every tranche is consumed."""
    requests = _schedule(21, 12)
    iters = 5
    plan = T.TriplePlan(requests)
    want = _consume(T.PooledDealer(plan.repeat(iters), seed=8),
                    requests * iters)
    stream = T.StreamingPooledDealer(plan, iters, seed=8, group=group,
                                     async_gen=async_gen)
    _same_words(_consume(stream, requests * iters), want)
    assert stream.served_iters == iters
    assert all(v == 0 for v in stream.remaining().values())
    # offline tallies are the whole fit's, as the reference books them
    jstream = JT.StreamingPooledDealer(_jplan(requests), iters, seed=8,
                                       group=group, async_gen=False)
    assert stream.log.by_tag("offline") == jstream.log.by_tag("offline")
    assert stream.modelled_ot_seconds == jstream.modelled_ot_seconds
    assert stream.group == jstream.group
    stream.close()
    jstream.close()


def test_streaming_peak_residency_is_independent_of_iters():
    """Peak residency is `prefetch` tranches, whatever the fit length,
    while the bulk pool grows with iters."""
    requests = [T.PlanRequest("mul", (32, 8), "t"),
                T.PlanRequest("bin", (16,), "t")]
    plan = T.TriplePlan(requests)
    tranche = T.PooledDealer(plan, seed=1).pool_bytes
    peaks = {}
    for iters in (2, 8):
        s = T.StreamingPooledDealer(plan, iters, seed=1, async_gen=False)
        _consume(s, requests * iters)
        peaks[iters] = s.pool_bytes
    assert peaks[2] == peaks[8] == 2 * tranche
    assert peaks[8] < T.PooledDealer(plan.repeat(8), seed=1).pool_bytes
    s = T.StreamingPooledDealer(plan, 8, seed=1)           # async worker
    _consume(s, requests * 8)
    assert s.pool_bytes <= 2 * tranche


@pytest.mark.parametrize("make", [
    lambda plan: T.PooledDealer(plan.repeat(2), seed=1),
    lambda plan: T.StreamingPooledDealer(plan, 2, seed=1)],
    ids=["pooled", "streamed"])
def test_exhaustion_and_unplanned_class_raise(make):
    plan = T.TriplePlan([T.PlanRequest("mul", (2, 2), "t")])
    dealer = make(plan)
    dealer.mul_triple((2, 2))
    dealer.mul_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="exhausted"):
        dealer.mul_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="never"):
        make(plan).bin_triple((2, 2))
    with pytest.raises(T.PoolExhaustedError, match="never"):
        make(plan).matmul_triple((2, 3), (3, 1))


def test_streaming_early_stop_leaves_surplus_and_closes():
    """Stopping mid-schedule (the tol case) leaves counted surplus and
    never generates the undispatched tranches; close() is idempotent and
    stops the worker."""
    requests = [T.PlanRequest("mul", (2, 2), "t"),
                T.PlanRequest("rand", (3,), "t")]
    dealer = T.StreamingPooledDealer(T.TriplePlan(requests), 10, seed=2)
    _consume(dealer, requests * 2)       # 2 of 10 iterations
    dealer.mul_triple((2, 2))            # half of iteration 3
    rem = dealer.remaining()
    assert rem[("mul", (2, 2))] == 7 and rem[("rand", (3,))] == 8
    dealer.close()
    dealer.close()
    assert dealer._executor._shutdown
    assert dealer._live_bytes == 0
    assert dealer.remaining() == rem


def test_streaming_worker_exception_reaches_the_consumer(monkeypatch):
    """A tranche the worker fails to make raises at the request that needs
    it, not later and not silently."""
    requests = [T.PlanRequest("mul", (2, 2), "t")]
    real = T._gen_tranche
    calls = []

    def failing(rngs, counts, device, stream=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("upload failed")
        return real(rngs, counts, device, stream)

    monkeypatch.setattr(T, "_gen_tranche", failing)
    dealer = T.StreamingPooledDealer(T.TriplePlan(requests), 4, seed=3)
    dealer.mul_triple((2, 2))
    dealer.mul_triple((2, 2))
    with pytest.raises(RuntimeError, match="upload failed"):
        dealer.mul_triple((2, 2))
    dealer.close()                       # the fit's `finally` still closes
    assert dealer._executor._shutdown


def test_tranche_entries_are_views_of_one_upload():
    """One stacked draw and one tensor per class: a request's six words are
    views into it, not copies."""
    plan = T.TriplePlan([T.PlanRequest("matmul", ((4, 3), (3, 2)), "t")] * 3)
    dealer = T.PooledDealer(plan, seed=0)
    entries = dealer._pools[("matmul", (4, 3), (3, 2))]
    bases = {t.untyped_storage().data_ptr() for e in entries for t in e}
    assert len(bases) == 1
    assert dealer.pool_bytes == 3 * 8 * (2 * 12 + 2 * 6 + 2 * 8)


def test_pooled_offline_arrays_match_trusted_dealer():
    """The S1 program's bulk offline arrays equal the on-demand flat list,
    tensor for tensor, over several iterations from one pool."""
    progs = KS.fit_programs("vertical", False, (16, 2), (16, 2), 2,
                            backend="torch", device="cpu")
    flats, dealer = KS.pooled_offline_arrays(progs.s1_requests, seed=23,
                                             iters=2)
    trusted = T.TrustedDealer(seed=23)
    for flat in flats:
        want = KS.materialize_offline(progs.s1_requests, trusted)
        _same_words([ring.to_u64_numpy(t) for t in flat],
                    [ring.to_u64_numpy(t) for t in want])
    assert all(v == 0 for v in dealer.remaining().values())


# ---------------------------------------------------------------------------
# planner and programs
# ---------------------------------------------------------------------------

def _shapes(partition):
    return ((12, 2), (12, 3)) if partition == "vertical" else \
        ((7, 4), (5, 4))


@pytest.mark.parametrize("tol", [None, 1e-3], ids=["no_tol", "tol"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_plan_offline_equals_reference(partition, sparse, tol):
    """The planner's schedule equals the reference's request for request
    (kind, shape, tag), and the traced iteration's online traffic per tag."""
    sa, sb = _shapes(partition)
    common = dict(k=3, iters=2, partition=partition, sparse=sparse, tol=tol,
                  seed=1)
    km = SecureKMeans(KMeansConfig(backend="torch", device="cpu", **common))
    jkm = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common))
    got, want = km.plan_offline(sa, sb), jkm.plan_offline(sa, sb)
    assert len(got) == len(want) > 0
    for r, q in zip(got.requests, want.requests):
        assert (r.kind, r.shape, r.tag) == (q.kind, q.shape, q.tag)
    assert got.class_counts() == want.class_counts()
    assert got.pool_words() == want.pool_words()
    _, comm = km._plan_offline_iter(sa, sb)
    _, jcomm = jkm._plan_offline_iter(sa, sb)
    assert comm.by_tag("online") == jcomm.by_tag("online")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_fit_programs_schedules_equal_reference(partition, sparse):
    """The S1/S3 programs consume the reference's schedules, tensor for
    tensor, and running them over a same-seeded on-demand dealer's words
    gives the reference programs' shares."""
    sa, sb = _shapes(partition)
    k = 3
    progs = KS.fit_programs(partition, sparse, sa, sb, k, backend="torch",
                            device="cpu")
    jprogs = JKS.fit_programs(partition, sparse, sa, sb, k, backend="xla")
    assert progs.s1_requests == jprogs.s1_requests
    assert progs.s3_requests == jprogs.s3_requests
    assert progs.geo == KS.FitGeometry(partition, sparse, sa, sb, k)
    rng = np.random.default_rng(6)
    geo = progs.geo

    def words(shape):
        return rng.integers(0, 1 << 64, shape, dtype=np.uint64)

    xa, xb = words(sa), words(sb)
    mu = [words((k, geo.d)) for _ in range(2)]
    he1 = [words(s) for s in geo.he_shapes_s1() for _ in range(2)]
    he3 = [words(s) for s in geo.he_shapes_s3() for _ in range(2)]
    tt = [ring.from_u64_numpy(a) for a in (xa, xb, *mu)]
    flat1 = KS.materialize_offline(progs.s1_requests, T.TrustedDealer(seed=2))
    jflat1 = JKS.materialize_offline(jprogs.s1_requests,
                                     JT.TrustedDealer(seed=2))
    c = progs.s1(*tt, *[ring.from_u64_numpy(a) for a in he1], *flat1)
    jc = jprogs.s1(xa, xb, *mu, *he1, *jflat1)
    for got, want in zip(c, jc):
        np.testing.assert_array_equal(ring.to_u64_numpy(got),
                                      np.asarray(want, np.uint64))
    flat3 = KS.materialize_offline(progs.s3_requests, T.TrustedDealer(seed=3))
    jflat3 = JKS.materialize_offline(jprogs.s3_requests,
                                     JT.TrustedDealer(seed=3))
    out = progs.s3(*tt, *c, *[ring.from_u64_numpy(a) for a in he3], *flat3)
    jout = jprogs.s3(xa, xb, *mu, *jc, *he3, *jflat3)
    for got, want in zip(out, jout):
        np.testing.assert_array_equal(ring.to_u64_numpy(got),
                                      np.asarray(want, np.uint64))


def test_fit_geometry_validation():
    with pytest.raises(ValueError, match="partition"):
        KS.FitGeometry("diagonal", False, (4, 2), (4, 2), 2)
    with pytest.raises(ValueError, match="sample counts"):
        KS.FitGeometry("vertical", False, (4, 2), (5, 2), 2)
    with pytest.raises(ValueError, match="feature counts"):
        KS.FitGeometry("horizontal", False, (4, 2), (5, 3), 2)
    geo = KS.FitGeometry("horizontal", True, (4, 3), (5, 3), 2)
    assert (geo.n, geo.d, geo.d_a) == (9, 3, 3)
    assert geo.he_shapes_s1() == [(4, 2), (5, 2)]
    assert geo.he_shapes_s3() == [(2, 3), (2, 3)]


def test_plan_cache_skips_second_trace(monkeypatch):
    KM.clear_plan_cache()
    x = _blobs(40, 4, 2, seed=3)
    cfg = KMeansConfig(k=2, iters=2, seed=5, backend="torch", device="cpu",
                       offline="pooled")
    r1 = SecureKMeans(cfg).fit(x[:, :2], x[:, 2:])
    assert len(KM._PLAN_CACHE) == 1 and r1.offline_plan_seconds > 0.0

    def boom(self, sa, sb):
        raise AssertionError("second identical fit re-traced the plan")

    monkeypatch.setattr(SecureKMeans, "_trace_iteration", boom)
    r2 = SecureKMeans(cfg).fit(x[:, :2], x[:, 2:])
    assert torch.equal(r1.centroids.s0, r2.centroids.s0)
    # a DIFFERENT config key must re-trace (and here: blow up)
    with pytest.raises(AssertionError, match="re-traced"):
        SecureKMeans(dataclasses.replace(cfg, tol=1e-9)).fit(x[:, :2],
                                                             x[:, 2:])


# ---------------------------------------------------------------------------
# whole fits against the reference
# ---------------------------------------------------------------------------

def _blobs(n, d, k, seed, sparse_frac=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.normal(0, 0.3, (n, d))
    if sparse_frac:
        x = x * (rng.random((n, d)) >= sparse_frac)
    return x


def _fit_pair(partition, sparse, offline, n=48, k=2, iters=2, **extra):
    x = _blobs(n, 4, k, seed=11, sparse_frac=0.5 if sparse else 0.0)
    a, b = (x[:, :2], x[:, 2:]) if partition == "vertical" else \
        (x[:n // 2], x[n // 2:])
    common = dict(k=k, iters=iters, partition=partition, sparse=sparse,
                  seed=5, offline=offline, **extra)
    rj = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common)).fit(a, b)
    rt = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                   **common)).fit(a, b)
    return rj, rt


def _assert_same_fit(rj, rt):
    for field in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(rt, field))
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(getattr(rj, field)[i], np.uint64))
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(rj.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == rj.log.by_tag(phase), phase
    assert rt.he_seconds == rj.he_seconds
    assert rt.iters_run == rj.iters_run
    assert rt.offline_modelled_ot_seconds == rj.offline_modelled_ot_seconds
    assert rt.dealer.remaining() == rj.dealer.remaining()


@pytest.mark.parametrize("offline", ["pooled", "streamed"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_pooled_fit_equals_reference(partition, sparse, offline):
    """The S1/S3 program path over the pool (the sparse combos with
    Protocol 2 on the host around S1) equals the reference's."""
    rj, rt = _fit_pair(partition, sparse, offline)
    _assert_same_fit(rj, rt)
    assert rt.loop_seconds == rt.online_seconds
    assert rt.offline_dealer_seconds >= rt.offline_plan_seconds > 0.0
    if offline == "streamed":
        assert rt.dealer.served_iters == 2 and rt.dealer.wait_seconds >= 0


@pytest.mark.parametrize("offline", ["pooled", "streamed"])
@pytest.mark.parametrize("case", [
    dict(vectorized=False), dict(f=16), dict(tol=1e-2, f=16),
    dict(tol=1e-6, iters=12, n=120, k=3)],
    ids=["unvectorized", "f16", "tol_f16", "tol_early_stop"])
def test_pooled_fit_eager_fallback_and_tol_equal_reference(case, offline):
    """vectorized=False and a custom f run the eager loop against the
    pooled dealer; tol checks convergence after each program pair (its
    triples planned, its traffic outside the replayed iteration). An early
    stop leaves surplus in the pool."""
    case = dict(case)
    partition = "horizontal" if "f" in case and "tol" not in case \
        else "vertical"
    rj, rt = _fit_pair(partition, False, offline, **case)
    _assert_same_fit(rj, rt)
    if case.get("iters") == 12:
        assert rt.iters_run < 12
        assert any(v > 0 for v in rt.dealer.remaining().values())


def test_pooled_he_seconds_add_in_the_on_demand_order():
    """The forked ctx adds each exchange's modelled HE time to the fit in
    the on-demand loop's order, so pooled and on-demand fits agree to the
    last bit even where a per-iteration partial sum would round
    differently (k = 10, vertical, 2,048 x 256)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.3, (2048, 256)) + rng.integers(0, 3, (2048, 1))
    x *= rng.random(x.shape) >= 0.9
    res = {}
    for off in ("on_demand", "pooled"):
        cfg = KMeansConfig(k=10, iters=2, seed=3, sparse=True, offline=off,
                           backend="torch", device="cpu")
        res[off] = SecureKMeans(cfg).fit(x[:, :128], x[:, 128:])
    assert res["pooled"].he_seconds == res["on_demand"].he_seconds
    for i in (0, 1):
        assert torch.equal(res["pooled"].centroids[i],
                           res["on_demand"].centroids[i])


# ---------------------------------------------------------------------------
# configuration (ROADMAP Queue 3, fault 1)
# ---------------------------------------------------------------------------

def test_every_reference_config_keyword_constructs_the_port_config():
    """Each field of the reference's KMeansConfig, at its default and at
    its other documented values, constructs the port's config."""
    ref_fields = {f.name: f for f in dataclasses.fields(JK.KMeansConfig)}
    port_fields = {f.name for f in dataclasses.fields(KMeansConfig)}
    assert set(ref_fields) <= port_fields
    values = {"k": [3], "iters": [1, 10], "partition": ["vertical",
                                                         "horizontal"],
              "sparse": [False, True], "vectorized": [True, False],
              "f": [ring.F, 16], "seed": [0, 7],
              "init": ["random_data", "random_uniform"],
              "tol": [None, 1e-4], "he_backend": [None],
              "backend": ["auto", None, "torch"],
              "offline": ["on_demand", "pooled", "streamed"],
              "batch_size": [None, 16], "pipeline": [True, False]}
    assert set(values) == set(ref_fields)
    for name, vals in values.items():
        for v in vals:
            kw = {"k": 3, "backend": "torch", "device": "cpu", name: v}
            ref = JK.KMeansConfig(**{"k": 3, name: v})
            cfg = KMeansConfig(**kw)
            assert getattr(cfg, name) == getattr(ref, name)
    with pytest.raises(ValueError, match="init"):
        KMeansConfig(k=3, init="kmeans++", device="cpu")


def test_auto_backend_resolves_by_device(monkeypatch):
    """"auto" and None resolve by the device the shares live on — never by
    whether a GPU is present: a CPU device gets the torch backend even with
    a GPU, and a CUDA device the cuda backend (which raises without one)."""
    for name in ("auto", None):
        assert isinstance(get_backend(name, "cpu"), TorchBackend)
        assert isinstance(get_backend(name, torch.device("cpu")),
                          TorchBackend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert isinstance(get_backend("auto", "cpu"), TorchBackend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("repro_torch.core.backend._INSTANCES", {})
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        get_backend("auto", "cuda")
    assert CudaBackend.name == "cuda"
    # a CPU fit with backend="auto" equals the torch-backend fit
    x = _blobs(24, 4, 2, seed=1)
    res = [SecureKMeans(KMeansConfig(k=2, iters=1, backend=b,
                                     device="cpu")).fit(x[:, :2], x[:, 2:])
           for b in ("auto", None, "torch")]
    for r in res[1:]:
        assert torch.equal(r.centroids.s0, res[0].centroids.s0)
    # with the default device, "auto" is the card: it raises without one
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        SecureKMeans(KMeansConfig(k=2, iters=1, backend="auto")).fit(
            x[:, :2], x[:, 2:])
