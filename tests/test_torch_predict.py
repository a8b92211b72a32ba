"""Secure scoring of the port against the JAX package's (backend="xla"),
word for word: `predict` and `score`, eager and as the scoring program, in
both partitions, dense and sparse, over the reference's fitted model
carried across with `result_from_reference` — the assignment and score
share words, the dealer counters, the per-tag CommLog and the
`plan_predict` request list. Also the default dealer's domain separation,
and the rejection of configs the program path cannot run (wired scoring
is in tests/test_torch_wire.py). The contracts are those of the
reference's tests/test_serve.py.
"""
import numpy as np
import pytest
import torch

from repro.core import kmeans as JK
from repro.core import triples as JT
from repro_torch.core import kmeans as KM
from repro_torch.core import triples as T
from repro_torch.core.interop import result_from_reference, shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.launch import kmeans_step as KS

COMBOS = [("vertical", False), ("vertical", True),
          ("horizontal", False), ("horizontal", True)]


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


_FITTED = {}


def fitted(partition, sparse, seed=5):
    """(JAX model, port model over the JAX model's shares) of one combo,
    fitted once per test session."""
    key = (partition, sparse, seed)
    if key not in _FITTED:
        x = _blobs(96, 4, 3, 1, 0.5 if sparse else 0.0)
        a, b = _split(x, partition)
        common = dict(k=3, iters=3, partition=partition, sparse=sparse,
                      seed=seed)
        jk = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common))
        rj = jk.fit(a, b)
        tk = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                       **common))
        tk.result_ = result_from_reference({
            "centroids": (np.asarray(rj.centroids.s0, np.uint64),
                          np.asarray(rj.centroids.s1, np.uint64)),
            "assignment": (np.asarray(rj.assignment.s0, np.uint64),
                           np.asarray(rj.assignment.s1, np.uint64))})
        _FITTED[key] = (jk, tk)
    return _FITTED[key]


def _batch(partition, sparse, m=20, seed=9):
    xq = _blobs(m, 4, 3, seed, 0.5 if sparse else 0.0)
    return (xq, *_split(xq, partition))


def _assert_same_predict(pj, pt, scores: bool) -> None:
    fields = ("assignment", "scores") if scores else ("assignment",)
    for field in fields:
        got = shares_to_numpy(getattr(pt, field))
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(getattr(pj, field)[i], np.uint64))
    if not scores:
        assert pt.scores is None and pj.scores is None
    for phase in ("online", "offline"):
        assert pt.log.by_tag(phase) == pj.log.by_tag(phase), phase
    np.testing.assert_array_equal(pt.labels_plain(), pj.labels_plain())
    if scores:
        np.testing.assert_array_equal(pt.scores_plain(), pj.scores_plain())


def _counters(dealer) -> tuple:
    return dealer.n_matmul, dealer.n_mul, dealer.n_bin


@pytest.mark.parametrize("compiled", [True, False], ids=["program", "eager"])
@pytest.mark.parametrize("method", ["predict", "score"])
@pytest.mark.parametrize("partition,sparse", COMBOS)
def test_predict_equals_reference(partition, sparse, method, compiled):
    """Same seeded dealer: the same share words, dealer counters and
    per-tag traffic as the JAX package, on the program path and the eager
    one."""
    jk, tk = fitted(partition, sparse)
    _, qa, qb = _batch(partition, sparse)
    dj = JT.TrustedDealer(seed=7)
    dt = T.TrustedDealer(seed=7, device="cpu")
    pj = getattr(jk, method)(qa, qb, dealer=dj, compiled=compiled)
    pt = getattr(tk, method)(qa, qb, dealer=dt, compiled=compiled)
    _assert_same_predict(pj, pt, method == "score")
    assert _counters(dt) == _counters(dj)
    assert dt.log.by_tag("offline") == dj.log.by_tag("offline")


@pytest.mark.parametrize("partition,sparse", COMBOS)
def test_default_dealer_program_equals_eager_and_reference(partition,
                                                           sparse):
    """The default dealer (serve_seed of the fit's seed, its offline
    tallies on the result's log): program and eager path each equal the
    JAX package's, and each other in shares and online traffic (the eager
    path tags its offline tallies by step, the program path "misc", in
    both packages)."""
    jk, tk = fitted(partition, sparse)
    _, qa, qb = _batch(partition, sparse, seed=31)
    fast = tk.score(qa, qb)
    eager = tk.score(qa, qb, compiled=False)
    _assert_same_predict(jk.score(qa, qb), fast, True)
    _assert_same_predict(jk.score(qa, qb, compiled=False), eager, True)
    for i in (0, 1):
        assert torch.equal(fast.scores[i], eager.scores[i])
        assert torch.equal(fast.assignment[i], eager.assignment[i])
    assert fast.log.by_tag("online") == eager.log.by_tag("online")


@pytest.mark.parametrize("partition,sparse", COMBOS)
@pytest.mark.parametrize("with_scores", [False, True])
def test_plan_predict_equals_reference(partition, sparse, with_scores):
    """The bank key, the request list and the traced traffic of one
    scoring call equal the reference's; the program's recorded schedule is
    the plan's kinds and shapes."""
    jk, tk = fitted(partition, sparse)
    _, qa, qb = _batch(partition, sparse, m=11)
    kj, plan_j, comm_j = jk.plan_predict(qa.shape, qb.shape, with_scores)
    kt, plan_t, comm_t = tk.plan_predict(qa.shape, qb.shape, with_scores)
    assert kt == kj
    assert [tuple(r) for r in plan_t.requests] \
        == [tuple(r) for r in plan_j.requests]
    assert comm_t.by_tag("online") == comm_j.by_tag("online")
    prog = KS.predict_program(partition, sparse, qa.shape, qb.shape, 3,
                              with_scores=with_scores, backend="torch",
                              device="cpu")
    assert prog.requests == [(r.kind, r.shape) for r in plan_t.requests
                             if r.kind != "seed"]


def test_plan_caches_and_clear():
    _, tk = fitted("vertical", False)
    KM.clear_plan_cache()
    KS.clear_program_cache()
    tk.plan_predict((8, 2), (8, 2), True)
    assert len(KM._PREDICT_PLAN_CACHE) == 1
    tk.score(np.zeros((8, 2)), np.zeros((8, 2)))
    assert len(KS._PREDICT_PROGRAM_CACHE) == 1
    KM.clear_plan_cache()
    KS.clear_program_cache()
    assert not KM._PREDICT_PLAN_CACHE and not KS._PREDICT_PROGRAM_CACHE


def test_default_randomness_is_domain_separated():
    """The default dealer does NOT replay the fit's per-class streams, in
    either package, while the output is dealer-independent."""
    assert T.serve_seed(5) == JT.serve_seed(5) != 5
    _, tk = fitted("vertical", False, seed=5)
    _, qa, qb = _batch("vertical", False)
    default = tk.score(qa, qb)
    fit_seeded = tk.score(qa, qb, dealer=T.TrustedDealer(seed=5))
    assert not torch.equal(default.scores.s0, fit_seeded.scores.s0)
    np.testing.assert_array_equal(default.labels_plain(),
                                  fit_seeded.labels_plain())


def test_score_matches_nearest_centroid_and_distance():
    """Revealed labels are the nearest revealed centroid and the scores
    the squared distance to it (the port alone, horizontal)."""
    _, tk = fitted("horizontal", False)
    _, qa, qb = _batch("horizontal", False, m=24, seed=4)
    pr = tk.score(qa, qb)
    mu = tk.result_.centroids_plain()
    full = np.concatenate([qa, qb], 0)        # outputs: [A rows; B rows]
    lab = pr.labels_plain()
    np.testing.assert_array_equal(
        lab, ((mu ** 2).sum(1)[None] - 2 * full @ mu.T).argmin(1))
    np.testing.assert_allclose(pr.scores_plain(),
                               ((full - mu[lab]) ** 2).sum(1), atol=1e-2)
    with pytest.raises(ValueError, match="no scores"):
        tk.predict(qa, qb).scores_plain()


def test_predict_argument_checks_equal_reference():
    """A missing model, a wrong feature split and unequal vertical rows
    raise the reference's ValueErrors."""
    jk, tk = fitted("vertical", False)
    cases = [(np.zeros((4, 2)), np.zeros((5, 2))),
             (np.zeros((4, 3)), np.zeros((4, 2)))]
    for qa, qb in cases:
        msgs = []
        for km in (jk, tk):
            with pytest.raises(ValueError) as exc:
                km.predict(qa, qb)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    for km in (JK.SecureKMeans(JK.KMeansConfig(k=3, backend="xla")),
               SecureKMeans(KMeansConfig(k=3, backend="torch",
                                         device="cpu"))):
        with pytest.raises(ValueError, match="fitted"):
            km.predict(np.zeros((4, 2)), np.zeros((4, 2)))


def test_program_path_rejects_unsupported_configs():
    """compiled=True must error loudly rather than truncate at the wrong
    fixed-point scale; an unvectorized config cannot stage the program;
    the automatic choice runs the eager path for both, equal to the JAX
    package's."""
    x = _blobs(48, 4, 2, 3)
    qa, qb = x[:8, :2], x[:8, 2:]
    for extra, match in ((dict(f=16), "hardcodes"),
                         (dict(vectorized=False), "predict_prepare")):
        common = dict(k=2, iters=2, seed=5, **extra)
        jk = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common))
        tk = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                       **common))
        jk.fit(x[:, :2], x[:, 2:])
        tk.fit(x[:, :2], x[:, 2:])
        for km in (jk, tk):
            with pytest.raises(ValueError, match=match):
                km.predict(qa, qb, compiled=True)
        _assert_same_predict(jk.score(qa, qb), tk.score(qa, qb), True)


def test_predict_prepare_launch_collect_is_the_program_path():
    """prepare -> launch -> collect by hand equals `score` on the same
    seeded dealer."""
    _, tk = fitted("vertical", True)
    _, qa, qb = _batch("vertical", True, m=9, seed=17)
    prep = tk.predict_prepare(qa, qb, dealer=T.TrustedDealer(seed=3),
                              with_scores=True)
    by_hand = tk.predict_collect(prep, tk.predict_launch(prep))
    direct = tk.score(qa, qb, dealer=T.TrustedDealer(seed=3))
    for field in ("assignment", "scores"):
        for i in (0, 1):
            assert torch.equal(getattr(by_hand, field)[i],
                               getattr(direct, field)[i])
    assert by_hand.seconds > 0.0
