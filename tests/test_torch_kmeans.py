"""Whole-fit parity of the port's SecureKMeans (backend="torch", CPU) with
the JAX package's (backend="xla"): same config and seed must give the same
centroid and assignment share words, dealer counters and per-tag online
and offline traffic. Also carries reference shares into the port's
per-step functions through core/interop.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import kmeans as JK
from repro.core import protocol as JP
from repro.core.channel import LAN, WAN
from repro.core.sharing import AShare as JAShare
from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.interop import (result_from_reference, shares_from_numpy,
                                      shares_to_numpy)
from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans, _encode_np,
                                     plaintext_kmeans)


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    lab = rng.integers(0, k, n)
    return centers[lab] + rng.normal(0, 0.3, (n, d))


def _split(x, partition):
    if partition == "vertical":
        return x[:, :2], x[:, 2:]
    return x[:20], x[20:]


def _fit_both(partition, vectorized=True, tol=None, f=ring.F, k=3, iters=2,
              n=48, d=5, seed=5):
    x = _blobs(n, d, k, seed=11)
    a, b = _split(x, partition)
    common = dict(k=k, iters=iters, partition=partition, seed=seed,
                  vectorized=vectorized, tol=tol, f=f)
    rj = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common)).fit(a, b)
    rt = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                   **common)).fit(a, b)
    return x, rj, rt


def _assert_fit_identical(rj, rt):
    for field in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(rt, field))
        for i in (0, 1):
            want = np.asarray(getattr(rj, field)[i], np.uint64)
            assert got[i].shape == want.shape
            np.testing.assert_array_equal(got[i], want)
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(rj.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == rj.log.by_tag(phase), phase
    assert rt.iters_run == rj.iters_run
    assert rt.offline_modelled_ot_seconds == rj.offline_modelled_ot_seconds
    np.testing.assert_array_equal(rt.labels_plain(), rj.labels_plain())
    np.testing.assert_array_equal(rt.centroids_plain(), rj.centroids_plain())


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
@pytest.mark.parametrize("vectorized", [True, False])
def test_fit_bit_exact_vs_reference(partition, vectorized):
    _, rj, rt = _fit_both(partition, vectorized=vectorized)
    _assert_fit_identical(rj, rt)


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_fit_with_tol_bit_exact_vs_reference(partition):
    """F_CSC path: the stop bit is revealed after each iteration."""
    _, rj, rt = _fit_both(partition, tol=1e-2, f=16, k=2, iters=2)
    _assert_fit_identical(rj, rt)
    assert rt.log.by_tag("online")["CSC"] == rj.log.by_tag("online")["CSC"]


def test_fit_k1_and_k5_bit_exact():
    for k in (1, 5):
        _, rj, rt = _fit_both("vertical", k=k, iters=1, n=40)
        _assert_fit_identical(rj, rt)


def test_result_helpers_match_reference():
    x, rj, rt = _fit_both("vertical")
    for net in (LAN, WAN):
        est_t = rt.wan_lan_estimate(net)
        est_j = rj.wan_lan_estimate(net)
        # wall-clock terms differ run to run; the modelled traffic terms not
        assert est_t["offline_s"] == est_j["offline_s"]
        assert est_t["online_s"] - rt.online_seconds == pytest.approx(
            est_j["online_s"] - rj.online_seconds, rel=1e-12)
    assert rt.loop_seconds >= rt.online_seconds >= 0.0
    assert rt.offline_dealer_seconds > 0.0


def test_plaintext_kmeans_matches_reference():
    x = _blobs(60, 4, 3, seed=2)
    for tol in (None, 1e-3):
        mu_t, lab_t = plaintext_kmeans(x, 3, 5, seed=4, tol=tol)
        mu_j, lab_j = JK.plaintext_kmeans(x, 3, 5, seed=4, tol=tol)
        np.testing.assert_array_equal(mu_t, mu_j)
        np.testing.assert_array_equal(lab_t, lab_j)


def test_result_from_reference_roundtrip():
    _, rj, _ = _fit_both("horizontal")
    arrays = {f: tuple(np.asarray(getattr(rj, f)[i], np.uint64)
                       for i in (0, 1))
              for f in ("centroids", "assignment")}
    res = result_from_reference(arrays, iters_run=rj.iters_run)
    np.testing.assert_array_equal(res.labels_plain(), rj.labels_plain())
    np.testing.assert_array_equal(res.centroids_plain(), rj.centroids_plain())
    for f in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(res, f))
        for i in (0, 1):
            np.testing.assert_array_equal(got[i], arrays[f][i])


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_steps_on_reference_centroid_shares(partition):
    """The reference fit's centroid shares, carried into the port's S1
    distances, S2 argmin and S3 update, give the reference's words."""
    x, rj, _ = _fit_both(partition, iters=1)
    a, b = _split(x, partition)
    n = x.shape[0] if partition == "vertical" else a.shape[0] + b.shape[0]
    mu_words = [np.asarray(rj.centroids[i], np.uint64) for i in (0, 1)]
    mu_j = JAShare(*[jnp.asarray(w) for w in mu_words])
    mu_t = shares_from_numpy(*mu_words)
    enc_a, enc_b = _encode_np(a, ring.F), _encode_np(b, ring.F)
    common = dict(k=3, partition=partition, seed=9)
    km_j = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common))
    km_t = SecureKMeans(KMeansConfig(backend="torch", device="cpu", **common))
    jctx = JP.make_ctx(9, backend="xla")
    tctx = P.make_ctx(9, backend="torch", device="cpu")
    ta, tb = ring.from_u64_numpy(enc_a), ring.from_u64_numpy(enc_b)

    def same(out_j, out_t):
        got = shares_to_numpy(out_t)
        for i in (0, 1):
            np.testing.assert_array_equal(got[i],
                                          np.asarray(out_j[i], np.uint64))
        assert tctx.log.by_tag("online") == jctx.log.by_tag("online")
        assert tctx.dealer.n_matmul == jctx.dealer.n_matmul

    jctx.tag = tctx.tag = "S1"
    dist_j = km_j._distances(jctx, enc_a, enc_b, None, None, mu_j)
    dist_t = km_t._distances(tctx, ta, tb, None, None, mu_t)
    same(dist_j, dist_t)
    jctx.tag = tctx.tag = "S2"
    c_j = JP.argmin_onehot(jctx, dist_j)
    c_t = P.argmin_onehot(tctx, dist_t)
    same(c_j, c_t)
    jctx.tag = tctx.tag = "S3"
    same(km_j._update(jctx, enc_a, enc_b, None, None, c_j, mu_j, n),
         km_t._update(tctx, ta, tb, None, None, c_t, mu_t, n))


# ---------------------------------------------------------------------------
# what this slice does not port raises, naming its ROADMAP item
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [0, -3])
def test_batch_size_below_one_is_refused_as_by_the_reference(batch_size):
    for cfg in (KMeansConfig, JK.KMeansConfig):
        with pytest.raises(ValueError, match="batch_size"):
            cfg(k=2, batch_size=batch_size)


@pytest.mark.parametrize("offline", [None, "on_demand"])
def test_minibatch_on_demand_raises_the_reference_error(offline):
    """Minibatch Lloyd needs the planned offline phase: with the on-demand
    dealer both packages raise the same ValueError at fit time."""
    x = _blobs(24, 4, 2, seed=1)
    kw = {} if offline is None else {"offline": offline}
    errors = []
    for km in (SecureKMeans(KMeansConfig(k=2, iters=1, batch_size=8,
                                         backend="torch", device="cpu",
                                         **kw)),
               JK.SecureKMeans(JK.KMeansConfig(k=2, iters=1, batch_size=8,
                                               backend="xla", **kw))):
        with pytest.raises(ValueError, match="offline='pooled'") as exc:
            km.fit(x[:, :2], x[:, 2:])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_config_validation():
    for iters in (0, -3):
        with pytest.raises(ValueError, match="iters"):
            KMeansConfig(k=3, iters=iters)
    with pytest.raises(ValueError, match="offline"):
        KMeansConfig(k=3, offline="later")
    with pytest.raises(ValueError, match="partition"):
        KMeansConfig(k=3, partition="diagonal")
    cfg = KMeansConfig(k=3)
    assert (cfg.backend, cfg.device) == ("cuda", "cuda")
