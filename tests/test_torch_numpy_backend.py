"""The port's host ring backend (backend="numpy", device="cpu") against the
JAX package's NumpyBackend, word for word: each op (wrap-heavy words, ELL
tiles, CSR matrices that are sparse, skewed, empty or of a width that is no
multiple of the tile), whole dense and sparse fits in both partitions, on
demand and pooled (shares, dealer counters, CommLog bytes and rounds per
tag and phase, he_seconds), the refusals of the reference's
tests/test_pipeline.py and tests/test_serve.py, and the scoring service over
a numpy-backend model, which runs no program. Every comparison is exact."""
import numpy as np
import pytest
import torch

from repro.core import backend as JB
from repro.core import kmeans as JK
from repro.core import sparse as JS
from repro.kernels import spmm as jspmm
from repro.serve import ScoringService as JScoringService
from repro_torch.core import backend as B
from repro_torch.core import ring
from repro_torch.core import sparse as S
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.kernels import spmm
from repro_torch.launch import kmeans_step as KS
from repro_torch.serve import ScoringService

NB, JNB, TB = B.NumpyBackend(), JB.NumpyBackend(), B.TorchBackend()


def _words(rng, shape, wrap: bool = True) -> np.ndarray:
    """Uniform uint64 words; `wrap` sets the top bit of every other word, so
    the products and sums wrap mod 2^64 all the time."""
    w = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    if wrap:
        w.reshape(-1)[::2] |= np.uint64(1 << 63)
    return w


def _t(words: np.ndarray) -> torch.Tensor:
    return ring.from_u64_numpy(words)


def _u64(t: torch.Tensor) -> np.ndarray:
    assert t.device.type == "cpu" and t.dtype == torch.int64
    return ring.to_u64_numpy(t)


# ---------------------------------------------------------------------------
# resolution and the ops
# ---------------------------------------------------------------------------

def test_get_backend_resolves_numpy_but_auto_never_does():
    nb = B.get_backend("numpy", "cpu")
    assert isinstance(nb, B.NumpyBackend) and nb.name == "numpy"
    assert B.get_backend("numpy") is nb
    assert B.get_backend("auto", "cpu").name == "torch"
    assert B.get_backend(None, "cpu").name == "torch"
    assert B.get_backend(nb) is nb
    with pytest.raises(ValueError, match="'numpy'"):
        B.get_backend("bogus", "cpu")


@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (7, 5, 3), (33, 17, 9),
                                   (64, 130, 10)])
def test_ring_mm_equals_reference(n, d, k):
    rng = np.random.default_rng(n * 100 + d)
    a, b = _words(rng, (n, d)), _words(rng, (d, k))
    got = _u64(NB.ring_mm(_t(a), _t(b)))
    np.testing.assert_array_equal(got, JNB.ring_mm(a, b))
    np.testing.assert_array_equal(got, _u64(TB.ring_mm(_t(a), _t(b))))


@pytest.mark.parametrize("zero_frac", [0.0, 0.5, 0.9, 1.0])
def test_ring_spmm_on_ell_tiles_equals_reference(zero_frac):
    """The blocked-ELL op on the packing of a CSR matrix (the port's and the
    reference's csr_to_ell give the same tiles), padded slots masked."""
    rng = np.random.default_rng(int(zero_frac * 10))
    n, d, k, bm, bk = 37, 70, 6, 4, 16
    x = _words(rng, (n, d)) * (rng.random((n, d)) >= zero_frac)
    csr = S.CSRMatrix.from_dense(x)
    ell = spmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape,
                          bm=bm, bk=bk)
    jell = jspmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape,
                            bm=bm, bk=bk)
    for a, b in zip(ell, jell):
        np.testing.assert_array_equal(a, b)
    blocks, idx, counts = ell
    y = _words(rng, (-(-d // bk) * bk, k))
    args = (_t(blocks), torch.from_numpy(idx), torch.from_numpy(counts),
            _t(y))
    got = _u64(NB.ring_spmm(*args))
    np.testing.assert_array_equal(got, JNB.ring_spmm(blocks, idx, counts, y))
    np.testing.assert_array_equal(got, _u64(TB.ring_spmm(*args)))
    # the product itself: padded tiles and padded y rows add nothing
    want = (x.astype(object) @ y[:d].astype(object)) % (1 << 64)
    np.testing.assert_array_equal(got[:n], want.astype(np.uint64))


def _csr_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name))
    if name == "sparse90":
        x = _words(rng, (40, 24)) * (rng.random((40, 24)) >= 0.9)
    elif name == "skewed":
        # one dense row block; every other row holds one entry
        x = np.zeros((96, 300), np.uint64)
        x[8:16] = _words(rng, (8, 300))
        x[np.arange(96), rng.integers(0, 300, 96)] = _words(rng, 96)
    elif name == "empty":
        x = np.zeros((9, 5), np.uint64)
    else:  # "ragged_y": Y has 130 rows, no multiple of the tile width 128
        x = _words(rng, (20, 130)) * (rng.random((20, 130)) >= 0.5)
    return x


@pytest.mark.parametrize("name", ["sparse90", "skewed", "empty", "ragged_y"])
def test_ring_spmm_csr_equals_reference_and_packs_no_ell(name):
    """The chunked CSR loop equals the reference's and the ELL route's
    words, and packs no ELL: the memo stays empty and ELL_PACK_SECONDS does
    not move."""
    x = _csr_case(name)
    rng = np.random.default_rng(7)
    y = _words(rng, (x.shape[1], 5))
    csr = S.CSRMatrix.from_dense(x)
    assert (csr.nnz == 0) == (name == "empty")
    before = S.ELL_PACK_SECONDS
    got = _u64(NB.ring_spmm_csr(csr, _t(y)))
    assert S.ELL_PACK_SECONDS == before
    assert "_ell" not in csr.__dict__
    assert got.shape == (x.shape[0], 5)
    np.testing.assert_array_equal(
        got, JNB.ring_spmm_csr(JS.CSRMatrix.from_dense(x), y))
    ell_route = TB.ring_spmm_csr(S.CSRMatrix.from_dense(x), _t(y))
    np.testing.assert_array_equal(got, _u64(ell_route))


@pytest.mark.parametrize("shape", [(5, 3), (17,)], ids=["2d", "1d"])
@pytest.mark.parametrize("party0", [True, False], ids=["party0", "party1"])
def test_ks_fused_equals_reference(party0, shape):
    rng = np.random.default_rng(11 if party0 else 12)
    flat = [_words(rng, shape) for _ in range(6)]
    lvl = [_words(rng, (len(B.KS_LEVELS), 2, *shape)) for _ in range(5)]
    want = JNB.ks_fused(*flat, *lvl, party0=party0)
    got = _u64(NB.ks_fused(*map(_t, flat + lvl), party0=party0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _u64(TB.ks_fused(*map(_t, flat + lvl), party0=party0)))


def test_numpy_backend_refuses_device_tensors():
    """Words that are not on the host raise rather than being copied to it
    (the card's own check, on CUDA tensors, is in tests/test_torch_cuda.py;
    meta tensors take the same branch here)."""
    m = torch.zeros((4, 4), dtype=torch.int64, device="meta")
    c = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        NB.ring_mm(m, c)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        NB.ring_mm(c, m)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        NB.ring_spmm_csr(S.CSRMatrix.from_dense(np.eye(4, dtype=np.uint64)),
                         m)
    lvl = torch.zeros((len(B.KS_LEVELS), 2, 4, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        NB.ks_fused(c, c, c, c, c, m, lvl, lvl, lvl, lvl, lvl, party0=True)


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------

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


def _data(partition, sparse, n=48):
    return _split(_blobs(n, 4, 2, 11, 0.5 if sparse else 0.0), partition)


def _common(partition, sparse, offline):
    return dict(k=2, iters=2, partition=partition, sparse=sparse, seed=5,
                offline=offline)


def _assert_same_fit(rt, rj):
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
    if hasattr(rj.dealer, "remaining"):
        assert rt.dealer.remaining() == rj.dealer.remaining()


def _no_numpy_program() -> bool:
    caches = (KS._PROGRAM_CACHE, KS._BATCH_PROGRAM_CACHE, KS._FINALIZE_CACHE,
              KS._PREDICT_PROGRAM_CACHE)
    return not any("numpy" in key for c in caches for key in c)


COMBOS = [(p, s, o) for p in ("vertical", "horizontal")
          for s in (False, True) for o in ("on_demand", "pooled")]
IDS = [f"{p}-{'sparse' if s else 'dense'}-{o}" for p, s, o in COMBOS]


@pytest.mark.parametrize("partition,sparse,offline", COMBOS, ids=IDS)
def test_fit_equals_reference_numpy_fit(partition, sparse, offline):
    """The port's numpy fit is the reference's numpy fit: share words,
    dealer counters, CommLog per tag and phase, he_seconds. The pooled fit
    takes the eager loop and records no program."""
    a, b = _data(partition, sparse)
    common = _common(partition, sparse, offline)
    rj = JK.SecureKMeans(JK.KMeansConfig(backend="numpy", **common)) \
        .fit(a, b)
    rt = SecureKMeans(KMeansConfig(backend="numpy", device="cpu",
                                   **common)).fit(a, b)
    _assert_same_fit(rt, rj)
    assert (rt.he_seconds > 0.0) == sparse
    assert _no_numpy_program()


@pytest.mark.parametrize("partition,sparse,offline", COMBOS, ids=IDS)
def test_numpy_fit_equals_torch_fit(partition, sparse, offline):
    """The host backend and the plain PyTorch backend (whose pooled fit runs
    the S1/S3 programs) give the same words, counters and traffic."""
    a, b = _data(partition, sparse)
    common = _common(partition, sparse, offline)
    rn, rt = (SecureKMeans(KMeansConfig(backend=name, device="cpu",
                                        **common)).fit(a, b)
              for name in ("numpy", "torch"))
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(rn, field)[i], getattr(rt, field)[i])
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rn.dealer, attr) == getattr(rt.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rn.log.by_tag(phase) == rt.log.by_tag(phase), phase
    assert rn.he_seconds == rt.he_seconds


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_minibatch_refused_as_by_the_reference():
    """tests/test_pipeline.py:test_minibatch_requires_planned_offline on the
    port: minibatch Lloyd runs on the program fast path only."""
    x = _blobs(24, 4, 2, seed=1)
    with pytest.raises(ValueError, match=r"fast path.*numpy is host-only"):
        SecureKMeans(KMeansConfig(k=2, iters=1, batch_size=8,
                                  offline="pooled", backend="numpy",
                                  device="cpu")).fit(x[:, :2], x[:, 2:])
    with pytest.raises(ValueError, match=r"fast path.*numpy is host-only"):
        JK.SecureKMeans(JK.KMeansConfig(k=2, iters=1, batch_size=8,
                                        offline="pooled", backend="numpy")) \
            .fit(x[:, :2], x[:, 2:])


_MODELS = {}


def _models(partition="vertical", sparse=False):
    """(reference model, port model), both fitted with backend="numpy" on
    the same data, once each."""
    key = (partition, sparse)
    if key not in _MODELS:
        x = _blobs(48, 4, 2, 3, 0.5 if sparse else 0.0)
        a, b = _split(x, partition)
        common = dict(k=2, iters=2, seed=5, partition=partition,
                      sparse=sparse)
        jk = JK.SecureKMeans(JK.KMeansConfig(backend="numpy", **common))
        jk.fit(a, b)
        tk = SecureKMeans(KMeansConfig(backend="numpy", device="cpu",
                                       **common))
        tk.fit(a, b)
        _MODELS[key] = (jk, tk, a, b)
    return _MODELS[key]


def test_predict_compiled_true_refused_and_auto_goes_eager():
    """tests/test_serve.py:test_predict_compiled_true_rejects_unsupported_
    configs on the port: compiled=True names the numpy backend; the default
    path scores eagerly, word for word the reference's."""
    jk, tk, a, b = _models()
    with pytest.raises(ValueError, match="numpy backend"):
        tk.predict(a, b, compiled=True)
    with pytest.raises(ValueError, match="numpy backend"):
        jk.predict(a, b, compiled=True)
    for fn in ("predict", "score"):
        pt, pj = getattr(tk, fn)(a, b), getattr(jk, fn)(a, b)
        got = shares_to_numpy(pt.assignment)
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(pj.assignment[i], np.uint64))
        assert pt.log.by_tag("online") == pj.log.by_tag("online")
        if fn == "score":
            np.testing.assert_array_equal(pt.scores_plain(),
                                          pj.scores_plain())
    assert _no_numpy_program()


def test_predict_prepare_refused():
    jk, tk, a, b = _models()
    with pytest.raises(ValueError, match="numpy-backend"):
        tk.predict_prepare(a, b)
    with pytest.raises(ValueError, match="numpy-backend"):
        jk.predict_prepare(a, b)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_config_refuses_numpy_on_a_cuda_device(device):
    """No hidden host path: shares on the card never go to the host backend
    (the check needs no GPU)."""
    with pytest.raises(ValueError, match="device='cpu'"):
        KMeansConfig(k=2, backend="numpy", device=device)
    KMeansConfig(k=2, backend="numpy", device="cpu")


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition,sparse", [
    ("vertical", False), ("horizontal", False), ("vertical", True)])
def test_service_over_numpy_model_answers_as_eager_score(partition, sparse):
    """A ScoringService over a numpy-backend model answers as the
    reference's service over its numpy model, label for label and score for
    score, each request as the eager `score` labels it, and warms no
    scoring program."""
    jk, tk, _, _ = _models(partition, sparse)
    KS.clear_program_cache()
    kw = dict(rungs=(8, 16), with_scores=True, d_a=2, d_b=2,
              provision_copies=2)
    js, ts = JScoringService(jk, **kw), ScoringService(tk, **kw)
    reqs = []
    for i, m in enumerate((3, 5, 9, 2, 20)):
        qa, qb = _split(_blobs(m, 4, 2, 100 + i, 0.5 if sparse else 0.0),
                        partition)
        reqs.append((qa, qb))
        js.submit(qa, qb)
        ts.submit(qa, qb)
    out_j, out_t = js.drain(), ts.drain()
    assert not KS._PREDICT_PROGRAM_CACHE
    assert [r.request_id for r in out_t] == [r.request_id for r in out_j]
    for a, b, (qa, qb) in zip(out_t, out_j, reqs):
        assert a.error is None and b.error is None and a.rows == b.rows
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.labels,
                                      tk.score(qa, qb).labels_plain())
    sj, st = js.stats.as_dict(), ts.stats.as_dict()
    for k in ("requests", "rows", "padded_rows", "launches",
              "triples_per_request", "bytes_per_request"):
        assert st[k] == sj[k], k
