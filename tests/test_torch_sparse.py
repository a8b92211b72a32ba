"""The port's sparse slice (Protocol 2) on the CPU against the JAX package,
word for word: CSR and HE2SS layout helpers, the blocked-ELL packers and
product (`kernels/spmm.py` plain version against the reference's `xla` and
`numpy` backends), `secure_sparse_matmul` on all three paths, and whole
sparse fits against `SecureKMeans(..., sparse=True, backend="xla")`.

Tolerance everywhere: exact equality of uint64 words, of counters and of
the float `he_seconds` (both packages sum the same terms in the same
order). The reference's Pallas spmm does not run on the installed JAX, so
it is never the oracle here."""
import functools

import numpy as np
import pytest
import torch

from repro.core import he as jhe
from repro.core import kmeans as JK
from repro.core import protocol as JP
from repro.core import sparse as JS
from repro.core.backend import NumpyBackend, XlaBackend
from repro.kernels import spmm as jspmm
from repro_torch.core import he as the
from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core import sparse as S
from repro_torch.core.backend import TorchBackend
from repro_torch.core.channel import LAN
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.kernels import spmm

RNG = np.random.default_rng(41)


def _t(x):
    return ring.from_u64_numpy(x)


def _sparse_words(shape, sparsity, wrap_heavy=False):
    if wrap_heavy:        # every word >= 2^63: products overflow always
        x = np.uint64(0xFFFFFFFFFFFFFFFF) - RNG.integers(
            0, 1 << 62, shape, dtype=np.uint64)
    else:
        x = RNG.integers(1, 1 << 64, shape, dtype=np.uint64)
    return x * (RNG.random(shape) >= sparsity).astype(np.uint64)


# ---------------------------------------------------------------------------
# CSRMatrix and the HE2SS layout helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [0.0, 0.7, 0.97, 1.0])
@pytest.mark.parametrize("shape", [(13, 9), (1, 40), (64, 3)])
def test_csr_matches_reference(shape, sparsity):
    x = _sparse_words(shape, sparsity)
    mine, ref = S.CSRMatrix.from_dense(x), JS.CSRMatrix.from_dense(x)
    for a, b in ((mine, ref), (mine.transpose(), ref.transpose())):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
        assert a.shape == b.shape and a.nnz == b.nnz
        np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    np.testing.assert_array_equal(mine.to_dense(), x)
    np.testing.assert_array_equal(mine.transpose().to_dense(), x.T)
    assert mine.transpose() is mine.transpose()            # memoized
    real = RNG.normal(size=shape) * (RNG.random(shape) >= sparsity)
    for f in (ring.F, 12):
        a, b = S.CSRMatrix.from_dense_real(real, f), \
            JS.CSRMatrix.from_dense_real(real, f)
        np.testing.assert_array_equal(a.to_dense(), b.to_dense())
        np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("k", [1, 3, 8, 17])
@pytest.mark.parametrize("plain_bits", [509, 1365])
def test_he2ss_layout_helpers_match_reference(k, plain_bits):
    for d in (1, 2, 5, 128, 1000):
        vb = S.default_value_bits(d)
        assert vb == JS.default_value_bits(d)
        lay = S.he2ss_layout(k, plain_bits, vb)
        assert dataclass_tuple(lay) == dataclass_tuple(
            JS.he2ss_layout(k, plain_bits, vb))
        for n, nnz, ne in ((1, 0, 0), (37, 120, 30), (1000, 9000, 998)):
            assert lay.n_wire(n) == JS.he2ss_layout(k, plain_bits,
                                                    vb).n_wire(n)
            assert S.he2ss_op_counts(n, d, nnz, ne, lay) == \
                JS.he2ss_op_counts(n, d, nnz, ne, JS.he2ss_layout(
                    k, plain_bits, vb))
            assert S.sparse_matmul_comm_bytes(n, d, k, 256, plain_bits) == \
                JS.sparse_matmul_comm_bytes(n, d, k, 256, plain_bits)
            assert S.dense_ss_matmul_comm_bytes(n, d, k) == \
                JS.dense_ss_matmul_comm_bytes(n, d, k)


def dataclass_tuple(lay):
    return (lay.value_bits, lay.slot_bits, lay.slots, lay.g, lay.ngrp,
            lay.rpc)


@pytest.mark.parametrize("mask_bits", [64, 100, 141, 192])
def test_mask_words_match_reference(mask_bits):
    for seed, n, k in ((0, 3, 2), (12345, 17, 5)):
        a = S._mask_words(seed, n, k, mask_bits)
        b = JS._mask_words(seed, n, k, mask_bits)
        np.testing.assert_array_equal(a, b)
        assert S._mask_int(a, n - 1, k - 1) == JS._mask_int(b, n - 1, k - 1)
        assert S._mask_int(a, 0, 0) < 1 << mask_bits


def test_he_copy_matches_reference():
    assert the.KAPPA_STAT == jhe.KAPPA_STAT
    assert the.OU_COST_S == jhe.OU_COST_S
    mine, ref = the.SimulatedPHE(), jhe.SimulatedPHE()
    assert (mine.name, mine.plain_bits, mine.ct_bytes, mine.modulus) == \
        (ref.name, ref.plain_bits, ref.ct_bytes, ref.modulus)
    ct = 3 * mine.encrypt(5) + mine.encrypt(7).add_plain(2)
    assert mine.decrypt(ct) == 24
    p, q = _primes()
    he = _paillier(the, p, q)
    c = 4 * he.encrypt(10) + he.encrypt(3).add_plain(5)
    assert he.decrypt(c) == 48
    assert he.plain_bits == _paillier(jhe, p, q).plain_bits


# ---------------------------------------------------------------------------
# blocked-ELL packers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blk", [(8, 128), (4, 16)])
@pytest.mark.parametrize("sparsity", [0.0, 0.7, 0.97, 1.0])
def test_ell_packers_match_reference(blk, sparsity):
    bm, bk = blk
    x = _sparse_words((37, 150), sparsity)
    csr = S.CSRMatrix.from_dense(x)
    for mine, ref in (
            (spmm.dense_to_ell(x, bm=bm, bk=bk),
             jspmm.dense_to_ell(x, bm=bm, bk=bk)),
            (spmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape,
                             bm=bm, bk=bk),
             jspmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape,
                              bm=bm, bk=bk))):
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_csr_to_ell_empty_matrix_matches_reference():
    csr = S.CSRMatrix.from_dense(np.zeros((20, 7), np.uint64))
    mine = spmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape)
    ref = jspmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine[0].shape == (3, 1, 8, 128) and not mine[2].any()


def test_csr_ell_is_memoized_per_device_and_tile():
    csr = S.CSRMatrix.from_dense(_sparse_words((30, 20), 0.5))
    before = S.ELL_PACK_SECONDS
    a = csr.ell(device="cpu")
    assert S.ELL_PACK_SECONDS > before
    assert csr.ell(bm=8, bk=128, device=torch.device("cpu")) is a
    b = csr.ell(bm=4, bk=16)
    assert b is not a and b[0].shape[2:] == (4, 16)
    blocks, idx, counts = a
    assert (blocks.dtype, idx.dtype, counts.dtype) == \
        (torch.int64, torch.int32, torch.int32)
    ref = jspmm.csr_to_ell(csr.indptr, csr.indices, csr.data, csr.shape)
    np.testing.assert_array_equal(ring.to_u64_numpy(blocks), ref[0])


# ---------------------------------------------------------------------------
# the product: plain version against the reference backends
# ---------------------------------------------------------------------------

def _ell_case(sparsity, k, wrap_heavy=False, empty_rows=False,
              garbage=False, n=45, d=300, bm=8, bk=128):
    x = _sparse_words((n, d), sparsity, wrap_heavy)
    if empty_rows:
        x[8:24] = 0                   # row blocks 1 and 2: counts == 0
    csr = S.CSRMatrix.from_dense(x)
    blocks, idx, counts = spmm.csr_to_ell(csr.indptr, csr.indices,
                                          csr.data, csr.shape, bm=bm, bk=bk)
    if garbage:                       # words in padded slots must not count
        nrb, maxb = idx.shape
        pad = np.arange(maxb)[None, :] >= counts[:, None]
        blocks[pad] = RNG.integers(0, 1 << 64, (int(pad.sum()), bm, bk),
                                   dtype=np.uint64)
    d_pad = -(-d // bk) * bk
    y = _sparse_words((d_pad, k), 0.0, wrap_heavy)
    return x, blocks, idx, counts, y


ELL_CASES = [dict(sparsity=0.0, k=3), dict(sparsity=0.7, k=1),
             dict(sparsity=0.97, k=8), dict(sparsity=0.7, k=3,
                                            wrap_heavy=True),
             dict(sparsity=0.7, k=3, empty_rows=True),
             dict(sparsity=0.9, k=3, garbage=True, empty_rows=True),
             dict(sparsity=0.5, k=5, bm=4, bk=16),
             dict(sparsity=1.0, k=3)]


@pytest.mark.parametrize("case", ELL_CASES,
                         ids=["dense_k3", "s0.7_k1", "s0.97_k8", "wrap_heavy",
                              "empty_rows", "garbage_pad", "bm4_bk16",
                              "all_empty"])
def test_spmm_ell_plain_matches_reference(case):
    x, blocks, idx, counts, y = _ell_case(**case)
    want = NumpyBackend().ring_spmm(blocks, idx, counts, y)
    np.testing.assert_array_equal(
        np.asarray(XlaBackend().ring_spmm(blocks, idx, counts, y), np.uint64),
        want)
    args = (_t(blocks), torch.from_numpy(idx), torch.from_numpy(counts),
            _t(y))
    before = spmm.LAUNCHES
    for got in (spmm.spmm_ell_plain(*args), spmm.spmm_ell(*args),
                TorchBackend().ring_spmm(*args)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(ring.to_u64_numpy(got), want)
    assert spmm.LAUNCHES == before                   # the CPU launches nothing
    # and the dense product mod 2^64 of the unpadded rows
    dense = np.einsum("ij,jk->ik", x, y[: x.shape[1]], dtype=np.uint64,
                      casting="unsafe")
    np.testing.assert_array_equal(want[: x.shape[0]], dense)


def test_spmm_ell_plain_broadcast_form_equals_matmul_form():
    """The CUDA plain version's broadcast product, run on the CPU."""
    _, blocks, idx, counts, y = _ell_case(0.6, 4, wrap_heavy=True)
    tb, ty = _t(blocks), _t(y)
    y_tiles = ty.reshape(-1, 128, 4)[torch.from_numpy(idx).long()]
    assert torch.equal(spmm._broadcast_tile_matmul(tb, y_tiles),
                       tb @ y_tiles)


def test_spmm_ell_rejects_other_dtypes_and_shapes():
    """Mixed and unsupported word types are refused; float32, int32 and
    int64 blocks with y of the same type are taken."""
    _, blocks, idx, counts, y = _ell_case(0.5, 3)
    i, c = torch.from_numpy(idx), torch.from_numpy(counts)
    with pytest.raises(TypeError, match="one word type"):
        spmm.spmm_ell(_t(blocks).float(), i, c, _t(y))
    with pytest.raises(TypeError, match="one word type"):
        spmm.spmm_ell(_t(blocks).to(torch.int32), i, c, _t(y))
    with pytest.raises(TypeError, match="one word type"):
        spmm.spmm_ell(_t(blocks).double(), i, c, _t(y).double())
    small_b, small_y = _t(blocks) & 0xF, _t(y) & 0xF      # exact in f32
    for dtype in (torch.float32, torch.int32):
        got = spmm.spmm_ell(small_b.to(dtype), i, c, small_y.to(dtype))
        assert got.dtype == dtype
        assert torch.equal(got.long(),
                           spmm.spmm_ell_plain(small_b, i, c, small_y))
    with pytest.raises(ValueError, match="multiple"):
        spmm.spmm_ell(_t(blocks), i, c, _t(y)[:-1])
    with pytest.raises(ValueError):
        spmm.spmm_ell(_t(blocks), i[:, :0], c, _t(y))


@pytest.mark.parametrize("shape", [(64, 200, 3), (10, 5, 1), (130, 40, 8)])
def test_ring_spmm_csr_matches_reference(shape):
    n, d, k = shape
    x = _sparse_words((n, d), 0.8)
    y = _sparse_words((d, k), 0.0)
    want = np.asarray(XlaBackend().ring_spmm_csr(JS.CSRMatrix.from_dense(x),
                                                 y), np.uint64)
    csr = S.CSRMatrix.from_dense(x)
    for yt in (_t(y), _t(np.ascontiguousarray(y.T)).T):   # a transposed view
        got = TorchBackend().ring_spmm_csr(csr, yt)
        np.testing.assert_array_equal(ring.to_u64_numpy(got), want)


# ---------------------------------------------------------------------------
# secure_sparse_matmul on its three paths
# ---------------------------------------------------------------------------

def _next_prime(start: int) -> int:
    c = start | 1
    while not the._is_probable_prime(c):
        c += 2
    return c


@functools.lru_cache(maxsize=None)
def _primes() -> tuple[int, int]:
    """Two fixed 256-bit primes, so both packages hold one Paillier key."""
    return (_next_prime((1 << 255) + 0x1234567),
            _next_prime((1 << 255) + (0x7654321 << 20)))


def _paillier(mod, p, q):
    """A Paillier backend of package `mod` on the fixed primes p, q."""
    he = mod.Paillier.__new__(mod.Paillier)
    he.key_bits, he.name = 512, "paillier"
    he.pk = mod.PaillierPublicKey(p * q)
    he.sk = mod.PaillierPrivateKey(he.pk, p, q)
    return he


def _ssm_both(he_pair, *, batched=True, trunc_f=None, n=12, d=7, k=3,
              sparsity=0.6, tag="S1", seed=3):
    x = _sparse_words((n, d), sparsity)
    x[2] = 0                                    # an all-empty row
    y = RNG.integers(0, 1 << 64, (d, k), dtype=np.uint64)
    jctx, tctx = JP.make_ctx(seed, backend="xla"), \
        P.make_ctx(seed, backend="torch", device="cpu")
    jctx.tag = tctx.tag = tag
    kw = dict(trunc_f=trunc_f, time_model=jhe.OU_COST_S, batched=batched)
    zj = JS.secure_sparse_matmul(jctx, JS.CSRMatrix.from_dense(x), y,
                                 he_pair[0], **kw)
    ops_j = dict(JS.secure_sparse_matmul.last_op_counts)
    zt = S.secure_sparse_matmul(tctx, S.CSRMatrix.from_dense(x), _t(y),
                                he_pair[1], **kw)
    ops_t = dict(S.secure_sparse_matmul.last_op_counts)
    got = shares_to_numpy(zt)
    for i in (0, 1):
        np.testing.assert_array_equal(got[i], np.asarray(zj[i], np.uint64))
    for phase in ("online", "offline"):
        assert tctx.log.by_tag(phase) == jctx.log.by_tag(phase)
    assert tctx.he_seconds == jctx.he_seconds > 0.0
    assert ops_t == ops_j
    # the shares reconstruct X @ Y mod 2^64 (before truncation)
    if not trunc_f:
        want = np.einsum("ij,jk->ik", x, y, dtype=np.uint64, casting="unsafe")
        np.testing.assert_array_equal(got[0] + got[1], want)
    return tctx


@pytest.mark.parametrize("trunc_f", [None, ring.F])
def test_secure_sparse_matmul_ou_sim_matches_reference(trunc_f):
    ctx = _ssm_both((jhe.SimulatedPHE(), the.SimulatedPHE()),
                    trunc_f=trunc_f)
    assert "S1/he_time" not in ctx.log.by_tag("online")


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("k", [3, 20])
def test_secure_sparse_matmul_exact_paths_match_reference(batched, k):
    """The batched and legacy HE paths, deterministic through a simulated
    backend that is not "ou-sim"; k=20 packs several column groups."""
    ctx = _ssm_both((jhe.SimulatedPHE(name="sim-exact"),
                     the.SimulatedPHE(name="sim-exact")),
                    batched=batched, k=k, tag="S3")
    assert "S3/he_time" in ctx.log.by_tag("online")


@pytest.mark.parametrize("batched", [True, False])
def test_secure_sparse_matmul_real_paillier_matches_reference(batched):
    p, q = _primes()
    _ssm_both((_paillier(jhe, p, q), _paillier(the, p, q)), batched=batched,
              n=6, d=4, k=2, trunc_f=None)


# ---------------------------------------------------------------------------
# whole sparse fits
# ---------------------------------------------------------------------------

def _sparse_blobs(n, d, k, seed, sparsity=0.6):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.normal(0, 0.3, (n, d))
    return x * (rng.random((n, d)) >= sparsity)


def _sparse_fit_both(partition, vectorized=True, tol=None, he=None, n=48,
                     iters=2, k=3, f=ring.F):
    x = _sparse_blobs(n, 6, k, seed=13)
    a, b = (x[:, :3], x[:, 3:]) if partition == "vertical" else \
        (x[:20], x[20:])
    common = dict(k=k, iters=iters, partition=partition, seed=5, f=f,
                  vectorized=vectorized, tol=tol, sparse=True)
    rj = JK.SecureKMeans(JK.KMeansConfig(
        backend="xla", he_backend=he[0] if he else None, **common)).fit(a, b)
    rt = SecureKMeans(KMeansConfig(
        backend="torch", device="cpu", he_backend=he[1] if he else None,
        **common)).fit(a, b)
    return rj, rt


def _assert_sparse_fit_identical(rj, rt):
    for field in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(rt, field))
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(getattr(rj, field)[i], np.uint64))
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(rj.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == rj.log.by_tag(phase), phase
    assert rt.he_seconds == rj.he_seconds > 0.0
    assert rt.iters_run == rj.iters_run
    np.testing.assert_array_equal(rt.labels_plain(), rj.labels_plain())


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
@pytest.mark.parametrize("vectorized", [True, False])
def test_sparse_fit_bit_exact_vs_reference(partition, vectorized):
    rj, rt = _sparse_fit_both(partition, vectorized=vectorized)
    _assert_sparse_fit_identical(rj, rt)


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_sparse_fit_with_tol_bit_exact_vs_reference(partition):
    rj, rt = _sparse_fit_both(partition, tol=1e-2, f=16, k=2)
    _assert_sparse_fit_identical(rj, rt)
    assert rt.log.by_tag("online")["CSC"] == rj.log.by_tag("online")["CSC"]


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_sparse_fit_exact_he_backend_bit_exact_vs_reference(partition):
    """A non-"ou-sim" HE backend runs the batched Protocol-2 path."""
    rj, rt = _sparse_fit_both(partition, n=24, iters=1,
                              he=(jhe.SimulatedPHE(name="sim-exact"),
                                  the.SimulatedPHE(name="sim-exact")))
    _assert_sparse_fit_identical(rj, rt)
    assert any(t.endswith("/he_time") for t in rt.log.by_tag("online"))


def test_sparse_fit_wan_lan_estimate_counts_he_seconds():
    rj, rt = _sparse_fit_both("vertical", iters=1)
    est_t, est_j = rt.wan_lan_estimate(LAN), rj.wan_lan_estimate(LAN)
    assert est_t["online_s"] - rt.online_seconds == pytest.approx(
        est_j["online_s"] - rj.online_seconds, rel=1e-12)
    assert est_t["online_s"] >= rt.he_seconds > 0.0


def test_sparse_config_defaults():
    cfg = KMeansConfig(k=2, sparse=True)
    assert cfg.he_backend is None
    assert SecureKMeans(cfg).he.name == "ou-sim"
    he = the.SimulatedPHE(name="sim-exact")
    assert SecureKMeans(KMeansConfig(k=2, sparse=True,
                                     he_backend=he)).he is he
