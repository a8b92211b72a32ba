"""The port's kernel API (`repro_torch.kernels.ops` and `.ref`) on the CPU
against the JAX package's `repro.kernels.ops` (Pallas kernels in interpret
mode, as tests/test_kernels.py runs them) and `repro.kernels.ref`: the same
numpy inputs from a seed through both. Ring words must be equal; float32
agrees to rtol 1e-5, atol 1e-3, the reference tests' tolerance (the two
sides sum the same products in different orders).

The reference's Pallas spmm fails on the installed JAX (`pl.load` and
`pl.store` are gone), so the spmm cases are held to `repro.kernels.ref.
spmm_ell`, numpy and the reference's `NumpyBackend.ring_spmm`, never to its
`ops.spmm`. The kernels themselves run on the GPU only
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import NumpyBackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spmm import dense_to_ell as j_dense_to_ell
from repro_torch.core import ring
from repro_torch.kernels import argmin, esd, modmatmul, ops, ref, spmm

RNG = np.random.default_rng(13)


def _u32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32).view(np.int32))


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# ring_matmul: int32 words mod 2^32, int64 words mod 2^64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 128),
                                   (100, 50, 30), (1, 200, 7), (129, 129, 129)])
def test_ring_matmul_matches_reference(shape, bits):
    n, d, k = shape
    dtype = np.uint32 if bits == 32 else np.uint64
    a = RNG.integers(0, 1 << bits, (n, d), dtype=dtype)
    b = RNG.integers(0, 1 << bits, (d, k), dtype=dtype)
    want = np.asarray(jops.ring_matmul(jnp.asarray(a), jnp.asarray(b)))
    jfn = jref.modmatmul_u32 if bits == 32 else jref.modmatmul_u64
    np.testing.assert_array_equal(
        np.asarray(jfn(jnp.asarray(a), jnp.asarray(b))), want)
    if bits == 32:
        ta, tb, back = _u32(a), _u32(b), _as_u32
    else:
        ta, tb = ring.from_u64_numpy(a), ring.from_u64_numpy(b)
        back = ring.to_u64_numpy
    pfn = ref.modmatmul_u32 if bits == 32 else ref.modmatmul_u64
    for got in (ops.ring_matmul(ta, tb), pfn(ta, tb),
                modmatmul._broadcast_matmul(ta, tb)):
        assert got.dtype == ta.dtype
        np.testing.assert_array_equal(back(got), want)


def test_ring_matmul_u32_wraps_against_bigint_oracle():
    a = np.full((3, 40), 0xFFFFFFF0, np.uint32)
    b = RNG.integers(1 << 31, 1 << 32, (40, 2), dtype=np.uint32)
    got = _as_u32(ops.ring_matmul(_u32(a), _u32(b)))
    want = sum(int(a[1, t]) * int(b[t, 1]) for t in range(40))
    assert want >= 1 << 32
    assert int(got[1, 1]) == want % (1 << 32)


# ---------------------------------------------------------------------------
# fused ESD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128, 128), (300, 40, 5),
                                   (1000, 2, 2), (57, 129, 17)])
def test_esd_matches_reference(shape):
    n, d, k = shape
    x = RNG.normal(0, 3, (n, d)).astype(np.float32)
    mu = RNG.normal(0, 3, (k, d)).astype(np.float32)
    want = np.asarray(jops.esd(jnp.asarray(x), jnp.asarray(mu)))
    np.testing.assert_allclose(
        np.asarray(jref.esd(jnp.asarray(x), jnp.asarray(mu))), want,
        rtol=1e-5, atol=1e-3)
    tx, tmu = torch.from_numpy(x), torch.from_numpy(mu)
    for got in (ops.esd(tx, tmu), ref.esd(tx, tmu),
                ops.esd(tx.double(), tmu.double())):
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", [1, 5, 32, 33, 128, 200])
def test_esd_plan_picks_the_tile_by_k(k):
    tile = esd.plan(k)
    assert tile == (0 if k <= esd.SMALL_K else 1)
    assert esd.TILES[tile][1] >= 8


# ---------------------------------------------------------------------------
# argmin one-hot (the Pallas kernel's semantics)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 4), (1000, 7), (33, 2), (128, 256)])
def test_argmin_onehot_matches_reference(shape):
    d = RNG.normal(0, 10, shape).astype(np.float32)
    want = np.asarray(jops.argmin_onehot(jnp.asarray(d)))
    np.testing.assert_array_equal(
        np.asarray(jref.argmin_onehot(jnp.asarray(d))), want)
    for got in (ops.argmin_onehot(torch.from_numpy(d)),
                ref.argmin_onehot(torch.from_numpy(d))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


EDGE_ROWS = np.array([
    [3.0, 1.0, 1.0, 2.0],                 # tie: first minimum wins
    [0.0, -0.0, 1.0, 5.0],                # +0.0 first, -0.0 ties it
    [-0.0, 0.0, 0.0, 1.0],                # -0.0 first
    [2.0, 0.0, -0.0, -0.0],               # ties at columns 1-3
    [np.inf, np.inf, np.inf, np.inf],     # all +inf: column 0
    [np.inf, np.inf, 7.0, np.inf],
    [-np.inf, -np.inf, 0.0, 1.0],         # -inf ties
    [1.0, np.nan, 0.0, 2.0],              # NaN: all zeros
    [np.nan, np.nan, np.nan, np.nan],
    [np.inf, np.nan, np.inf, np.inf],
    [5.0, 5.0, 5.0, 5.0],
], np.float32)


def test_argmin_onehot_edge_rows_follow_the_pallas_kernel():
    """Ties, +-0, +inf rows and NaN rows equal the reference's Pallas
    `ops.argmin_onehot` exactly. A row holding a NaN is all zeros there
    (its minimum is NaN, which equals nothing), while the reference's own
    `ref.argmin_onehot` oracle (`jnp.argmin`) points at the NaN: the port
    follows the kernel, and its `ref.argmin_onehot` is the kernel's plain
    version."""
    want = np.asarray(jops.argmin_onehot(jnp.asarray(EDGE_ROWS)))
    got = ops.argmin_onehot(torch.from_numpy(EDGE_ROWS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want.argmax(1)[:7]) == [1, 0, 0, 1, 0, 2, 0]
    nan_rows = np.isnan(EDGE_ROWS).any(1)
    assert (want[nan_rows] == 0).all()
    assert (want[~nan_rows].sum(1) == 1).all()
    oracle = np.asarray(jref.argmin_onehot(jnp.asarray(EDGE_ROWS)))
    np.testing.assert_array_equal(oracle[~nan_rows], want[~nan_rows])
    assert (oracle[nan_rows].sum(1) == 1).all()           # the divergence
    assert oracle[7, 1] == 1 and oracle[8, 0] == 1 and oracle[9, 1] == 1
    np.testing.assert_array_equal(
        ref.argmin_onehot(torch.from_numpy(EDGE_ROWS)).numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 32, 33, 128, 300])
def test_argmin_group_is_a_power_of_two_covering_k(k):
    g = argmin.group(k)
    assert g & (g - 1) == 0 and 1 <= g <= 32
    assert g >= min(k, 32) and (g == 1 or g // 2 < k)


# ---------------------------------------------------------------------------
# blocked-ELL spmm: float32 and int32 words (and int64 at k > 8)
# ---------------------------------------------------------------------------

def _spmm_inputs(dtype, sparsity, n=64, d=512, k=8):
    mask = RNG.random((n, d)) >= sparsity
    if dtype == np.float32:
        x = (RNG.normal(0, 2, (n, d)) * mask).astype(np.float32)
        y = RNG.normal(0, 2, (d, k)).astype(np.float32)
    else:
        x = RNG.integers(0, 1 << 32, (n, d), dtype=np.uint32) * mask
        x = x.astype(np.uint32)
        y = RNG.integers(0, 1 << 32, (d, k), dtype=np.uint32)
    return x, y


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("dtype", [np.float32, np.uint32])
def test_spmm_from_dense_matches_reference(sparsity, dtype):
    x, y = _spmm_inputs(dtype, sparsity)
    n = x.shape[0]
    blocks, idx, counts = j_dense_to_ell(x)
    want_ref = np.asarray(jref.spmm_ell(jnp.asarray(blocks), jnp.asarray(idx),
                                        jnp.asarray(counts), jnp.asarray(y),
                                        n))
    ty = torch.from_numpy(y) if dtype == np.float32 else _u32(y)
    back = (lambda t: t.numpy()) if dtype == np.float32 else _as_u32
    tb = torch.from_numpy(blocks) if dtype == np.float32 else _u32(blocks)
    tidx, tcnt = torch.from_numpy(idx), torch.from_numpy(counts)
    gots = [ops.spmm_from_dense(x, ty), ops.spmm(tb, tidx, tcnt, ty)[:n],
            ref.spmm_ell(tb, tidx, tcnt, ty, n)]
    if dtype == np.float32:
        want = x.astype(np.float64) @ y
        np.testing.assert_allclose(want_ref, want, rtol=1e-5, atol=1e-3)
        for got in gots:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(back(got), want, rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(back(got), want_ref, rtol=1e-5,
                                       atol=1e-3)
    else:
        want = np.einsum("ij,jk->ik", x, y, dtype=np.uint32, casting="unsafe")
        np.testing.assert_array_equal(want_ref, want)
        for got in gots:
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(back(got), want)


def test_spmm_pads_y_rows_to_the_tile_width():
    """y with d = 300 rows (not a multiple of bk = 128): zero rows added."""
    x, y = _spmm_inputs(np.uint32, 0.6, n=20, d=300, k=3)
    want = np.einsum("ij,jk->ik", x, y, dtype=np.uint32, casting="unsafe")
    np.testing.assert_array_equal(_as_u32(ops.spmm_from_dense(x, _u32(y))),
                                  want)


def test_spmm_refuses_mixed_and_unsupported_words():
    x, y = _spmm_inputs(np.float32, 0.5, n=16, d=128, k=3)
    blocks, idx, counts = spmm.dense_to_ell(x)
    tb, ti, tc = (torch.from_numpy(blocks), torch.from_numpy(idx),
                  torch.from_numpy(counts))
    with pytest.raises(TypeError, match="one word type"):
        ops.spmm(tb, ti, tc, torch.from_numpy(y).to(torch.int64))
    with pytest.raises(TypeError, match="one word type"):
        ops.spmm(tb.double(), ti, tc, torch.from_numpy(y).double())
    with pytest.raises(TypeError, match="float32, int32 or int64"):
        ops.spmm_from_dense(x, torch.from_numpy(y).to(torch.int16))


@pytest.mark.parametrize("k", [1, 3, 8, 9, 10, 16, 17, 42, 128])
def test_spmm_column_groups_cover_k(k):
    """The k > MAX_K repair: y's columns are cut into groups of at most
    MAX_K, one launch each, that tile [0, k) in order."""
    groups = spmm.column_groups(k)
    assert len(groups) == -(-k // spmm.MAX_K)
    assert groups[0][0] == 0 and groups[-1][1] == k
    for (lo, hi), (lo2, _) in zip(groups, groups[1:]):
        assert hi == lo2
    widths = [hi - lo for lo, hi in groups]
    assert max(widths) <= spmm.MAX_K and max(widths) - min(widths) <= 1


def test_spmm_ell_k10_matches_numpy_backend():
    """The sparse fit's product at k = 10 (two column groups on the card)
    against the reference's host backend, word for word, whole and group
    by group."""
    x = RNG.integers(0, 1 << 64, (40, 300), dtype=np.uint64)
    x *= (RNG.random(x.shape) >= 0.8).astype(np.uint64)
    blocks, idx, counts = spmm.dense_to_ell(x)
    y = RNG.integers(0, 1 << 64, (384, 10), dtype=np.uint64)
    want = NumpyBackend().ring_spmm(blocks, idx, counts, y)
    args = (ring.from_u64_numpy(blocks), torch.from_numpy(idx),
            torch.from_numpy(counts))
    ty = ring.from_u64_numpy(y)
    got = spmm.spmm_ell(*args, ty)
    np.testing.assert_array_equal(ring.to_u64_numpy(got), want)
    np.testing.assert_array_equal(
        ring.to_u64_numpy(ops.spmm(*args, ty[:300])), want)
    groups = spmm.column_groups(10)
    assert len(groups) == 2
    parts = [spmm.spmm_ell_plain(*args, ty[:, lo:hi]) for lo, hi in groups]
    np.testing.assert_array_equal(ring.to_u64_numpy(torch.cat(parts, 1)),
                                  want)


# ---------------------------------------------------------------------------
# the slice as a whole: one plaintext Lloyd step through the API
# ---------------------------------------------------------------------------

def test_lloyd_step_through_the_api_matches_reference():
    """esd -> argmin_onehot -> C^T x -> new centroids, built only from the
    kernel API in both packages, on blobs with a clear margin (so the
    one-hot is exact). The reference's C^T x goes through `ref.spmm_ell`
    on its own ELL packing, since its Pallas spmm fails on the installed
    JAX."""
    n, d, k = 300, 6, 4
    centers = RNG.uniform(-20, 20, (k, d))
    lab = np.arange(n) % k
    x = (centers[lab] + RNG.normal(0, 0.5, (n, d))).astype(np.float32)
    mu = (centers + RNG.normal(0, 1.0, (k, d))).astype(np.float32)

    jd = jops.esd(jnp.asarray(x), jnp.asarray(mu))
    jc = np.asarray(jops.argmin_onehot(jd))
    blocks, idx, counts = j_dense_to_ell(jc.T.astype(np.float32))
    x_pad = np.pad(x, ((0, (-n) % 128), (0, 0)))
    jsum = np.asarray(jref.spmm_ell(jnp.asarray(blocks), jnp.asarray(idx),
                                    jnp.asarray(counts), jnp.asarray(x_pad),
                                    k))

    tx, tmu = torch.from_numpy(x), torch.from_numpy(mu)
    c = ops.argmin_onehot(ops.esd(tx, tmu))
    tsum = ops.spmm_from_dense(c.T, tx)

    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(c.numpy().argmax(1), lab)
    np.testing.assert_allclose(tsum.numpy(), jsum, rtol=1e-5, atol=1e-3)
    want = np.stack([x[lab == j].astype(np.float64).sum(0) for j in range(k)])
    np.testing.assert_allclose(tsum.numpy(), want, rtol=1e-5, atol=1e-3)
    sizes = c.sum(0).numpy()
    np.testing.assert_allclose(tsum.numpy() / sizes[:, None],
                               jsum / jc.sum(0)[:, None], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the API's routing
# ---------------------------------------------------------------------------

def test_ref_names_are_the_plain_versions():
    assert ref.modmatmul_u32 is modmatmul.ring_matmul_plain
    assert ref.modmatmul_u64 is modmatmul.ring_matmul_plain
    assert ref.esd is esd.esd_plain
    assert ref.argmin_onehot is argmin.argmin_onehot_plain
    assert ops.ring_matmul is modmatmul.ring_matmul


def test_api_launches_nothing_on_cpu():
    counters = [(modmatmul, "LAUNCHES"), (modmatmul, "LAUNCHES_U32"),
                (spmm, "LAUNCHES"), (spmm, "LAUNCHES_U32"),
                (spmm, "LAUNCHES_F32"), (esd, "LAUNCHES"),
                (argmin, "LAUNCHES")]
    before = [getattr(m, c) for m, c in counters]
    x = torch.from_numpy(RNG.normal(size=(20, 5)).astype(np.float32))
    c = ops.argmin_onehot(ops.esd(x, x[:3]))
    ops.spmm_from_dense(c.T, x)
    ops.spmm_from_dense(c.T, c.T.T.contiguous())
    ops.ring_matmul(c, c.T.contiguous())
    assert [getattr(m, n) for m, n in counters] == before


def test_kernel_wrappers_refuse_bad_operands():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        esd.esd(x, torch.zeros((2, 4)))
    with pytest.raises(TypeError):
        esd.esd(x.double(), x.double())
    with pytest.raises(ValueError):
        argmin.argmin_onehot(torch.zeros(5))
    with pytest.raises(TypeError):
        argmin.argmin_onehot(x.double())
