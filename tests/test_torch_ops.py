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
    p = esd.plan(42, k)
    assert p.tile == (0 if k <= esd.SMALL_K else 1)
    assert p.slots * p.col_tiles >= k
    assert p.slots >= 1 and p.dc % 4 == 0


# (d, k) -> (tile is narrow, slots, column tiles) at the boundaries k = 32/33
# (narrow/wide) and 128/129 (one/two column tiles), and the slots below
ESD_BOUNDARIES = [((42, 32), (True, 32, 1)), ((42, 33), (False, 128, 1)),
                  ((512, 128), (False, 128, 1)), ((512, 129), (False, 128, 2)),
                  ((256, 3), (True, 4, 1)), ((42, 5), (True, 8, 1)),
                  ((42, 8), (True, 8, 1)), ((42, 9), (True, 16, 1)),
                  ((1, 1), (True, 1, 1))]


@pytest.mark.parametrize("case", ESD_BOUNDARIES,
                         ids=[f"d{d}_k{k}" for (d, k), _ in ESD_BOUNDARIES])
def test_esd_plan_at_the_boundaries(case):
    (d, k), (narrow, slots, col_tiles) = case
    p = esd.plan(d, k)
    assert (p.tile == 0) == narrow
    assert (p.slots, p.col_tiles) == (slots, col_tiles)


@pytest.mark.parametrize("d", [0, 1, 3, 42, 64, 65, 129, 256, 512])
def test_esd_plan_cuts_d_evenly(d):
    """The narrow kernel's d chunks: a multiple of 4 words; all of d up to
    NARROW_ONE_CHUNK_D, else as many chunks of at most NARROW_DC as d
    needs, cut evenly."""
    p = esd.plan(d, 5)
    assert p.dc % 4 == 0 and p.dc >= 4
    chunks = -(-d // p.dc)
    if d <= esd.NARROW_ONE_CHUNK_D:
        assert chunks <= 1 and p.dc <= max(4, d + 3)
    else:
        assert p.dc <= esd.NARROW_DC
        assert chunks == -(-d // esd.NARROW_DC)
        assert d - (chunks - 1) * p.dc > 0        # no empty last chunk


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


# (nrb, maxb, bm, bk, k, word bytes): the fit's S1 / S3 at k = 3 and 10,
# the API's f32 / u32 ones, odd shapes, and the Lloyd drive's C^T x
PLAN_CASES = [(12500, 1, 8, 128, 3, 8), (16, 782, 8, 128, 3, 8),
              (12500, 1, 8, 128, 10, 8), (16, 782, 8, 128, 10, 8),
              (12500, 1, 8, 128, 3, 4), (16, 782, 8, 128, 3, 4),
              (7, 5, 8, 128, 5, 8), (1, 1, 8, 128, 1, 4),
              (600, 3, 8, 128, 16, 8), (2, 10_000, 8, 128, 9, 4),
              (33, 9, 4, 64, 5, 8), (40, 12, 8, 128, 17, 8)] + \
    [(nrb, 782, 8, 128, k, 4) for nrb in (1, 16) for k in (42, 256, 512, 1024)]\
    + [(16, 782, 8, 128, 512, 8), (16, 782, 8, 128, 1024, 8)]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["-".join(map(str, c)) for c in PLAN_CASES])
def test_spmm_plan_covers_every_slot_and_column_once(case):
    """One launch for any width of y: its blocks (`Plan.work`, the map the
    kernel decodes) cover every (row block, slot) once in each column tile
    and every column of y once; the 3-stage ring fits an H100's shared
    memory; long lists are split only where row blocks are too few."""
    nrb, maxb, bm, bk, k, word = case
    p = spmm.plan(nrb, maxb, bm, bk, k, word)
    assert p.wide == (k > spmm.NARROW_WIDTHS[-1])
    assert p.width in (spmm.WIDE_WIDTHS if p.wide else spmm.NARROW_WIDTHS)
    if not p.wide:
        assert p.col_tiles == 1 and k <= p.width
    assert p.smem <= spmm.SMEM_PER_BLOCK
    slots = np.zeros((p.col_tiles, nrb, maxb), np.int64)
    cols = np.zeros(k, np.int64)
    for b in range(p.blocks):
        ra, rb, j0, jcap, col0, ncols = p.work(b, nrb, maxb, k)
        assert ra < rb and j0 < jcap and ncols > 0
        if p.wide:
            assert rb - ra <= spmm.wide_group(p.width, word)
        else:
            assert p.splits == 1 or rb - ra == 1
        ct = col0 // p.col_tile
        slots[ct, ra:rb, j0:jcap] += 1
        if ra == 0 and j0 == 0:
            cols[col0:col0 + ncols] += 1
    assert (slots == 1).all()
    assert (cols == 1).all()
    assert p.zeroed == (p.splits > 1)
    if p.wide:
        assert p.smem >= p.meta_off + 4 * p.rows_per_block * (1 + p.per_split)
        assert p.rows_per_block * (1 + p.per_split) <= spmm.IDX_CAP
    else:
        assert p.splits == 1 or p.rows_per_block == 1
    if p.splits > 1:
        assert nrb * p.col_tiles < spmm.TARGET_BLOCKS
        assert p.splits <= -(-maxb // spmm.MIN_SLOTS_PER_SPLIT)


def test_spmm_plan_refuses_tiles_the_kernels_do_not_take():
    """The narrow kernel takes any tile; the wide one (y wider than 16
    columns) a warp per tile row and 4 words a lane of it."""
    assert not spmm.plan(4, 4, 16, 256, 3, 8).wide
    with pytest.raises(ValueError, match="rows"):
        spmm.plan(4, 4, 16, 128, 42, 8)
    with pytest.raises(ValueError, match="columns"):
        spmm.plan(4, 4, 8, 256, 42, 8)


def test_spmm_ell_k10_matches_numpy_backend():
    """The sparse fit's product at k = 10 (one launch of the narrow kernel
    on the card) against the reference's host backend, word for word."""
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
    p = spmm.plan(*blocks.shape, 10, 8)
    assert not p.wide and p.col_tiles == 1


@pytest.mark.parametrize("k", [42, 130, 512])
@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.uint64])
def test_spmm_ell_plain_wide_y_matches_reference(k, dtype):
    """spmm_ell_plain (what the wide kernel is held to on the card) at y
    wider than the narrow kernel, against `repro.kernels.ref.spmm_ell`:
    ring words exactly, float32 within rtol 1e-5, atol 1e-3. Tiles mostly
    zero, as the C^T x one-hot's are."""
    n, d = 12, 300
    mask = RNG.random((n, d)) < 0.1
    if dtype == np.float32:
        x = (RNG.normal(0, 2, (n, d)) * mask).astype(np.float32)
        y = RNG.normal(0, 2, (384, k)).astype(np.float32)
        to_t, back = torch.from_numpy, (lambda t: t.numpy())
    elif dtype == np.uint32:
        x = (RNG.integers(0, 1 << 32, (n, d), dtype=np.uint32)
             * mask).astype(np.uint32)
        y = RNG.integers(0, 1 << 32, (384, k), dtype=np.uint32)
        to_t, back = _u32, _as_u32
    else:
        x = RNG.integers(0, 1 << 64, (n, d), dtype=np.uint64) \
            * mask.astype(np.uint64)
        y = RNG.integers(0, 1 << 64, (384, k), dtype=np.uint64)
        to_t, back = ring.from_u64_numpy, ring.to_u64_numpy
    blocks, idx, counts = spmm.dense_to_ell(x)
    want = np.asarray(jref.spmm_ell(jnp.asarray(blocks), jnp.asarray(idx),
                                    jnp.asarray(counts), jnp.asarray(y),
                                    blocks.shape[0] * blocks.shape[2]))
    got = back(spmm.spmm_ell_plain(to_t(blocks), torch.from_numpy(idx),
                                   torch.from_numpy(counts), to_t(y)))
    assert got.shape == (blocks.shape[0] * blocks.shape[2], k)
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


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
