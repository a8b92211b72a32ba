"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (exact equality on ring words; float32 within the tolerance each
test states), the kernel API (`kernels/ops.py`) on CUDA tensors, and dense
and sparse GPU fits against the CPU fits. Needs an NVIDIA GPU and nvcc;
skipped without them. Imports no jax, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ring
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.kernels import argmin, esd, ksadder, modmatmul, ops, spmm

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels are built with nvcc)")
    # the float32 plain versions are held in full FP32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _words(shape, dev):
    return ring.from_u64_numpy(
        RNG.integers(0, 1 << 64, shape, dtype=np.uint64), dev)


def _words32(shape, dev):
    return torch.from_numpy(RNG.integers(0, 1 << 32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("shape", [(2048, 18, 5), (5, 2048, 24), (1, 200, 7),
                                   (129, 129, 129), (5, 100_000, 18)])
def test_ring_matmul_kernel_equals_plain(cuda, shape):
    m, kdim, n = shape
    a, b = _words((m, kdim), cuda), _words((kdim, n), cuda)
    before = modmatmul.LAUNCHES
    got = modmatmul.ring_matmul(a, b)
    assert modmatmul.LAUNCHES == before + 1
    assert torch.equal(got, modmatmul.ring_matmul_plain(a, b))
    # transposed / sliced views, as the main path passes them
    at = _words((kdim + 3, m), cuda)
    assert torch.equal(modmatmul.ring_matmul(at.T[:, 3:], b[:, :]),
                       modmatmul.ring_matmul_plain(at.T[:, 3:].contiguous(), b))


@pytest.mark.parametrize("shape", [(2048, 18, 5), (5, 2048, 24), (1, 200, 7),
                                   (129, 129, 129), (1024, 512, 128)])
def test_ring_matmul_u32_kernel_equals_plain(cuda, shape):
    m, kdim, n = shape
    a, b = _words32((m, kdim), cuda), _words32((kdim, n), cuda)
    before = modmatmul.LAUNCHES_U32
    got = ops.ring_matmul(a, b)
    assert modmatmul.LAUNCHES_U32 == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, modmatmul.ring_matmul_plain(a, b))
    want = np.einsum("ij,jk->ik", a.cpu().numpy().view(np.uint32),
                     b.cpu().numpy().view(np.uint32), dtype=np.uint32,
                     casting="unsafe")
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


def _wrap_heavy(shape, dev, bits):
    """Words at the top of the ring: every product and sum wraps."""
    top = (1 << bits) - 1
    dtype = np.uint64 if bits == 64 else np.uint32
    x = (dtype(top) - RNG.integers(0, 1 << (bits - 4), shape, dtype=dtype))
    view = np.int64 if bits == 64 else np.int32
    return torch.from_numpy(x.view(view)).to(dev)


def _operand(rows, cols, kind, draw):
    """A (rows, cols) operand in one of the layouts the fit passes:
    row-major, row-major inside a wider matrix (ld > cols), the transposed
    view of a row-major (cols, rows) matrix (`c.s0.T`, `mu.s0.T`), or a row
    slice of such a view past its first 3 rows (`mut.s1[da:]`)."""
    if kind == "row":
        return draw((rows, cols))
    if kind == "wide":
        return draw((rows, cols + 5))[:, 2:2 + cols]
    if kind == "t":
        return draw((cols, rows)).T
    assert kind == "slice"
    return draw((cols, rows + 3)).T[3:]


# (m, K, n, A layout, B layout, operands copied): each variant's main-path
# shapes and the fit's own layouts, K in {1, 17, 18, 24, 100003}, and M*N, N
# or K*N on both sides of each variant's limit (tall: N <= 8 and K*N <= 2048;
# long-K: M <= 8, N <= 256). Long-K reads a transposed A, tall-skinny a
# transposed B; any other transposed operand is copied.
LAYOUT_CASES = [
    (2048, 18, 5, "row", "t", 0), (2048, 24, 5, "row", "slice", 0),
    (2048, 18, 5, "row", "row", 0), (3000, 1, 8, "wide", "row", 0),
    (1000, 17, 8, "row", "t", 0), (500, 256, 8, "row", "row", 0),
    (500, 257, 8, "row", "row", 0), (300, 18, 9, "row", "t", 1),
    (2048, 18, 5, "t", "row", 1), (100_000, 128, 3, "row", "t", 0),
    (5, 100_003, 18, "t", "row", 0), (5, 100_003, 24, "row", "row", 0),
    (5, 100_003, 24, "slice", "wide", 0), (3, 100_003, 128, "t", "row", 0),
    (8, 4096, 256, "t", "row", 0), (9, 4096, 24, "t", "row", 1),
    (8, 4096, 257, "row", "row", 0), (5, 3000, 18, "t", "t", 2),
    (1, 200, 7, "t", "slice", 0), (129, 129, 129, "t", "t", 2),
]


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("wrap", [False, True], ids=["random", "wrap_heavy"])
@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=["x".join(map(str, c[:3])) + f"-{c[3]}-{c[4]}"
                              for c in LAYOUT_CASES])
def test_ring_matmul_layouts_equal_plain(cuda, case, wrap, bits):
    """Word for word on the layouts the fit passes, read in place, and on
    the others, each copied once and counted."""
    m, kdim, n, a_kind, b_kind, copied = case
    if wrap:
        def draw(shape):
            return _wrap_heavy(shape, cuda, bits)
    else:
        def draw(shape):
            return (_words if bits == 64 else _words32)(shape, cuda)
    a = _operand(m, kdim, a_kind, draw)
    b = _operand(kdim, n, b_kind, draw)
    counter = "LAUNCHES" if bits == 64 else "LAUNCHES_U32"
    before = getattr(modmatmul, counter)
    copies, zeros = modmatmul.COPIES, modmatmul.ZERO_LAUNCHES
    p = modmatmul.plan(m, kdim, n, modmatmul.layout(a)[0],
                       modmatmul.layout(b)[0], a.element_size())
    got = modmatmul.ring_matmul(a, b)
    assert getattr(modmatmul, counter) == before + 1
    assert modmatmul.COPIES == copies + copied
    assert modmatmul.ZERO_LAUNCHES == zeros + p.zeroed
    assert got.is_contiguous() and tuple(got.shape) == (m, n)
    want = modmatmul.ring_matmul_plain(a.contiguous(), b.contiguous())
    assert torch.equal(got, want)


def test_ring_matmul_copies_what_no_variant_reads(cuda):
    """A broadcast (stride-0) operand is copied once and counted."""
    a = _words((1, 24), cuda).expand(300, 24)
    b = _words((24, 5), cuda)
    copies = modmatmul.COPIES
    got = modmatmul.ring_matmul(a, b)
    assert modmatmul.COPIES == copies + 1
    assert torch.equal(got, modmatmul.ring_matmul_plain(a.contiguous(), b))


@pytest.mark.parametrize("d", [1, 3, 42, 129, 512])
@pytest.mark.parametrize("k", [1, 3, 5, 8, 9, 32, 33, 128, 129])
def test_esd_widths_equal_plain(cuda, d, k):
    """Both kernels at every centroid slot count and d chunking, ragged
    rows included (n = 1000 is not a multiple of 128); rtol 1e-5, atol 1e-3
    as in the reference tests (the kernel and cuBLAS sum in different
    orders)."""
    n = 1000
    x = torch.from_numpy(RNG.normal(0, 3, (n, d)).astype(np.float32)).to(cuda)
    mu = torch.from_numpy(RNG.normal(0, 3, (k, d)).astype(np.float32)).to(cuda)
    before = esd.LAUNCHES
    got = esd.esd(x, mu)
    assert esd.LAUNCHES == before + 1
    torch.testing.assert_close(got, esd.esd_plain(x, mu), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("n", [1, 129, 1001])
@pytest.mark.parametrize("d", [2, 18, 42, 62])
def test_esd_contiguous_slab_copy(cuda, n, d):
    """d % 4 == 2 in one chunk: the narrow kernel copies each block's rows
    as one 16-byte-aligned range; n leaves a last slab whose length is not
    a multiple of 4 floats. An offset view (x[1:]) is not 16-byte aligned
    and takes the word-by-word copies."""
    x = torch.from_numpy(RNG.normal(0, 3, (n + 1, d)).astype(np.float32)).to(cuda)
    mu = torch.from_numpy(RNG.normal(0, 3, (5, d)).astype(np.float32)).to(cuda)
    for xs in (x[:n], x[1:].contiguous(), x[1:]):
        torch.testing.assert_close(esd.esd(xs, mu), esd.esd_plain(xs, mu),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(2048, 42, 5), (1000, 256, 3),
                                   (777, 512, 128), (57, 129, 17), (3, 1, 40)])
def test_esd_kernel_equals_plain(cuda, shape):
    """rtol 1e-5, atol 1e-3: the kernel and cuBLAS sum the FP32 products in
    different orders (the reference tests' tolerance)."""
    n, d, k = shape
    x = torch.from_numpy(RNG.normal(0, 3, (n, d)).astype(np.float32)).to(cuda)
    mu = torch.from_numpy(RNG.normal(0, 3, (k, d)).astype(np.float32)).to(cuda)
    before = esd.LAUNCHES
    got = ops.esd(x, mu)
    assert esd.LAUNCHES == before + 1
    torch.testing.assert_close(got, esd.esd_plain(x, mu), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("shape", [(2048, 5), (1000, 3), (777, 128),
                                   (33, 1), (64, 300)])
def test_argmin_onehot_kernel_equals_plain(cuda, shape):
    d = RNG.normal(0, 10, shape).astype(np.float32)
    d[::7] = np.round(d[::7])                       # ties
    d[1::11] = 0.0
    d[1::11, ::2] = -0.0                            # -0.0 ties +0.0
    d[2::13] = np.inf                               # +inf rows
    d[3::17, -1] = np.nan                           # NaN rows: all zeros
    t = torch.from_numpy(d).to(cuda)
    before = argmin.LAUNCHES
    got = ops.argmin_onehot(t)
    assert argmin.LAUNCHES == before + 1
    want = argmin.argmin_onehot_plain(t)
    assert torch.equal(got, want)
    nan_rows = np.isnan(d).any(1)
    inf_rows = np.isposinf(d).all(1)
    got = got.cpu().numpy()
    assert (got[nan_rows] == 0).all() and (got[inf_rows, 0] == 1).all()
    assert (got[~nan_rows].sum(1) == 1).all()


def _ell(nrb, maxb, bm, bk, d_pad, k, dtype, dev):
    if dtype == torch.float32:
        blocks = torch.from_numpy(RNG.normal(0, 2, (nrb, maxb, bm, bk))
                                  .astype(np.float32)).to(dev)
        y = torch.from_numpy(RNG.normal(0, 2, (d_pad, k))
                             .astype(np.float32)).to(dev)
    elif dtype == torch.int32:
        blocks, y = _words32((nrb, maxb, bm, bk), dev), _words32((d_pad, k), dev)
    else:
        blocks, y = _words((nrb, maxb, bm, bk), dev), _words((d_pad, k), dev)
    idx = RNG.integers(0, d_pad // bk, (nrb, maxb))
    counts = RNG.integers(0, maxb + 1, nrb)
    counts[0], counts[-1] = maxb, 0                # a full and an empty block
    pad = np.arange(maxb)[None, :] >= counts[:, None]
    idx[pad] = 1 << 30                               # never read
    return (blocks, torch.as_tensor(idx.astype(np.int32), device=dev),
            torch.as_tensor(counts.astype(np.int32), device=dev), y)


LAUNCH_COUNTERS = {torch.float32: "LAUNCHES_F32", torch.int32: "LAUNCHES_U32",
                   torch.int64: "LAUNCHES"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64],
                         ids=["f32", "u32", "u64"])
@pytest.mark.parametrize("case", [((1250, 1, 8, 128), 128, 3),
                                  ((16, 80, 8, 128), 10240, 3),
                                  ((64, 20, 8, 128), 2560, 10),
                                  ((33, 9, 4, 64), 640, 5)],
                         ids=["S1", "S3", "k10", "bm4_bk64"])
def test_spmm_ell_word_types_equal_plain(cuda, case, dtype):
    """Ring words exactly; float32 within rtol 1e-5, atol 1e-3, because the
    split tile lists meet by atomicAdd in an order that changes per run."""
    (nrb, maxb, bm, bk), d_pad, k = case
    blocks, idx, counts, y = _ell(nrb, maxb, bm, bk, d_pad, k, dtype, cuda)
    counter = LAUNCH_COUNTERS[dtype]
    before = getattr(spmm, counter)
    got = ops.spmm(blocks, idx, counts, y)
    assert getattr(spmm, counter) == before + len(spmm.column_groups(k))
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    else:
        assert torch.equal(got, want)


def test_spmm_from_dense_lloyd_update(cuda):
    """C^T X of a plaintext Lloyd step through the API on the card."""
    x = RNG.normal(0, 3, (5000, 42)).astype(np.float32)
    lab = RNG.integers(0, 5, 5000)
    c = np.eye(5, dtype=np.int32)[lab]
    got = ops.spmm_from_dense(torch.from_numpy(c.T).to(cuda),
                              torch.from_numpy(x).to(cuda))
    want = c.T.astype(np.float64) @ x
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(2048, 2), (2048, 1), (5,), (1, 1), ()])
@pytest.mark.parametrize("party0", [True, False])
def test_ks_carry_share_kernel_equals_plain(cuda, shape, party0):
    flat = [_words(shape, cuda) for _ in range(6)]
    lvls = [_words((6, 2) + shape, cuda) for _ in range(4)]
    lvls.append(_words((6, 3) + shape, cuda)[:, :2])   # a strided stack
    before = ksadder.LAUNCHES
    got = ksadder.ks_carry_share(*flat, *lvls, party0=party0)
    assert ksadder.LAUNCHES == before + 1
    assert torch.equal(got, ksadder.ks_carry_share_plain(*flat, *lvls,
                                                         party0=party0))


@pytest.mark.parametrize("case", [((12500, 1, 8, 128), 128, 3),
                                  ((16, 782, 8, 128), 100096, 3),
                                  ((64, 20, 8, 128), 2560, 1),
                                  ((64, 20, 8, 128), 2560, 8),
                                  ((33, 9, 4, 64), 640, 5)],
                         ids=["S1", "S3", "k1", "k8", "bm4_bk64"])
def test_spmm_ell_kernel_equals_plain(cuda, case):
    (nrb, maxb, bm, bk), d_pad, k = case
    blocks, y = _words((nrb, maxb, bm, bk), cuda), _words((d_pad, k), cuda)
    idx = RNG.integers(0, d_pad // bk, (nrb, maxb))
    counts = RNG.integers(0, maxb + 1, nrb)
    counts[0], counts[-1] = maxb, 0                # a full and an empty block
    pad = np.arange(maxb)[None, :] >= counts[:, None]
    idx[pad] = 1 << 30                               # never read
    idx = torch.as_tensor(idx.astype(np.int32), device=cuda)
    counts = torch.as_tensor(counts.astype(np.int32), device=cuda)
    before = spmm.LAUNCHES
    got = spmm.spmm_ell(blocks, idx, counts, y)
    assert spmm.LAUNCHES == before + 1
    assert torch.equal(got, spmm.spmm_ell_plain(blocks, idx, counts, y))
    # a transposed Y view, as S3 passes it
    yt = _words((k, d_pad), cuda)
    assert torch.equal(spmm.spmm_ell(blocks, idx, counts, yt.T),
                       spmm.spmm_ell_plain(blocks, idx, counts,
                                           yt.T.contiguous()))


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_sparse_gpu_fit_equals_cpu_fit(cuda, partition):
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:40], x[40:])
    res = {}
    for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
        cfg = KMeansConfig(k=3, iters=2, partition=partition, seed=2,
                           sparse=True, backend=backend, device=device)
        res[backend] = SecureKMeans(cfg).fit(a, b)
    g, c = res["cuda"], res["torch"]
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
    assert g.log.by_tag("online") == c.log.by_tag("online")
    assert g.log.by_tag("offline") == c.log.by_tag("offline")
    assert g.he_seconds == c.he_seconds > 0.0


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_sparse_gpu_fit_equals_cpu_fit_k10(cuda, partition):
    """k = 10 > MAX_K: the fit's spmm_ell runs as two column groups."""
    x = RNG.normal(size=(160, 8)) + RNG.integers(0, 10, (160, 1)) * 4.0
    x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:70], x[70:])
    res = {}
    before = spmm.LAUNCHES
    for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
        cfg = KMeansConfig(k=10, iters=2, partition=partition, seed=2,
                           sparse=True, backend=backend, device=device)
        res[backend] = SecureKMeans(cfg).fit(a, b)
    assert spmm.LAUNCHES > before
    g, c = res["cuda"], res["torch"]
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
    assert g.log.by_tag("online") == c.log.by_tag("online")
    assert g.he_seconds == c.he_seconds


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_gpu_fit_equals_cpu_fit(cuda, partition):
    x = RNG.normal(size=(96, 6)) + RNG.integers(0, 3, (96, 1)) * 4.0
    a, b = (x[:, :3], x[:, 3:]) if partition == "vertical" else (x[:40], x[40:])
    res = {}
    for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
        cfg = KMeansConfig(k=3, iters=2, partition=partition, seed=2,
                           backend=backend, device=device)
        res[backend] = SecureKMeans(cfg).fit(a, b)
    g, c = res["cuda"], res["torch"]
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
    assert g.log.by_tag("online") == c.log.by_tag("online")
    assert g.log.by_tag("offline") == c.log.by_tag("offline")
