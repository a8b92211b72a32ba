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
from repro_torch.core.sharing import AShare
from repro_torch.core.triples import MulTriple
from repro_torch.kernels import (argmin, esd, ksadder, modmatmul, newton, ops,
                                 spmm)

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
    view of a row-major (cols, rows) matrix (`c.s0.T`, `mu.s0.T`), the same
    with one more column (ld = rows + 1), or a row slice of such a view past
    its first 3 rows (`mut.s1[da:]`)."""
    if kind == "row":
        return draw((rows, cols))
    if kind == "wide":
        return draw((rows, cols + 5))[:, 2:2 + cols]
    if kind == "t":
        return draw((cols, rows)).T
    if kind == "tpad":
        return draw((cols, rows + 1))[:, :rows].T
    assert kind == "slice"
    return draw((cols, rows + 3)).T[3:]


# (m, K, n, A layout, B layout, operands copied): each variant's main-path
# shapes and the fit's own layouts, K in {1, 17, 18, 24, 100003}, and M*N, N
# or K*N on both sides of each variant's limit (tall: N <= 8 and K*N <= 2048;
# long-K: M <= 8, N <= 256; long-K wide: M <= 16, 256 < N <= 2048; tall
# wide: N <= 16, K <= 640). The long-K variants read a transposed A, the
# tall ones a transposed B; any other transposed operand is copied. The
# kmeans-fraud cell's shapes run at K or M of ~100,000 (its n is 524,288):
# the long-K wide kernel over all 264 blocks with a ragged last chunk, the
# tall wide one over 196 slabs (some blocks walk two). Two-word copies
# where an operand allows them (row-major, "t" and "tpad" at even ld), word
# copies where it does not ("wide" at odd ld, "slice"), odd M and K.
LAYOUT_CASES = [
    (2048, 18, 5, "row", "t", 0), (2048, 24, 5, "row", "slice", 0),
    (2048, 18, 5, "row", "row", 0), (3000, 1, 8, "wide", "row", 0),
    (1000, 17, 8, "row", "t", 0), (500, 256, 8, "row", "row", 0),
    (500, 257, 8, "row", "row", 0), (300, 18, 9, "row", "t", 0),
    (2048, 18, 5, "t", "row", 1), (100_000, 128, 3, "row", "t", 0),
    (5, 100_003, 18, "t", "row", 0), (5, 100_003, 24, "row", "row", 0),
    (5, 100_003, 24, "slice", "wide", 0), (3, 100_003, 128, "t", "row", 0),
    (8, 4096, 256, "t", "row", 0), (9, 4096, 24, "t", "row", 1),
    (8, 4096, 257, "row", "row", 0), (5, 3000, 18, "t", "t", 2),
    (1, 200, 7, "t", "slice", 0), (129, 129, 129, "t", "t", 2),
    # the kmeans-fraud cell's products at its layouts
    (16, 100_003, 512, "t", "row", 0), (16, 100_003, 512, "row", "row", 0),
    (100_000, 512, 16, "row", "t", 0), (100_000, 512, 16, "row", "slice", 0),
    (100_000, 512, 16, "row", "row", 0),
    # long-K wide: its limits, one block (no split), two slabs, odd M
    (16, 4096, 300, "slice", "wide", 0), (16, 4096, 301, "t", "wide", 0),
    (17, 4096, 300, "t", "row", 1),
    (16, 4096, 257, "row", "row", 0), (16, 4096, 256, "row", "row", 0),
    (9, 2000, 2048, "t", "row", 0), (9, 2000, 2049, "row", "row", 0),
    (15, 4097, 513, "tpad", "row", 0), (16, 8, 600, "t", "row", 0),
    # tall wide: its limits, one partial slab, narrow N past 2048 B words
    (3000, 64, 16, "row", "t", 0), (3000, 64, 17, "row", "t", 1),
    (3000, 640, 16, "row", "row", 0), (3000, 641, 16, "row", "row", 0),
    (1001, 18, 12, "wide", "slice", 0), (1001, 17, 12, "wide", "row", 0),
    (2000, 512, 5, "row", "t", 0),
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


WORD_TYPES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.int32, torch.int64],
    ids=["f32", "u32", "u64"])


@WORD_TYPES
@pytest.mark.parametrize("case", [((1250, 1, 8, 128), 128, 3),
                                  ((16, 80, 8, 128), 10240, 3),
                                  ((64, 20, 8, 128), 2560, 10),
                                  ((33, 9, 4, 64), 640, 5),
                                  ((40, 12, 8, 128), 1536, 9),
                                  ((16, 30, 8, 128), 3840, 42),
                                  ((8, 24, 8, 128), 3072, 128),
                                  ((3, 40, 8, 128), 5120, 512)],
                         ids=["S1", "S3", "k10", "bm4_bk64", "k9", "k42",
                              "k128", "k512"])
def test_spmm_ell_word_types_equal_plain(cuda, case, dtype):
    """Ring words exactly; float32 within rtol 1e-5, atol 1e-3, because the
    split tile lists meet by atomicAdd in an order that changes per run.
    One launch per call, whatever the width of y."""
    (nrb, maxb, bm, bk), d_pad, k = case
    blocks, idx, counts, y = _ell(nrb, maxb, bm, bk, d_pad, k, dtype, cuda)
    counter = LAUNCH_COUNTERS[dtype]
    before = getattr(spmm, counter)
    got = ops.spmm(blocks, idx, counts, y)
    assert getattr(spmm, counter) == before + 1
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    else:
        assert torch.equal(got, want)


@WORD_TYPES
@pytest.mark.parametrize("k", [3, 9, 42, 128, 512])
def test_spmm_ell_zero_words_beside_inf_and_nan(cuda, k, dtype):
    """Tiles mostly zero (whole zero rows and columns, the wide kernel's
    skipped words) against a y holding inf and NaN in some rows (float32)
    or all-ones words (ring words): the kernel equals the plain version,
    NaN where it has NaN (0 * inf is NaN), ring words exactly."""
    nrb, maxb, bm, bk = 6, 10, 8, 128
    d_pad = 12 * bk
    blocks, idx, counts, y = _ell(nrb, maxb, bm, bk, d_pad, k, dtype, cuda)
    keep = torch.from_numpy(RNG.random((nrb, maxb, bm, bk)) < 0.05)
    keep[:, :, :, :64] = False                       # zero columns
    keep[:, :, 3] = False                            # zero rows
    blocks = torch.where(keep.to(cuda), blocks, torch.zeros_like(blocks))
    if dtype == torch.float32:
        y[5 * bk + 3] = float("inf")                 # tile 5: inf row
        y[7 * bk + 70, : (k + 1) // 2] = float("nan")   # tile 7: NaN
        y[9 * bk + 1, -1] = -float("inf")
    else:
        y[5 * bk: 6 * bk] = -1                       # all-ones words
    idx[:, 0] = 5
    idx[:, 1] = 7
    idx[:, 2] = 9
    idx[:, 3] = 0                                    # a finite tile
    got = spmm.spmm_ell(blocks, idx, counts, y)
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    if dtype == torch.float32:
        assert torch.isnan(want).any()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3,
                                   equal_nan=True)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("d,k", [(42, 5), (300, 3), (520, 128)])
def test_spmm_from_dense_lloyd_update(cuda, d, k):
    """C^T X of a plaintext Lloyd step through the API on the card: one
    launch at any width d."""
    x = RNG.normal(0, 3, (5000, d)).astype(np.float32)
    lab = RNG.integers(0, k, 5000)
    c = np.eye(k, dtype=np.int32)[lab]
    before = spmm.LAUNCHES_F32
    got = ops.spmm_from_dense(torch.from_numpy(c.T).to(cuda),
                              torch.from_numpy(x).to(cuda))
    assert spmm.LAUNCHES_F32 == before + 1
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


def _newton_triples(k, count, dev, layout):
    """`count` mul triples of (k,) random words: separate tensors, rows of
    one stacked pool (views), or strided views of one."""
    if layout == "separate":
        return [MulTriple(*(AShare(_words((k,), dev), _words((k,), dev))
                            for _ in range(3))) for _ in range(count)]
    pool = _words((count, 6, 2 * k), dev)
    pool = pool[..., :k] if layout == "pooled" else pool[..., ::2]
    return [MulTriple(AShare(p[0], p[1]), AShare(p[2], p[3]),
                      AShare(p[4], p[5])) for p in pool]


@pytest.mark.parametrize("layout", ["separate", "pooled", "strided"])
@pytest.mark.parametrize("iters", [1, 25, 29, 45])
@pytest.mark.parametrize("k", [1, 5, 16, 4099])
def test_newton_recip_kernel_equals_plain(cuda, k, iters, layout):
    """Word for word, one launch per newton.MAX_ITERS iterations (45
    takes two, x carried between them through the output)."""
    dp = AShare(_words((k,), cuda), _words((k,), cuda))
    x0 = AShare(_words((k,), cuda), _words((k,), cuda))
    triples = _newton_triples(k, 2 * iters, cuda, layout)
    before = newton.LAUNCHES
    got = newton.newton_recip(dp, x0, triples, f=20, iters=iters)
    assert newton.LAUNCHES == before + -(-iters // newton.MAX_ITERS)
    want = newton.newton_recip_plain(dp, x0, triples, f=20, iters=iters)
    assert torch.equal(got.s0, want.s0) and torch.equal(got.s1, want.s1)


@pytest.mark.parametrize("chunk", [1, 7, 41])
def test_newton_recip_kernel_chunks(cuda, monkeypatch, chunk):
    """Any chunk the parameter struct holds gives the same words, x
    carried between launches through the output; 41 iterations a launch
    is more than it holds, and the launcher refuses it."""
    monkeypatch.setattr(newton, "MAX_ITERS", chunk)
    dp = AShare(_words((5,), cuda), _words((5,), cuda))
    x0 = AShare(_words((5,), cuda), _words((5,), cuda))
    triples = _newton_triples(5, 2 * 29, cuda, "pooled")
    if chunk > 40:
        with pytest.raises(RuntimeError, match="newton_recip"):
            newton.newton_recip(dp, x0, triples, f=20, iters=29)
        return
    before = newton.LAUNCHES
    got = newton.newton_recip(dp, x0, triples, f=20, iters=29)
    assert newton.LAUNCHES == before + -(-29 // chunk)
    want = newton.newton_recip_plain(dp, x0, triples, f=20, iters=29)
    assert torch.equal(got.s0, want.s0) and torch.equal(got.s1, want.s1)


@pytest.mark.parametrize("k", [5, 16])
def test_fit_programs_s3_kernel_equals_plain_on_the_card(cuda, k):
    """A whole S3 program call on the cuda backend (its Newton loop one
    kernel launch) = the same call on the torch backend, on the card."""
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.launch import kmeans_step as KS
    n, da, db = 300, 3, 4
    progs = {b: KS.fit_programs("vertical", False, (n, da), (n, db), k,
                                backend=b, device="cuda")
             for b in ("cuda", "torch")}
    assert progs["cuda"].s3_requests == progs["torch"].s3_requests
    g = torch.Generator().manual_seed(k)
    xa = torch.randint(-2 ** 21, 2 ** 21, (n, da), generator=g).to(cuda)
    xb = torch.randint(-2 ** 21, 2 ** 21, (n, db), generator=g).to(cuda)
    mu0, mu1 = (torch.randint(-2 ** 62, 2 ** 62, (k, da + db),
                              generator=g).to(cuda) for _ in range(2))
    dealer = TrustedDealer(seed=k, device="cuda")
    flat1 = KS.materialize_offline(progs["cuda"].s1_requests, dealer)
    flat3 = KS.materialize_offline(progs["cuda"].s3_requests, dealer)
    c0, c1 = progs["cuda"].s1(xa, xb, mu0, mu1, *flat1)
    before = newton.LAUNCHES
    got = progs["cuda"].s3(xa, xb, mu0, mu1, c0, c1, *flat3)
    assert newton.LAUNCHES == before + 1
    want = progs["torch"].s3(xa, xb, mu0, mu1, c0, c1, *flat3)
    assert newton.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    # a transposed Y view, as S1 passes it (mu.s1.T), read in place
    yt = _words((k, d_pad), cuda)
    copies = spmm.COPIES
    assert torch.equal(spmm.spmm_ell(blocks, idx, counts, yt.T),
                       spmm.spmm_ell_plain(blocks, idx, counts,
                                           yt.T.contiguous()))
    assert spmm.COPIES == copies
    # and a row-major view with a leading dimension and an offset
    wide = _words((d_pad, k + 5), cuda)
    assert torch.equal(spmm.spmm_ell(blocks, idx, counts, wide[:, 2:2 + k]),
                       spmm.spmm_ell_plain(blocks, idx, counts,
                                           wide[:, 2:2 + k].contiguous()))
    assert spmm.COPIES == copies


@pytest.mark.parametrize("k", [42, 128])
def test_spmm_ell_wide_transposed_y_copied_once(cuda, k):
    """The wide kernel reads Y row-major: a transposed view is copied
    contiguous once for the call, and counted."""
    blocks, idx, counts, _ = _ell(9, 6, 8, 128, 1024, k, torch.int64, cuda)
    yt = _words((k, 1024), cuda)
    copies, launches = spmm.COPIES, spmm.LAUNCHES
    got = spmm.spmm_ell(blocks, idx, counts, yt.T)
    assert spmm.COPIES == copies + 1 and spmm.LAUNCHES == launches + 1
    assert torch.equal(got, spmm.spmm_ell_plain(blocks, idx, counts,
                                                yt.T.contiguous()))


@WORD_TYPES
@pytest.mark.parametrize("case", [((9, 6, 16, 128), 1024, 42),
                                  ((5, 7, 16, 128), 896, 300),
                                  ((4, 5, 32, 128), 768, 100),
                                  ((6, 4, 12, 64), 512, 17),
                                  ((5, 3, 8, 256), 1024, 42),
                                  ((3, 4, 16, 2048), 8192, 42)],
                         ids=["bm16_k42", "bm16_k300", "bm32_k100",
                              "bm12_bk64", "bk256_k42", "bm16_bk2048"])
def test_spmm_ell_wide_tall_and_wide_tiles_equal_plain(cuda, case, dtype):
    """Tiles the wide kernel (y wider than 16 columns) once refused: more
    than 8 rows (a warp takes 2 or 4 tile rows) and tiles whose rows do
    not fit in shared memory (staged in pieces). One launch, equal to the
    plain version: ring words exactly, float32 within rtol 1e-5, atol
    1e-3."""
    (nrb, maxb, bm, bk), d_pad, k = case
    blocks, idx, counts, y = _ell(nrb, maxb, bm, bk, d_pad, k, dtype, cuda)
    assert bm > 8 or bk > 128
    assert spmm.plan(nrb, maxb, bm, bk, k, blocks.element_size()).wide
    counter = LAUNCH_COUNTERS[dtype]
    before = getattr(spmm, counter)
    got = spmm.spmm_ell(blocks, idx, counts, y)
    assert getattr(spmm, counter) == before + 1
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("y_t", [False, True], ids=["y", "y_t"])
@pytest.mark.parametrize("k", [15, 16])
def test_spmm_ell_narrow_tile_in_pieces_equals_plain(cuda, k, y_t):
    """u64 at bk = 2048 and k = 15 or 16: a staged Y tile (2048 rows at an
    odd stride, or k rows of 2048 words of a transposed y) does not fit in
    a block's shared memory, so the narrow kernel stages it in pieces."""
    nrb, maxb, bm, bk = 6, 5, 8, 2048
    d_pad = 8 * bk
    blocks, idx, counts, y = _ell(nrb, maxb, bm, bk, d_pad, k, torch.int64,
                                  cuda)
    if y_t:
        y = _words((k, d_pad), cuda).T
    p = spmm.plan(nrb, maxb, bm, bk, k, 8, y_t)
    assert not p.wide and p.pieces > 1
    copies, before = spmm.COPIES, spmm.LAUNCHES
    got = spmm.spmm_ell(blocks, idx, counts, y)
    assert spmm.LAUNCHES == before + 1 and spmm.COPIES == copies
    assert torch.equal(got, spmm.spmm_ell_plain(blocks, idx, counts,
                                                y.contiguous()))
    # through the kernel API, from a dense matrix with 16-row tiles
    x = ring.to_u64_numpy(_words((40, 3000), cuda))
    x *= (RNG.random(x.shape) < 0.01).astype(np.uint64)
    yd = _words((3000, k), cuda)
    tx = ring.from_u64_numpy(x, cuda)
    assert torch.equal(ops.spmm_from_dense(tx, yd, bm=16, bk=bk),
                       ops.spmm_from_dense(tx.cpu(), yd.cpu(), bm=16,
                                           bk=bk).to(cuda))


@pytest.mark.parametrize("k", [3, 10, 42])
def test_spmm_ell_all_zero_matrix(cuda, k):
    """The offline planner traces the sparse fit on all-zero data: its
    CSR matrices pack to one slot a row block and no tile used. The card
    gives zeros for them and for their transposes, one launch each."""
    from repro_torch.core.sparse import CSRMatrix
    csr = CSRMatrix.from_dense(np.zeros((1000, 300), np.uint64))
    for mat in (csr, csr.transpose()):
        blocks, idx, counts = mat.ell(device=cuda)
        assert blocks.shape[1] == 1 and int(counts.sum()) == 0
        d_pad = 128 * -(-mat.shape[1] // 128)
        before = spmm.LAUNCHES
        got = spmm.spmm_ell(blocks, idx, counts, _words((d_pad, k), cuda))
        assert spmm.LAUNCHES == before + 1
        assert got.shape == (blocks.shape[0] * 8, k)
        assert not got.any()


def _served_words(dealer, requests) -> list:
    """Every word a dealer serves for a schedule of matmul, mul, bin and
    rand requests, on the host."""
    out = []
    for r in requests:
        if r.kind == "matmul":
            t = dealer.matmul_triple(*r.shape)
            out += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
        elif r.kind in ("mul", "bin"):
            t = getattr(dealer, f"{r.kind}_triple")(r.shape)
            out += [w for share in t for w in share]
        else:
            out.append(dealer.rand(r.shape))
    return [t.cpu() for t in out]


@pytest.mark.parametrize("stage_words", [7, 1000, None])
def test_pooled_dealers_on_the_card_equal_the_cpu_pool(cuda, monkeypatch,
                                                       stage_words):
    """The pinned staging buffers, taking turns (a class split over many of
    them when STAGE_WORDS is small), carry the CPU pool's words to the
    card, for the pooled dealer and for the streaming one, whose worker
    uploads on a stream of its own (and inline, without the worker)."""
    from repro_torch.core import triples as T
    reqs = [T.PlanRequest("matmul", ((50, 3), (3, 2)), "t"),
            T.PlanRequest("mul", (40, 3), "t"), T.PlanRequest("bin", (9,), "t"),
            T.PlanRequest("rand", (33,), "t")]
    plan = T.TriplePlan(reqs * 3)
    if stage_words is not None:
        monkeypatch.setattr(T, "STAGE_WORDS", stage_words)
        monkeypatch.setattr(T, "DRAW_WORDS", 3 * stage_words)
    full = plan.requests * 2
    want = _served_words(T.PooledDealer(plan.repeat(2), seed=4), full)
    for dealer in (T.PooledDealer(plan.repeat(2), seed=4, device=cuda),
                   T.StreamingPooledDealer(plan, 2, seed=4, device=cuda),
                   T.StreamingPooledDealer(plan, 2, seed=4, device=cuda,
                                           async_gen=False)):
        got = _served_words(dealer, full)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_pooled_and_streamed_gpu_fits_equal_on_demand(cuda, partition,
                                                      sparse):
    """offline="pooled" / "streamed" on the card (the S1/S3 programs over
    the pool's device tensors; the streamed tranches uploaded from the
    worker on a stream of their own) give the on-demand fit's share words,
    dealer counters, traffic per tag and phase, and he_seconds."""
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if sparse:
        x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:40], x[40:])
    res = {}
    for offline in ("on_demand", "pooled", "streamed"):
        cfg = KMeansConfig(k=3, iters=3, partition=partition, seed=2,
                           sparse=sparse, offline=offline)
        res[offline] = SecureKMeans(cfg).fit(a, b)
    g = res["on_demand"]
    for off in ("pooled", "streamed"):
        r = res[off]
        for field in ("centroids", "assignment"):
            for i in (0, 1):
                assert torch.equal(getattr(r, field)[i], getattr(g, field)[i])
        for attr in ("n_matmul", "n_mul", "n_bin"):
            assert getattr(r.dealer, attr) == getattr(g.dealer, attr)
        for phase in ("online", "offline"):
            assert r.log.by_tag(phase) == g.log.by_tag(phase)
        assert r.he_seconds == g.he_seconds
        assert all(v == 0 for v in r.dealer.remaining().values())
    assert res["streamed"].dealer.served_iters == 3


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
    """k = 10: the fit's spmm_ell is one launch of the narrow kernel."""
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


# ---------------------------------------------------------------------------
# minibatch Lloyd and the SlotDealer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage_words", [7, None])
def test_slot_dealer_on_the_card_equals_the_cpu_pool(cuda, monkeypatch,
                                                     stage_words):
    """The SlotDealer's slots, pregenerated (pooled) or uploaded by the
    worker on a stream of its own through 7-word staging buffers
    (streamed), one slot or a merged group at a time, carry the CPU pool's
    words, slot by slot; the slots are acquired ahead of the ones served, as the
    pipelined executor acquires them."""
    from repro_torch.core import triples as T
    reqs = [T.PlanRequest("matmul", ((50, 3), (3, 2)), "t"),
            T.PlanRequest("mul", (40, 3), "t"), T.PlanRequest("bin", (9,), "t"),
            T.PlanRequest("rand", (33,), "t")]
    plans = [T.TriplePlan(reqs[i % 4:] + reqs[:i % 4]) for i in range(7)]
    if stage_words is not None:
        monkeypatch.setattr(T, "STAGE_WORDS", stage_words)
        monkeypatch.setattr(T, "DRAW_WORDS", 3 * stage_words)
    concat = T.TriplePlan([r for p in plans for r in p.requests])
    want = _served_words(T.PooledDealer(concat, seed=4), concat.requests)
    monkeypatch.setattr(T, "SLOT_WINDOW", 2)
    auto = T.GROUP_TRANCHE_BYTES
    for stream, group in ((False, auto), (True, 0), (True, auto)):
        monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", group)
        dealer = T.SlotDealer(plans, seed=4, device=cuda, stream=stream)
        got = {}
        views = {0: dealer.acquire(0)}
        for i in range(len(plans)):
            if i + 1 < len(plans):
                views[i + 1] = dealer.acquire(i + 1)     # acquired ahead
            got[i] = _served_words(views.pop(i), plans[i].requests)
        flat = [w for i in range(len(plans)) for w in got[i]]
        assert len(flat) == len(want)
        for g, w in zip(flat, want):
            assert torch.equal(g, w)
        dealer.close()
        assert dealer._live_bytes == 0


def test_slot_acquired_ahead_across_the_side_stream(cuda, monkeypatch):
    """A slot acquired while the current stream is still busy serves the
    right words: the current stream waits on the worker's upload event
    before a kernel reads them, and a released slot's memory is reused
    only after those kernels have run."""
    from repro_torch.core import triples as T
    plans = [T.TriplePlan([T.PlanRequest("mul", (512, 512), "t")])
             for _ in range(6)]
    concat = T.TriplePlan([r for p in plans for r in p.requests])
    want = [t.cpu() for t in _served_words(T.PooledDealer(concat, seed=9),
                                           concat.requests)]
    monkeypatch.setattr(T, "SLOT_WINDOW", 2)
    monkeypatch.setattr(T, "GROUP_TRANCHE_BYTES", 0)
    dealer = T.SlotDealer(plans, seed=9, device=cuda)
    sums = []
    for i in range(len(plans)):
        torch.cuda._sleep(2_000_000)            # keep the current stream busy
        t = dealer.acquire(i).mul_triple((512, 512))
        sums.append(torch.stack([w for share in t for w in share]).sum(0))
        del t
    torch.cuda.synchronize()
    for i, s in enumerate(sums):
        assert torch.equal(s.cpu(), torch.stack(want[6 * i:6 * i + 6]).sum(0))
    dealer.close()


@pytest.mark.parametrize("offline", ["pooled", "streamed"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_minibatch_gpu_fit_equals_cpu_fit(cuda, partition, sparse, offline):
    """The minibatch fit on the card (batch and finalize programs over the
    SlotDealer's device tensors, pipelined and not) gives the CPU
    minibatch fit's share words, counters, traffic and he_seconds, at a
    batch size that leaves a remainder."""
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if sparse:
        x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:40], x[40:])
    common = dict(k=3, iters=2, partition=partition, seed=2, sparse=sparse,
                  offline=offline, batch_size=36)
    for pipeline in (True, False):
        c = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                      pipeline=pipeline, **common)).fit(a, b)
        g = SecureKMeans(KMeansConfig(pipeline=pipeline, **common)).fit(a, b)
        for field in ("centroids", "assignment"):
            for i in (0, 1):
                assert torch.equal(getattr(g, field)[i].cpu(),
                                   getattr(c, field)[i])
        for attr in ("n_matmul", "n_mul", "n_bin"):
            assert getattr(g.dealer, attr) == getattr(c.dealer, attr)
        for phase in ("online", "offline"):
            assert g.log.by_tag(phase) == c.log.by_tag(phase)
        assert g.he_seconds == c.he_seconds
        assert all(v == 0 for v in g.dealer.remaining().values())


# ---------------------------------------------------------------------------
# secure scoring, the TripleBank and the ScoringService on the card
# ---------------------------------------------------------------------------

def _bank_words(bank) -> dict:
    return {k: [tuple(a.cpu() if torch.is_tensor(a) else a for a in e)
                for e, _shelf in q] for k, q in bank._queues.items()}


def _assert_same_bank(got, want) -> None:
    g, w = _bank_words(got), _bank_words(want)
    assert g.keys() == w.keys()
    for ck in w:
        assert len(g[ck]) == len(w[ck])
        for eg, ew in zip(g[ck], w[ck]):
            for a, b in zip(eg, ew):
                assert (torch.equal(a, b) if torch.is_tensor(a)
                        else int(a) == int(b))
    assert got.pool_bytes == want.pool_bytes


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("stage_words", [7, None])
def test_bank_on_the_card_equals_the_cpu_bank(cuda, monkeypatch, tmp_path,
                                              stage_words, workers):
    """A bank provisioned on the card (its own upload stream, pinned
    staging of 7 words or the default) holds the CPU bank's words, for any
    worker count; a card bank's file loads on the CPU and a CPU bank's on
    the card, with the same words."""
    from repro_torch.core import triples as T
    if stage_words is not None:
        monkeypatch.setattr(T, "STAGE_WORDS", stage_words)
        monkeypatch.setattr(T, "DRAW_WORDS", 3 * stage_words)
    plan = T.TriplePlan([T.PlanRequest("matmul", ((50, 3), (3, 2)), "t"),
                         T.PlanRequest("mul", (40, 3), "t"),
                         T.PlanRequest("bin", (9,), "t"),
                         T.PlanRequest("rand", (33,), "t"),
                         T.PlanRequest("seed", (), "t")])
    gpu = T.TripleBank(seed=8, device=cuda)
    gpu.provision(("k",), plan, copies=3, workers=workers)
    cpu = T.TripleBank(seed=8, device="cpu")
    cpu.provision(("k",), plan, copies=3)
    _assert_same_bank(gpu, cpu)
    gpu.save(str(tmp_path / "gpu"))
    cpu.save(str(tmp_path / "cpu"))
    _assert_same_bank(T.TripleBank.load(str(tmp_path / "gpu"), device="cpu"),
                      cpu)
    _assert_same_bank(T.TripleBank.load(str(tmp_path / "cpu"), device=cuda),
                      cpu)


def test_bank_pop_waits_for_the_upload_stream(cuda):
    """Entries popped from tranches uploaded on the bank's stream while the
    current stream is busy carry the CPU bank's words: the current stream
    waits on each tranche's upload before its kernels read them, and a
    served tranche's memory is reused only after those kernels ran."""
    from repro_torch.core import triples as T
    plan = T.TriplePlan([T.PlanRequest("mul", (512, 512), "t")])
    gpu = T.TripleBank(seed=9, device=cuda)
    cpu = T.TripleBank(seed=9, device="cpu")
    gpu.provision(("k",), plan, copies=1)
    cpu.provision(("k",), plan, copies=1)
    sums, want = [], []
    for _ in range(6):                  # 1 provisioned, then replenishes
        torch.cuda._sleep(2_000_000)
        t = gpu.dealer(("k",)).mul_triple((512, 512))
        sums.append(torch.stack([w for share in t for w in share]).sum(0))
        del t
        c = cpu.dealer(("k",)).mul_triple((512, 512))
        want.append(torch.stack([w for share in c for w in share]).sum(0))
    torch.cuda.synchronize()
    for s, w in zip(sums, want):
        assert torch.equal(s.cpu(), w)
    assert gpu.replenish_events == cpu.replenish_events == 5


@pytest.mark.parametrize("batch_size", [None, 36], ids=["full", "minibatch"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_bank_fed_gpu_fit_equals_cpu_fit(cuda, partition, batch_size):
    """plan_fit -> a bank on the card -> fit(dealer=bank.dealer(key)) gives
    the CPU bank-fed fit's words, counters and traffic, and the pooled
    GPU fit's shares."""
    from repro_torch.core.triples import TripleBank
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:40], x[40:])
    common = dict(k=3, iters=2, partition=partition, seed=2,
                  offline="pooled", batch_size=batch_size)
    fits = {}
    for dev, extra in ((cuda, {}), ("cpu", dict(backend="torch",
                                                device="cpu"))):
        km = SecureKMeans(KMeansConfig(**common, **extra))
        key, plan, _ = km.plan_fit(a.shape, b.shape)
        bank = TripleBank(seed=2, device=dev)
        bank.provision(key, plan, workers=2)
        fits[str(dev)] = km.fit(a, b, dealer=bank.dealer(key))
        assert bank.served_requests == len(plan)
    g, c = fits[str(cuda)], fits["cpu"]
    pooled = SecureKMeans(KMeansConfig(**common)).fit(a, b)
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
            assert torch.equal(getattr(g, field)[i],
                               getattr(pooled, field)[i])
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(g.dealer, attr) == getattr(c.dealer, attr)
    for phase in ("online", "offline"):
        assert g.log.by_tag(phase) == c.log.by_tag(phase)


def _fitted_pair(partition, sparse):
    """A CPU fit and the port model on the card over the same shares."""
    from repro_torch.core.interop import (result_from_reference,
                                          shares_to_numpy)
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if sparse:
        x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:48], x[48:])
    common = dict(k=3, iters=2, partition=partition, seed=2, sparse=sparse)
    cpu = SecureKMeans(KMeansConfig(backend="torch", device="cpu", **common))
    res = cpu.fit(a, b)
    gpu = SecureKMeans(KMeansConfig(**common))
    gpu.result_ = result_from_reference(
        {f: shares_to_numpy(getattr(res, f))
         for f in ("centroids", "assignment")}, device="cuda")
    return cpu, gpu


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_gpu_score_equals_cpu_score(cuda, partition, sparse):
    """`score` and `predict` on the card, as the scoring program and
    eagerly, give the CPU's share words and traffic; sparse scoring
    launches spmm_ell."""
    from repro_torch.core.triples import TrustedDealer
    cpu, gpu = _fitted_pair(partition, sparse)
    q = RNG.normal(size=(40, 8)) + RNG.integers(0, 3, (40, 1)) * 4.0
    if sparse:
        q *= RNG.random(q.shape) >= 0.7
    qa, qb = (q[:, :4], q[:, 4:]) if partition == "vertical" \
        else (q[:15], q[15:])
    for method in ("score", "predict"):
        for compiled in (True, False):
            before = spmm.LAUNCHES
            g = getattr(gpu, method)(qa, qb, compiled=compiled,
                                     dealer=TrustedDealer(seed=7,
                                                          device=cuda))
            c = getattr(cpu, method)(qa, qb, compiled=compiled,
                                     dealer=TrustedDealer(seed=7))
            fields = ("assignment", "scores") if method == "score" \
                else ("assignment",)
            for field in fields:
                for i in (0, 1):
                    assert torch.equal(getattr(g, field)[i].cpu(),
                                       getattr(c, field)[i])
            assert g.log.by_tag("online") == c.log.by_tag("online")
            assert (spmm.LAUNCHES > before) == sparse


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_gpu_service_with_replenisher_equals_cpu_service(cuda, sparse):
    """A service on the card whose bank a BankReplenisher tops up while the
    drains run (pipeline on and off) answers with the words of a CPU
    service whose bank only replenishes synchronously."""
    from repro_torch.serve import ScoringService
    cpu, gpu = _fitted_pair("vertical", sparse)
    sizes = RNG.poisson(12, 30)
    batches = []
    for m in sizes:
        q = RNG.normal(size=(int(m) + 1, 8)) + 4.0 * RNG.integers(0, 3, (1, 1))
        if sparse:
            q *= RNG.random(q.shape) >= 0.7
        batches.append((q[:, :4], q[:, 4:]))
    kw = dict(rungs=(8, 32), d_a=4, d_b=4, provision_copies=1)
    for pipeline in (True, False):
        svc_c = ScoringService(cpu, pipeline=pipeline, **kw)
        svc_g = ScoringService(gpu, pipeline=pipeline,
                               replenisher={"low_water": 2,
                                            "poll_s": 0.0005}, **kw)
        assert svc_g.bank.device.type == "cuda"
        for svc in (svc_c, svc_g):
            for qa, qb in batches[:15]:
                svc.submit(qa, qb)
        out_c, out_g = svc_c.drain(), svc_g.drain()
        for svc in (svc_c, svc_g):
            for qa, qb in batches[15:]:
                svc.submit(qa, qb)
        out_c += svc_c.drain()
        out_g += svc_g.drain()
        svc_g.close()
        assert svc_g.replenisher.errors == 0
        assert svc_g.replenisher.topups >= 1
        for a, b in zip(out_g, out_c):
            assert a.error is None and b.error is None
            np.testing.assert_array_equal(a.labels, b.labels)
            np.testing.assert_array_equal(a.scores, b.scores)


# ---------------------------------------------------------------------------
# checkpointed, resumed and wired fits; the service restart
# ---------------------------------------------------------------------------

def _same_fit(got, want) -> None:
    """Shares (wherever they live), iterations, dealer counters and
    traffic per tag and phase."""
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(got, field)[i].cpu(),
                               getattr(want, field)[i].cpu())
    assert got.iters_run == want.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(got.dealer, attr) == getattr(want.dealer, attr)
    for phase in ("online", "offline"):
        assert got.log.by_tag(phase) == want.log.by_tag(phase)


class _Stop(Exception):
    """Raised from the checkpointer's after_save seam: the fit dies."""


@pytest.mark.parametrize("case", [
    dict(offline="on_demand"), dict(offline="pooled", sparse=True),
    dict(offline="streamed", batch_size=36, pipeline=False)],
    ids=["on_demand", "pooled_sparse", "minibatch"])
def test_resumed_gpu_fit_equals_uninterrupted_and_cpu(cuda, tmp_path, case):
    """A GPU fit stopped after its second published cut and resumed ends
    with the uninterrupted GPU fit's and the CPU fit's words."""
    from repro_torch.checkpoint.fit import FitCheckpointer
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if case.get("sparse"):
        x *= RNG.random(x.shape) >= 0.7
    a, b = x[:, :4], x[:, 4:]
    common = dict(k=3, iters=3, seed=2, **case)
    gpu = SecureKMeans(KMeansConfig(**common))
    want = gpu.fit(a, b)
    cpu = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                    **common)).fit(a, b)
    _same_fit(want, cpu)
    saved = []

    def stop(state, _path):
        saved.append(state.step)
        if len(saved) == 2:
            raise _Stop

    d = str(tmp_path / "ck")
    batch_every = 1 if case.get("batch_size") else None
    with pytest.raises(_Stop):
        gpu.fit(a, b, checkpoint=FitCheckpointer(
            d, every=1, batch_every=batch_every, after_save=stop))
    got = gpu.fit(a, b, checkpoint=FitCheckpointer(d), resume=True)
    assert got.centroids.s0.device.type == "cuda"
    _same_fit(got, want)


@pytest.mark.parametrize("case", [
    dict(), dict(offline="pooled", sparse=True),
    dict(offline="pooled", batch_size=36, pipeline=True)],
    ids=["on_demand", "pooled_sparse", "minibatch_pipe"])
def test_wired_gpu_fit_equals_unwired(cuda, case):
    """Over a LoopbackTransport the GPU fit pays the CommLog's online
    bytes and rounds and ends with the unwired fit's words; scoring over
    the same session too."""
    import threading
    from repro_torch.core import channel as C
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if case.get("sparse"):
        x *= RNG.random(x.shape) >= 0.7
    a, b = x[:, :4], x[:, 4:]
    km = SecureKMeans(KMeansConfig(k=3, iters=2, seed=2, **case))
    want = km.fit(a, b)
    ta, tb = C.LoopbackTransport.pair()
    th = threading.Thread(target=C.serve_peer, args=(tb,), daemon=True)
    th.start()
    ws = C.WireSession(C.ReliableChannel(ta))
    got = km.fit(a, b, wire=ws)
    assert ws.payload_bytes == got.log.total_bytes("online")
    assert ws.rounds == got.log.total_rounds("online")
    p_wired = km.score(a[:20], b[:20], wire=ws)
    ws.bye()
    th.join(timeout=30)
    _same_fit(got, want)
    p = km.score(a[:20], b[:20])
    for i in (0, 1):
        assert torch.equal(p_wired.scores[i], p.scores[i])


def test_gpu_service_restart_from_checkpointer(cuda, tmp_path):
    """A service on the card journals its drains; a restart from the same
    ServeCheckpointer replays the journaled responses and answers the rest
    with the words of a CPU service that never stopped."""
    from repro_torch.checkpoint.serve import ServeCheckpointer
    from repro_torch.serve import ScoringService
    cpu, gpu = _fitted_pair("vertical", False)
    batches = []
    for m in RNG.poisson(12, 8):
        q = RNG.normal(size=(int(m) + 1, 8)) + 4.0 * RNG.integers(0, 3, (1, 1))
        batches.append((q[:, :4], q[:, 4:]))
    kw = dict(rungs=(8, 32), d_a=4, d_b=4, provision_copies=2)

    def one_at_a_time(svc, reqs):
        out = {}
        for qa, qb in reqs:
            svc.submit(qa, qb)
            out.update({r.request_id: r for r in svc.drain()})
        return out

    ref_svc = ScoringService(cpu, **kw)
    ref = one_at_a_time(ref_svc, batches)
    d = str(tmp_path / "sck")
    svc = ScoringService(gpu, checkpointer=ServeCheckpointer(d), **kw)
    got = one_at_a_time(svc, batches[:4])
    del svc                                    # no close: a crash
    svc = ScoringService(gpu, checkpointer=ServeCheckpointer(d), **kw)
    assert svc.bank.device.type == "cuda"
    got.update({rid: svc.lookup(rid) for rid in got})
    got.update(one_at_a_time(svc, batches[4:]))
    assert svc.stats.requests == 4
    assert set(got) == set(ref)
    for rid, r in ref.items():
        np.testing.assert_array_equal(got[rid].labels, r.labels)
        np.testing.assert_array_equal(got[rid].scores, r.scores)
    assert svc.bank.consumed_counts() == ref_svc.bank.consumed_counts()


# ---------------------------------------------------------------------------
# tracing and metrics on the card
# ---------------------------------------------------------------------------

def _kernel_launches() -> dict:
    return {"ring_matmul": modmatmul.LAUNCHES,
            "ks_carry_share": ksadder.LAUNCHES, "spmm_ell": spmm.LAUNCHES}


@pytest.mark.parametrize("case", [
    dict(offline="on_demand"), dict(offline="pooled"),
    dict(offline="pooled", sparse=True),
    dict(offline="pooled", batch_size=40, pipeline=True)],
    ids=["dense-on-demand", "dense-pooled", "sparse-pooled", "minibatch"])
def test_traced_gpu_fit_equals_untraced(cuda, case):
    """Tracing on changes nothing on the card: a traced GPU fit has the
    untraced fit's words, counters, traffic and kernel launches, and the
    spans of a traced CPU fit of the same configuration."""
    from repro_torch.core import kmeans as KM
    from repro_torch.launch import kmeans_step as KS
    from repro_torch.obs import trace as _trace
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    if case.get("sparse"):
        x *= RNG.random(x.shape) >= 0.7
    a, b = x[:, :4], x[:, 4:]
    common = dict(k=3, iters=2, seed=2, **case)
    tracer = _trace.get_tracer()
    runs = {}
    try:
        for label, traced, kw in (("plain", False, {}), ("traced", True, {}),
                                  ("cpu", True, dict(backend="torch",
                                                     device="cpu"))):
            KM.clear_plan_cache()
            KS.clear_program_cache()
            tracer.reset()
            _trace.configure(enabled=traced)
            before = _kernel_launches()
            res = SecureKMeans(KMeansConfig(**common, **kw)).fit(a, b)
            torch.cuda.synchronize()
            after = _kernel_launches()
            runs[label] = (res, {n: after[n] - before[n] for n in after},
                           tracer.span_counts())
    finally:
        _trace.configure(enabled=False)
        tracer.reset()
    (plain, lp, sp), (traced, lt, st), (cpu, _, sc) = (
        runs["plain"], runs["traced"], runs["cpu"])
    _same_fit(traced, plain)
    _same_fit(traced, cpu)
    assert lt == lp and lt["ring_matmul"] > 0
    assert sp == {} and st == sc and st["fit"] == 1


def test_metrics_scrape_during_topup_answers_within_a_second(cuda):
    """`/metrics` and `/health` of a service on the card answer within a
    second while a replenisher tops its bank up: the gauges read the bank
    under its queue lock only, never waiting for a generation."""
    import threading
    import time
    import urllib.request

    from repro_torch.core.triples import BankReplenisher
    from repro_torch.obs import metrics as _metrics
    from repro_torch.serve import ScoringService
    _, gpu = _fitted_pair("vertical", False)
    svc = ScoringService(gpu, rungs=(8, 512), d_a=4, d_b=4,
                         provision_copies=1)
    svc.warm()
    reg = _metrics.MetricsRegistry()
    _metrics.register_service(svc, registry=reg)
    _metrics.register_bank(svc.bank, registry=reg)
    srv = _metrics.MetricsServer(port=0, registry=reg,
                                 health_cb=lambda: svc.health).start()
    # about 1 GB of 512-row calls: seconds of host generation
    rep = BankReplenisher(svc.bank, low_water=1, high_water=1000)
    th = threading.Thread(target=rep.poll_once, daemon=True)
    try:
        th.start()
        time.sleep(0.3)                    # the top-up is generating
        scrapes = []
        while th.is_alive():
            t0 = time.perf_counter()
            for path in ("/metrics", "/health"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}{path}",
                        timeout=5) as r:
                    assert r.status == 200
            scrapes.append((time.perf_counter() - t0, th.is_alive()))
        th.join()
    finally:
        srv.stop()
        svc.close()
    assert rep.topups >= 1 and rep.errors == 0
    during = [s for s, alive in scrapes if alive]
    assert during, "the top-up ended before a scrape completed"
    assert max(s for s, _ in scrapes) < 1.0


def test_numpy_backend_refuses_cuda_tensors(cuda):
    """The host backend never copies shares off the card on its own: CUDA
    words raise, naming the cuda backend."""
    from repro_torch.core.backend import NumpyBackend
    nb = NumpyBackend()
    a = _words((4, 3), cuda)
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        nb.ring_mm(a, a.T.contiguous())
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        nb.ring_mm(a.cpu(), a.T.contiguous())

