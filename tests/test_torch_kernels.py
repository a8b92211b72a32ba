"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and its XLA
backend, word for word, plus the wrappers' CPU routing and launch planning.
The kernels themselves run on the GPU only (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import KS_LEVELS as J_LEVELS
from repro.core.backend import PallasBackend, XlaBackend, _ks_fused_generic
from repro.kernels import ops as jops
from repro.kernels.ksadder import ks_carry_share as j_ks_carry_share
from repro_torch.core import ring
from repro_torch.core.backend import (CudaBackend, RingBackend, TorchBackend,
                                      get_backend)
from repro_torch.core.sharing import AShare
from repro_torch.core.triples import MulTriple
from repro_torch.kernels import ksadder, modmatmul, newton

RNG = np.random.default_rng(31)


def _words(shape):
    return RNG.integers(0, 1 << 64, shape, dtype=np.uint64)


def _wrap_heavy(shape):
    return np.uint64(0xFFFFFFFFFFFFFFFF) - RNG.integers(0, 1 << 20, shape,
                                                        dtype=np.uint64)


def _t(x):
    return ring.from_u64_numpy(x)


# ---------------------------------------------------------------------------
# ring_matmul
# ---------------------------------------------------------------------------

MM_CASES = [((1, 200, 7), _words), ((129, 129, 129), _words),
            ((5, 3000, 24), _words), ((40, 33, 7), _wrap_heavy)]


@pytest.mark.parametrize("case", MM_CASES,
                         ids=["1x200x7", "129^3", "longK", "wrap_heavy"])
def test_ring_matmul_plain_matches_reference(case):
    (n, d, k), draw = case
    a, b = draw((n, d)), draw((d, k))
    want_pallas = np.asarray(jops.ring_matmul(jnp.asarray(a), jnp.asarray(b),
                                              interpret=True), np.uint64)
    want_xla = np.asarray(XlaBackend().ring_mm(a, b), np.uint64)
    np.testing.assert_array_equal(want_pallas, want_xla)
    for got in (modmatmul.ring_matmul_plain(_t(a), _t(b)),
                modmatmul._broadcast_matmul(_t(a), _t(b)),
                modmatmul.ring_matmul(_t(a), _t(b)),
                TorchBackend().ring_mm(_t(a), _t(b))):
        np.testing.assert_array_equal(ring.to_u64_numpy(got), want_pallas)


def test_ring_matmul_wraps_against_bigint_oracle():
    a, b = _wrap_heavy((6, 33)), _wrap_heavy((33, 4))
    got = ring.to_u64_numpy(modmatmul.ring_matmul(_t(a), _t(b)))
    i, j = 3, 2
    want = sum(int(a[i, t]) * int(b[t, j]) for t in range(33))
    assert want >= 1 << 64
    assert int(got[i, j]) == want % (1 << 64)


def test_ring_matmul_takes_views_on_cpu():
    """The main path hands in transposed and sliced views."""
    a, b = _words((7, 40)), _words((9, 40))
    ta, tb = _t(a), _t(b)
    got = modmatmul.ring_matmul(ta[:, 3:], tb.T[3:])
    want = np.einsum("ij,jk->ik", a[:, 3:], b.T[3:], dtype=np.uint64,
                     casting="unsafe")
    np.testing.assert_array_equal(ring.to_u64_numpy(got), want)


def test_ring_matmul_launches_nothing_on_cpu():
    before = modmatmul.LAUNCHES
    modmatmul.ring_matmul(_t(_words((4, 3))), _t(_words((3, 2))))
    assert modmatmul.LAUNCHES == before


def test_ring_matmul_rejects_bad_operands():
    """Mixed and unsupported word types are refused; int64 (mod 2^64) and
    int32 (mod 2^32) words are taken, each keeping its type."""
    with pytest.raises(ValueError):
        modmatmul.ring_matmul(_t(_words((4, 3))), _t(_words((4, 2))))
    with pytest.raises(TypeError):
        modmatmul.ring_matmul(torch.zeros(4, 3), torch.zeros(3, 2))
    with pytest.raises(TypeError):
        modmatmul.ring_matmul(_t(_words((4, 3))).to(torch.int32),
                              _t(_words((3, 2))))
    with pytest.raises(TypeError):
        modmatmul.ring_matmul(torch.zeros(4, 3, dtype=torch.int16),
                              torch.zeros(3, 2, dtype=torch.int16))
    a32 = torch.from_numpy(RNG.integers(0, 1 << 32, (4, 3), dtype=np.uint32)
                           .view(np.int32))
    b32 = torch.from_numpy(RNG.integers(0, 1 << 32, (3, 2), dtype=np.uint32)
                           .view(np.int32))
    got = modmatmul.ring_matmul(a32, b32)
    assert got.dtype == torch.int32
    want = np.einsum("ij,jk->ik", a32.numpy().view(np.uint32),
                     b32.numpy().view(np.uint32), dtype=np.uint32,
                     casting="unsafe")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("shape", [(100_000, 18, 5), (100_000, 24, 5),
                                   (5, 100_000, 18), (5, 100_000, 24),
                                   (1, 200, 7), (129, 129, 129),
                                   (2048, 42, 5), (5, 1, 3),
                                   (16, 524_288, 512), (524_288, 512, 16),
                                   (16, 1_048_576, 512), (1_048_576, 512, 16),
                                   (9, 4096, 513), (16, 8, 600),
                                   (1001, 17, 12)])
def test_ring_matmul_plan_covers_k(shape):
    """Every K word falls in one chunk of the launch: the tall kernels'
    stages, the long-K kernels' chunks over their blocks, or the general
    tile's splits."""
    m, kdim, n = shape
    p = modmatmul.plan(m, kdim, n)
    if p.variant == "tall":
        assert p.chunk == kdim or p.chunk == modmatmul.TALL_KC
        assert p.blocks == -(-m // modmatmul.TALL_ROWS)
    elif p.variant == "tallw":       # one block an SM walks the row slabs
        assert p.chunk == modmatmul.TALLW_KC
        assert p.blocks == min(modmatmul.SMS, -(-m // modmatmul.TALLW_ROWS))
    elif p.variant == "longw":       # chunk ch goes to split ch % blocks
        chunks = -(-kdim // p.chunk)
        slabs = -(-n // modmatmul.LONGW_SLAB)
        assert p.chunk == modmatmul.LONGW_KB and 1 <= p.blocks <= chunks
        assert p.blocks * slabs <= modmatmul.LONGW_BLOCKS or p.blocks == 1
    elif p.variant == "longk":
        chunks = -(-kdim // p.chunk)
        assert p.blocks <= modmatmul.LONG_MAX_BLOCKS
        per_block = -(-chunks // p.blocks)
        assert (p.blocks - 1) * per_block < chunks <= p.blocks * per_block
    else:
        bm, bn = modmatmul.TILES[p.tile]
        assert p.chunk % modmatmul.BK == 0
        assert (p.blocks - 1) * p.chunk < kdim <= p.blocks * p.chunk
        tiles = -(-m // bm) * -(-n // bn)
        assert tiles * p.blocks <= 2 * modmatmul.TARGET_BLOCKS or p.blocks == 1
    if m >= 1000 and n <= 8:
        assert p.variant == "tall"                       # tall-skinny
    if m <= 8 and kdim >= 1000:
        assert p.variant == "longk" and p.blocks > 100   # long-K: split K
    if m <= 16 and kdim >= 1000 and 256 < n <= 2048:
        assert p.variant == "longw" and p.blocks > 100   # ... and wide
    if m >= 1000 and 8 < n <= 16 and kdim <= modmatmul.TALLW_MAX_K:
        assert p.variant == "tallw"                      # tall and wide


# (m, kdim, n, A transposed, B transposed, word bytes) -> (variant, operands
# copied), for every shape the fits, phase 5 and the kmeans-fraud cell
# (phase 10) of chip_smoke.py run, each variant's limits on both sides, and
# the general tile's
PLAN_CASES = [
    ((100_000, 18, 5, False, True, 8), "tall", 0),      # X_A @ mu^T slices
    ((100_000, 24, 5, False, False, 8), "tall", 0),     # Beaver u @ f
    ((5, 100_000, 18, True, False, 8), "longk", 0),     # C^T X_A, c.s0.T
    ((5, 100_000, 24, False, False, 8), "longk", 0),    # Beaver e @ (v + f)
    ((100_000, 128, 3, False, True, 8), "tall", 0),     # sparse local X mu^T
    ((3, 100_000, 128, True, False, 8), "longk", 0),    # sparse local C^T X
    ((100_000, 18, 5, False, False, 4), "tall", 0),     # phase 5, u32
    ((5, 100_000, 24, False, False, 4), "longk", 0),    # phase 5, u32
    ((1024, 512, 128, False, False, 4), "general", 0),  # phase 5, u32
    ((129, 129, 129, False, False, 8), "general", 0),
    ((100_000, 18, 5, True, False, 8), "general", 1),   # tall: A row-major
    ((5, 3000, 18, False, True, 8), "general", 1),      # long-K: B row-major
    ((500, 256, 8, False, False, 8), "tall", 0),        # B of 2048 words
    ((500, 257, 8, False, False, 8), "tallw", 0),       # ... and of 2056
    ((300, 18, 9, False, False, 8), "tallw", 0),        # 9 columns
    ((1, 200, 7, False, False, 8), "longk", 0),         # one row: long-K
    ((1, 200, 7, False, True, 8), "tall", 0),           # ... B a view: tall
    ((8, 4096, 256, True, False, 8), "longk", 0),       # 8 x 256 outputs
    ((9, 4096, 24, False, False, 8), "general", 0),     # 9 rows
    ((8, 4096, 257, False, False, 8), "longw", 0),      # 257 columns
    # the kmeans-fraud cell, 10a (n = 524,288): C^T X_A and Beaver e @ f,
    # X @ mu^T slices and Beaver u @ f; 10b (the full n)
    ((16, 524_288, 512, False, False, 8), "longw", 0),  # A row-major
    ((16, 524_288, 512, True, False, 8), "longw", 0),   # c.s0.T
    ((524_288, 512, 16, False, False, 8), "tallw", 0),  # B row-major
    ((524_288, 512, 16, False, True, 8), "tallw", 0),   # mu.s0.T, mu slices
    ((16, 1_048_576, 512, True, False, 8), "longw", 0),
    ((1_048_576, 512, 16, False, True, 8), "tallw", 0),
    # long-K wide: rows 16 / 17, columns 256 / 257 and LONGW_MAX_N / + 1,
    # one slab / two; B transposed is copied by the general tile
    ((16, 4096, 300, True, False, 8), "longw", 0),
    ((17, 4096, 300, True, False, 8), "general", 1),
    ((16, 4096, 256, False, False, 8), "general", 0),
    ((16, 4096, 257, False, False, 8), "longw", 0),
    ((9, 4096, 2048, False, False, 8), "longw", 0),
    ((9, 4096, 2049, False, False, 8), "general", 0),
    ((9, 4096, 512, False, False, 4), "longw", 0),
    ((9, 4096, 513, False, False, 4), "longw", 0),
    ((16, 4096, 512, False, True, 8), "general", 1),
    # tall wide: columns 16 / 17, B rows TALLW_MAX_K / + 1; A transposed is
    # copied by the general tile
    ((3000, 64, 16, False, True, 8), "tallw", 0),
    ((3000, 64, 17, False, True, 8), "general", 1),
    ((3000, 640, 16, False, False, 8), "tallw", 0),
    ((3000, 641, 16, False, False, 8), "general", 0),
    ((3000, 640, 16, True, False, 4), "general", 1),
    ((3000, 512, 5, False, True, 8), "tallw", 0),      # narrow N, K*N > 2048
]


def _meta_operand(rows, cols, transposed, dtype):
    """A (rows, cols) operand with no storage: row-major, or the transposed
    view of a row-major (cols, rows) matrix."""
    if transposed:
        return torch.empty((cols, rows), dtype=dtype, device="meta").T
    return torch.empty((rows, cols), dtype=dtype, device="meta")


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0][0]}x{c[0][1]}x{c[0][2]}"
                              f"-{'T' if c[0][3] else 'R'}"
                              f"{'T' if c[0][4] else 'R'}-u{8 * c[0][5]}"
                              for c in PLAN_CASES])
def test_ring_matmul_plan_picks_the_variant(case):
    """The variant each shape and layout takes, and the operands `prepare`
    copies because that variant cannot read them (the general tile reads
    only row-major operands)."""
    (m, kdim, n, a_t, b_t, word), variant, copied = case
    p = modmatmul.plan(m, kdim, n, a_t, b_t, word)
    assert p.variant == variant
    dtype = torch.int64 if word == 8 else torch.int32
    a = _meta_operand(m, kdim, a_t, dtype)
    b = _meta_operand(kdim, n, b_t, dtype)
    copies = modmatmul.COPIES
    p2, (a2, a2_t, lda), (b2, b2_t, ldb) = modmatmul.prepare(a, b)
    assert p2 == p and modmatmul.COPIES == copies + copied
    assert (a2 is a) + (b2 is b) == 2 - copied
    assert a2_t == (a_t and variant in ("longk", "longw"))
    assert b2_t == (b_t and variant in ("tall", "tallw"))
    assert lda == (m if a2_t else kdim) and ldb == (kdim if b2_t else n)
    if variant == "longk":           # a stage of A and B rows in budget
        assert p.chunk * (m + n) * word <= max(
            modmatmul.LONG_STAGE_BYTES,
            modmatmul.LONG_MIN_KB * (m + n) * word)
    if variant == "tall":
        assert p.chunk <= max(modmatmul.TALL_ONE_STAGE_K, modmatmul.TALL_KC)
    if variant == "longw":           # every row of C in one block
        assert m <= modmatmul.LONGW_MAX_M and p.chunk == modmatmul.LONGW_KB
    if variant == "tallw":           # B staged whole
        assert kdim <= modmatmul.TALLW_MAX_K and n <= modmatmul.TALLW_MAX_N
        assert p.chunk == modmatmul.TALLW_KC and not p.zeroed


@pytest.mark.parametrize("sparse", [False, True], ids=["10a", "10b"])
def test_kmeans_cell_products_take_the_wide_variants(monkeypatch, sparse):
    """The kmeans-fraud iteration at the production widths (d = 1024, d_a =
    512, k = 16; n cut to 64, which no plan of these shapes reads): every
    ring product it hands ring_mm, with its own operand layouts, plans to
    a wide variant that reads both operands in place (COPIES unchanged):
    10a's 20 products, 10b's 4."""
    from repro_torch.configs.kmeans_fraud import FULL
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.launch import kmeans_step as KS
    seen = []
    plain = modmatmul.ring_matmul_plain

    def spy(a, b):
        copies = modmatmul.COPIES
        p, (a2, _, _), (b2, _, _) = modmatmul.prepare(a, b)
        seen.append((tuple(a.shape), tuple(b.shape), p.variant,
                     a2 is a and b2 is b and modmatmul.COPIES == copies))
        return plain(a, b)

    monkeypatch.setattr(modmatmul, "ring_matmul_plain", spy)
    n, d, k, d_a = 64, FULL.d, FULL.k, FULL.d_a
    flat = KS.materialize_offline(
        KS.record_offline_shapes(n, d, k, d_a, sparse=sparse),
        TrustedDealer(seed=1, device="cpu"))
    fn, _ = KS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                   backend="torch", device="cpu")
    he = [_t(_words(s)) for s in [(n, k), (n, k), (k, d_a), (k, d - d_a)]
          for _ in (0, 1)] if sparse else []
    seen.clear()                     # the dealer's own products
    fn(_t(_words((n, d_a))), _t(_words((n, d - d_a))), _t(_words((k, d))),
       _t(_words((k, d))), *he, *flat)
    longw = [s for s in seen if s[:2] == ((k, n), (n, d_a))]
    tallw = [s for s in seen if s[:2] == ((n, d_a), (d_a, k))]
    assert len(longw) + len(tallw) == len(seen) == (4 if sparse else 20)
    assert len(longw) == (2 if sparse else 10)
    assert all(v == "longw" and same for *_, v, same in longw)
    assert all(v == "tallw" and same for *_, v, same in tallw)


def _fit_views():
    """The views core/kmeans.py hands ring_mm (n = 1000, k = 5, d_a = 18,
    d_b = 24): c.s0.T, mu.s0.T, mut.s0[:da], mut.s1[da:], a contiguous
    share, and a row slice of a wider matrix."""
    c = _t(_words((1000, 5)))
    mu = _t(_words((5, 42)))
    mut = mu.T
    return {"c.s0.T": (c.T, (True, 5)), "mu.s0.T": (mu.T, (True, 42)),
            "mut.s0[:da]": (mut[:18], (True, 42)),
            "mut.s1[da:]": (mut[18:], (True, 42)),
            "x": (c, (False, 5)), "x[:, 1:3]": (c[:, 1:3], (False, 5)),
            "row": (c[:1], (False, 5))}


@pytest.mark.parametrize("name", ["c.s0.T", "mu.s0.T", "mut.s0[:da]",
                                  "mut.s1[da:]", "x", "x[:, 1:3]", "row"])
def test_ring_matmul_reads_the_fits_views_in_place(name):
    """Every layout the fit passes is described, so the wrapper hands the
    tensor itself (storage offset included) to the kernel: no copy."""
    t, want = _fit_views()[name]
    assert modmatmul.layout(t) == want
    copies = modmatmul.COPIES
    same, trans, ld = modmatmul._operand(t, modmatmul.layout(t), True)
    assert same is t and (trans, ld) == want
    assert modmatmul.COPIES == copies
    r, c = t.shape
    base = t.data_ptr()
    for i, j in ((r - 1, 0), (0, c - 1), (r - 1, c - 1)):
        off = j * ld + i if trans else i * ld + j
        assert t[i, j].data_ptr() == base + 8 * off


def test_ring_matmul_copies_only_what_no_layout_describes():
    """A broadcast (stride 0) and a strided column view are copied and
    counted; nothing else is."""
    copies = modmatmul.COPIES
    for t in (_t(_words((1, 24))).expand(300, 24), _t(_words((40, 6)))[:, ::2]):
        assert modmatmul.layout(t) is None
        got, trans, ld = modmatmul._operand(t, None, True)
        assert got.is_contiguous() and not trans and ld == t.shape[1]
        assert torch.equal(got, t)
    assert modmatmul.COPIES == copies + 2


# ---------------------------------------------------------------------------
# ks_carry_share
# ---------------------------------------------------------------------------

def _ks_inputs(shape):
    flat = [_words(shape) for _ in range(6)]
    lvls = [_words((len(J_LEVELS), 2) + shape) for _ in range(5)]
    return flat, lvls


@pytest.mark.parametrize("shape", [(16, 8), (3,), (1, 1), ()])
@pytest.mark.parametrize("party0", [True, False])
def test_ks_carry_share_plain_matches_reference(shape, party0):
    assert ksadder.LEVELS == J_LEVELS
    flat, lvls = _ks_inputs(shape)
    want = np.asarray(_ks_fused_generic(*flat, *lvls, party0), np.uint64)
    want_pallas = np.asarray(PallasBackend(interpret=True).ks_fused(
        *[jnp.asarray(t) for t in flat + lvls], party0=party0), np.uint64)
    np.testing.assert_array_equal(want_pallas, want)
    args = [_t(t) for t in flat + lvls]
    for got in (ksadder.ks_carry_share_plain(*args, party0=party0),
                ksadder.ks_carry_share(*args, party0=party0),
                TorchBackend().ks_fused(*args, party0=party0)):
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(ring.to_u64_numpy(got), want)


@pytest.mark.parametrize("party0", [True, False])
def test_ks_carry_share_plain_matches_pallas_kernel_direct(party0):
    """The Pallas kernel itself, at a block-aligned (n, m) = (8, 128)."""
    flat, lvls = _ks_inputs((8, 128))
    want = np.asarray(j_ks_carry_share(
        *[jnp.asarray(t) for t in flat + lvls], party0=party0, bm=8, bn=128,
        interpret=True), np.uint64)
    got = ksadder.ks_carry_share_plain(*[_t(t) for t in flat + lvls],
                                       party0=party0)
    np.testing.assert_array_equal(ring.to_u64_numpy(got), want)


def test_ks_carry_share_ignores_x_and_slot1():
    flat, lvls = _ks_inputs((5, 3))
    args = [_t(t) for t in flat + lvls]
    base = ksadder.ks_carry_share(*args, party0=True)
    args[0] = args[0] ^ -1                        # x
    for li in range(6, 11):                        # slot 1 of every stack
        args[li] = args[li].clone()
        args[li][:, 1] ^= 12345
    assert torch.equal(ksadder.ks_carry_share(*args, party0=True), base)


def test_ks_level_stride_reads_slot0_in_place():
    t = _t(_words((6, 2, 4, 3)))
    same, stride = ksadder._level_stride(t, (4, 3), "el")
    assert same.data_ptr() == t.data_ptr() and stride == 24
    view = _t(_words((6, 3, 4, 3)))[:, :2]         # level stride 36, not 24
    same, stride = ksadder._level_stride(view, (4, 3), "el")
    assert same.data_ptr() == view.data_ptr() and stride == 36
    with pytest.raises(ValueError):
        ksadder._level_stride(t, (3, 4), "el")


# ---------------------------------------------------------------------------
# backend resolution
# ---------------------------------------------------------------------------

def test_get_backend_resolution():
    assert get_backend("torch").name == "torch"
    inst = TorchBackend()
    assert get_backend(inst) is inst
    with pytest.raises(ValueError):
        get_backend("xla")
    # the sparse ops are implemented by both backends; the seam's base
    # class still declares them abstract
    assert inst.ring_spmm.__func__ is not RingBackend.ring_spmm
    with pytest.raises(NotImplementedError):
        RingBackend().ring_spmm(None, None, None, None)


def test_cuda_backend_refuses_cpu(monkeypatch):
    """Without a GPU the cuda backend raises instead of running on the CPU;
    with one it still refuses CPU tensors."""
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            CudaBackend().ring_mm(_t(_words((2, 2))), _t(_words((2, 2))))
        return
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        CudaBackend()
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        get_backend("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    backend = CudaBackend()
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        backend.ring_mm(_t(_words((2, 2))), _t(_words((2, 2))))
    flat, lvls = _ks_inputs((3,))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        backend.ks_fused(*[_t(t) for t in flat + lvls], party0=True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        backend.ring_spmm(_t(_words((1, 1, 8, 128))),
                          torch.zeros((1, 1), dtype=torch.int32),
                          torch.ones((1,), dtype=torch.int32),
                          _t(_words((128, 3))))


# ---------------------------------------------------------------------------
# the reciprocal's Newton loop
# ---------------------------------------------------------------------------

def _newton_operands(k, iters):
    def share():
        return AShare(_t(_words((k,))), _t(_words((k,))))
    return share(), share(), [MulTriple(share(), share(), share())
                              for _ in range(2 * iters)]


def _bad_newton_case(case):
    """(dp, x0, triples, f, iters) with one fault, named by `case`."""
    dp, x0, triples = _newton_operands(5, 3)
    f, iters = 20, 3
    if case == "negative_iters":
        iters, triples = -1, []
    elif case == "f_too_large":
        f = 62
    elif case == "negative_f":
        f = -1
    elif case == "triple_count":
        triples = triples[:-1]
    elif case == "triple_shape":
        t = triples[3]
        triples[3] = t._replace(z=AShare(t.z.s0, _t(_words((6,)))))
    elif case == "x0_shape":
        x0 = AShare(_t(_words((5, 1))), x0.s1)
    elif case == "int32_words":
        dp = AShare(dp.s0.to(torch.int32), dp.s1)
    elif case == "two_devices":
        dp = AShare(dp.s0.to("meta"), dp.s1)
    return dp, x0, triples, f, iters


@pytest.mark.parametrize("case", ["negative_iters", "f_too_large",
                                  "negative_f", "triple_count",
                                  "triple_shape", "x0_shape", "int32_words",
                                  "two_devices"])
def test_newton_recip_plain_refuses_bad_operands(case):
    dp, x0, triples, f, iters = _bad_newton_case(case)
    err = TypeError if case == "int32_words" else ValueError
    with pytest.raises(err):
        newton.newton_recip_plain(dp, x0, triples, f=f, iters=iters)


@pytest.mark.parametrize("iters", [0, 1, 4])
def test_newton_recip_takes_the_plain_version_on_cpu(iters):
    dp, x0, triples = _newton_operands(7, iters)
    before = newton.LAUNCHES
    got = newton.newton_recip(dp, x0, triples, f=20, iters=iters)
    want = newton.newton_recip_plain(dp, x0, triples, f=20, iters=iters)
    assert newton.LAUNCHES == before
    assert torch.equal(got.s0, want.s0) and torch.equal(got.s1, want.s1)


def test_newton_recip_by_backend(monkeypatch):
    """The torch backend runs the plain loop and names it so; the cuda
    backend names the kernel and refuses CPU tensors (with or without a
    GPU)."""
    dp, x0, triples = _newton_operands(3, 2)
    got = TorchBackend().newton_recip(dp, x0, triples, f=20, iters=2)
    want = newton.newton_recip_plain(dp, x0, triples, f=20, iters=2)
    assert torch.equal(got.s0, want.s0) and torch.equal(got.s1, want.s1)
    assert (TorchBackend.newton_impl, CudaBackend.newton_impl) == (
        "plain", "kernel")
    with pytest.raises(NotImplementedError):
        RingBackend().newton_recip(dp, x0, triples, f=20, iters=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        CudaBackend().newton_recip(dp, x0, triples, f=20, iters=2)
