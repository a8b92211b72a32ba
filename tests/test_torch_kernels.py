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
from repro_torch.kernels import ksadder, modmatmul

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
                                   (2048, 42, 5), (5, 1, 3)])
def test_ring_matmul_plan_covers_k(shape):
    """Every K word falls in one chunk of the launch: the tall kernel's
    stages, the long-K kernel's chunks over its blocks, or the general
    tile's splits."""
    m, kdim, n = shape
    p = modmatmul.plan(m, kdim, n)
    if p.variant == "tall":
        assert p.chunk == kdim or p.chunk == modmatmul.TALL_KC
        assert p.blocks == -(-m // modmatmul.TALL_ROWS)
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


# (m, kdim, n, A transposed, B transposed, word bytes) -> (variant, operands
# copied), for every shape the fits and phase 5 of chip_smoke.py run, and
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
    ((500, 257, 8, False, False, 8), "general", 0),     # ... and of 2056
    ((300, 18, 9, False, False, 8), "general", 0),      # 9 columns
    ((1, 200, 7, False, False, 8), "longk", 0),         # one row: long-K
    ((1, 200, 7, False, True, 8), "tall", 0),           # ... B a view: tall
    ((8, 4096, 256, True, False, 8), "longk", 0),       # 8 x 256 outputs
    ((9, 4096, 24, False, False, 8), "general", 0),     # 9 rows
    ((8, 4096, 257, False, False, 8), "general", 0),    # 257 columns
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
    assert a2_t == (a_t and variant == "longk")
    assert b2_t == (b_t and variant == "tall")
    assert lda == (m if a2_t else kdim) and ldb == (kdim if b2_t else n)
    if variant == "longk":           # a stage of A and B rows in budget
        assert p.chunk * (m + n) * word <= max(
            modmatmul.LONG_STAGE_BYTES,
            modmatmul.LONG_MIN_KB * (m + n) * word)
    if variant == "tall":
        assert p.chunk <= max(modmatmul.TALL_ONE_STAGE_K, modmatmul.TALL_KC)


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
