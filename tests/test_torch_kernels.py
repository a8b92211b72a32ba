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
    with pytest.raises(ValueError):
        modmatmul.ring_matmul(_t(_words((4, 3))), _t(_words((4, 2))))
    with pytest.raises(TypeError):
        modmatmul.ring_matmul(torch.zeros(4, 3), torch.zeros(3, 2))


@pytest.mark.parametrize("shape", [(100_000, 18, 5), (100_000, 24, 5),
                                   (5, 100_000, 18), (5, 100_000, 24),
                                   (1, 200, 7), (129, 129, 129),
                                   (2048, 42, 5), (5, 1, 3)])
def test_ring_matmul_plan_covers_k(shape):
    m, kdim, n = shape
    tile, k_per_split, splits = modmatmul.plan(m, kdim, n)
    bm, bn = modmatmul.TILES[tile]
    assert k_per_split % modmatmul.BK == 0
    assert (splits - 1) * k_per_split < kdim <= splits * k_per_split
    tiles = -(-m // bm) * -(-n // bn)
    assert tiles * splits <= 2 * modmatmul.TARGET_BLOCKS or splits == 1
    if m >= 1000 and n <= 8:
        assert (bm, bn) == (128, 8) and splits == 1     # tall-skinny
    if m <= 8 and kdim >= 1000:
        assert (bm, bn) == (8, 32) and splits > 100     # long-K: split K


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
