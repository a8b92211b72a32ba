"""Z_{2^l} ring arithmetic with fixed-point encoding (paper: l=64, f=20).

A ring element is an int64 tensor: PyTorch has no uint64 arithmetic, and
int64 `+ - * @` and `<<` wrap mod 2^64 on two's-complement words, which is
exactly the ring reduction. The word is the same 64 bits the JAX package
holds as uint64; host data crosses as `np.uint64` viewed as `np.int64`
(`from_u64_numpy` / `to_u64_numpy`).

Two things differ from uint64 lanes and are handled here:

* `>>` on int64 is ARITHMETIC (sign-extending). Every uint64 `>>` of the
  protocol is logical, so it goes through `logical_rshift`.
* Python constants >= 2^63 do not fit int64; `to_i64` gives their
  two's-complement value.

Tensor shifts are spelled `lshift` / `torch.bitwise_right_shift`, never
`<<` / `>>`: those dispatch to `aten::__lshift__` / `__rshift__`, which
DTensor takes for in-place ops (the schema name ends in `_`) and answers
with the input's shard unchanged, so a sharded iteration would skip them.
The words are the same.
"""
from __future__ import annotations

import numpy as np
import torch

L = 64                    # ring bit width (paper Sec 5.1: l = 64)
F = 20                    # fractional bits  (paper Sec 5.1: 20 of 64 bits)
DTYPE = torch.int64
NP_DTYPE = np.uint64


def to_i64(v: int) -> int:
    """Python int in [0, 2^64) or [-2^63, 2^63) -> its int64 word value."""
    v = int(v) & ((1 << L) - 1)
    return v - (1 << L) if v >= 1 << (L - 1) else v


MASK = to_i64(0xFFFFFFFFFFFFFFFF)


def from_u64_numpy(x, device="cpu") -> torch.Tensor:
    """uint64 numpy words -> int64 ring tensor on `device` (same bits)."""
    x = np.array(x, np.uint64, order="C", copy=None)   # keeps 0-d arrays 0-d
    if not x.flags.writeable:      # a tensor must not alias read-only memory
        x = x.copy()
    return torch.from_numpy(x.view(np.int64)).to(device)


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the device: to a GPU
    through pinned memory with non_blocking=True. A pageable copy waits for
    every kernel already queued on the stream, which would serialise the
    host work of a pipelined loop behind the device's. The pinned block is
    not reused before its copy has run (PyTorch's host allocator records an
    event on it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_u64_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 ring tensor -> uint64 numpy words on the host (same bits)."""
    return t.detach().cpu().numpy().view(np.uint64)


def encode(x, f: int = F, device=None) -> torch.Tensor:
    """Real -> fixed-point ring element (two's complement mod 2^64).
    `torch.round` rounds half to even, like `jnp.round`."""
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    return torch.round(x * float(1 << f)).to(DTYPE)


def decode(u: torch.Tensor, f: int = F) -> torch.Tensor:
    """Fixed-point ring element -> real (interpret high bit as sign)."""
    return u.to(torch.float64) / float(1 << f)


def neg(u: torch.Tensor) -> torch.Tensor:
    return 0 - u


def logical_rshift(x: torch.Tensor, s: int) -> torch.Tensor:
    """uint64 `>>` on int64 words: shift, then clear the sign-filled bits."""
    if s == 0:
        return x
    if s >= L:
        return torch.zeros_like(x)
    return torch.bitwise_right_shift(x, s) & ((1 << (L - s)) - 1)


def arith_rshift(u: torch.Tensor, f: int) -> torch.Tensor:
    """Arithmetic (sign-extending) right shift on the two's-complement view."""
    return torch.bitwise_right_shift(u, f)


def lshift(x: torch.Tensor, s: int) -> torch.Tensor:
    """`x << s` mod 2^64."""
    return torch.bitwise_left_shift(x, s)


def from_int(x, device=None) -> torch.Tensor:
    """Integer -> ring element at scale 1 (no fractional bits)."""
    return torch.as_tensor(x, dtype=DTYPE, device=device)


def rand_np(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform ring elements as uint64 numpy words (share/triple draws)."""
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def nbytes(shape, l: int = L) -> int:
    """Bytes on the wire for a ring tensor of `shape`."""
    return int(np.prod(shape, dtype=np.int64)) * (l // 8)
