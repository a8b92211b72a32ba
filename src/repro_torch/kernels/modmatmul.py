"""Ring matmul (n, d) @ (d, k) mod 2^64 on int64 words, or mod 2^32 on
int32 words.

Port of the Pallas TPU kernel `repro/kernels/modmatmul.py:modmatmul`, both
bodies (`_kernel_u64`, `_kernel_u32`). The CUDA kernel is
`csrc/modmatmul.cu`, one template on the word type; its header says what
bounds it and how its tiling and split-K answer that. u32 words are int32
tensors, as u64 words are int64 ones: int32 `+ - * @` wrap mod 2^32 on the
CPU, and PyTorch has no `add` for uint32. Beside it:

* `ring_matmul_plain` — the plain PyTorch version. On the CPU integer `@`
  wraps mod 2^l; on CUDA `torch.matmul` refuses integer words, so there it
  is a broadcast multiply-and-sum over K chunks.
* `ring_matmul` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. `LAUNCHES` counts launches on
  int64 words, `LAUNCHES_U32` on int32 words.

The main path passes transposed and sliced views (`mu.s0.T`, `c.s0.T`,
`mut.s0[:da]`); the wrapper makes `.contiguous()` copies of them, which the
kernel then reads row-major.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `ring_matmul` on int64 words
LAUNCHES_U32 = 0        # ... on int32 words (the mod-2^32 ring)
WORD_BITS = {torch.int64: 64, torch.int32: 32}

BK = 16                 # K chunk staged in shared memory (csrc/modmatmul.cu)
TILES = ((128, 8), (8, 32))   # (BM, BN) of tile ids 0 and 1
TARGET_BLOCKS = 4 * 132  # enough blocks to fill an H100's 132 SMs
MIN_K_PER_SPLIT = 4 * BK


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, k) mod 2^l in plain PyTorch, on any device: l = 64 on
    int64 words, 32 on int32 words."""
    if a.device.type == "cpu":
        return a @ b
    return _broadcast_matmul(a, b)


def _broadcast_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over d of the broadcast products a[:, d, None] * b[None, d, :],
    for devices whose matmul refuses integer words. The sums keep the word
    type (an int32 `sum` would otherwise promote to int64)."""
    n, d = a.shape
    k = b.shape[1]
    out = torch.zeros((n, k), dtype=a.dtype, device=a.device)
    # bound the (n, chunk, k) broadcast product to ~2^25 words
    chunk = max(1, (1 << 25) // max(1, n * k))
    for lo in range(0, d, chunk):
        hi = min(d, lo + chunk)
        out += (a[:, lo:hi, None] * b[None, lo:hi, :]).sum(1, dtype=a.dtype)
    return out


def plan(m: int, kdim: int, n: int) -> tuple[int, int, int]:
    """(tile id, K words per split, number of splits) for an (m, kdim) @
    (kdim, n) product: the tile that wastes the fewest padded outputs, and
    K split so that about TARGET_BLOCKS blocks are in flight."""
    def padded(t):
        bm, bn = TILES[t]
        return -(-m // bm) * bm * (-(-n // bn) * bn)

    tile = min(range(len(TILES)), key=padded)
    bm, bn = TILES[tile]
    tiles = -(-m // bm) * -(-n // bn)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles),
                        -(-kdim // MIN_K_PER_SPLIT)))
    k_per_split = -(-kdim // splits)
    k_per_split = -(-k_per_split // BK) * BK
    splits = -(-kdim // k_per_split)
    return tile, k_per_split, splits


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, k) mod 2^64 on int64 words, mod 2^32 on int32 words.
    CPU tensors: plain version. CUDA tensors: the hand kernel, or an
    exception."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ring_matmul needs (n, d) @ (d, k), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in WORD_BITS or b.dtype != a.dtype:
        raise TypeError(f"ring_matmul takes int64 (mod 2^64) or int32 "
                        f"(mod 2^32) ring words, both of one type; got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return ring_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"ring_matmul runs on cpu or cuda, not {a.device}")
    global LAUNCHES, LAUNCHES_U32
    m, kdim = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0 or kdim == 0:
        return out
    a = a.contiguous()
    b = b.contiguous()
    tile, k_per_split, splits = plan(m, kdim, n)
    if -(-n // TILES[tile][1]) > 65535:          # CUDA's gridDim.y limit
        raise ValueError(f"ring_matmul: {n} output columns exceed one launch")
    fn = _build.launcher("modmatmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, kdim, n,
                 tile, k_per_split, splits, WORD_BITS[a.dtype], stream)
    _build.check(err, "ring_matmul")
    if a.dtype == torch.int64:
        LAUNCHES += 1
    else:
        LAUNCHES_U32 += 1
    return out
