"""Fused Euclidean-squared distance D'[i, j] = ||mu_j||^2 - 2 x_i . mu_j
(paper Eq. 3, F_ESD): x (n, d) f32, mu (k, d) f32 -> (n, k) f32.

Port of the Pallas TPU kernel `repro/kernels/esd.py:esd`. The CUDA kernels
are in `csrc/esd.cu`; its header says what bounds them and how each
answers that: the narrow kernel (k <= 32, bound by reading x) multiplies
in FP32 FMAs; the wide one (bound by the multiply-adds) in 3 x TF32 on the
tensor cores, with FP32 totals, which holds the plain version's FP32 to the
reference tests' rtol 1e-5, atol 1e-3. Both accumulate ||mu_j||^2 in FP32
from the same staged mu chunks that feed the product. Beside it:

* `esd_plain` — the plain PyTorch version, the reference's oracle formula.
  On CUDA its matmul is full FP32 as long as
  `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default);
  whoever holds the kernel to it on the card sets that flag.
* `plan` — which kernel a launch takes for (d, k), and its centroid slots,
  d chunk and column tiles.
* `esd` — the wrapper. A CPU tensor takes the plain version; a CUDA tensor
  launches the kernel or raises. `LAUNCHES` counts launches.

The reference's API pads n, d and k to 128-multiples for the TPU's
layout; the kernel masks its ragged edges instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `esd` on CUDA tensors

SMALL_K = 32            # up to this many centroids take the narrow kernel
NARROW_SLOTS = (1, 2, 4, 8, 16, 32)   # its centroid slots (template KT)
NARROW_ONE_CHUNK_D = 64  # d staged whole up to this width, else in chunks
NARROW_DC = 32          # ... of at most this many words, d cut evenly
WIDE_COLS = 128         # centroids a block of the wide kernel
WIDE_DC = 32            # its d chunk (csrc/esd.cu kTcK)


class Plan(NamedTuple):
    tile: int           # 0: narrow, 1: wide
    slots: int          # centroids a block computes (KT, or WIDE_COLS)
    dc: int             # d words a stage (narrow: a multiple of 4)
    col_tiles: int      # blocks across the centroids


def esd_plain(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """||mu_j||^2 - 2 x_i . mu_j in plain PyTorch, on any device."""
    return (mu * mu).sum(1)[None] - 2.0 * (x @ mu.T)


def plan(d: int, k: int) -> Plan:
    """The narrow kernel up to SMALL_K centroids, where reading x bounds
    it: the fewest slots that hold k, and d in one stage up to
    NARROW_ONE_CHUNK_D words (rounded up to 4), else cut evenly into stages
    of at most NARROW_DC. The wide 128 x 128 tile beyond, where the
    multiply-adds bound it, with k cut into WIDE_COLS-centroid column
    tiles."""
    if k <= SMALL_K:
        slots = next(s for s in NARROW_SLOTS if s >= k)
        chunks = 1 if d <= NARROW_ONE_CHUNK_D else -(-d // NARROW_DC)
        dc = max(4, -(-(-(-d // chunks)) // 4) * 4)
        return Plan(0, slots, dc, 1)
    return Plan(1, WIDE_COLS, WIDE_DC, -(-k // WIDE_COLS))


def esd(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(n, d) f32, (k, d) f32 -> (n, k) f32 distances D'. CPU tensors: plain
    version. CUDA tensors: the hand kernel, or an exception."""
    if x.dim() != 2 or mu.dim() != 2 or x.shape[1] != mu.shape[1]:
        raise ValueError(f"esd needs x (n, d) and mu (k, d), got "
                         f"{tuple(x.shape)} and {tuple(mu.shape)}")
    if x.dtype != torch.float32 or mu.dtype != torch.float32:
        raise TypeError(f"esd takes float32, got {x.dtype} and {mu.dtype}")
    if x.device != mu.device:
        raise ValueError(f"operands on {x.device} and {mu.device}")
    if x.device.type == "cpu":
        return esd_plain(x, mu)
    if x.device.type != "cuda":
        raise ValueError(f"esd runs on cpu or cuda, not {x.device}")
    global LAUNCHES
    n, d = x.shape
    k = mu.shape[0]
    if n == 0 or k == 0:
        return torch.empty((n, k), dtype=torch.float32, device=x.device)
    p = plan(d, k)
    if p.col_tiles > 65535:                       # CUDA's gridDim.y limit
        raise ValueError(f"esd: {k} centroids exceed one launch")
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    x = x.contiguous()
    mu = mu.contiguous()
    fn = _build.launcher("esd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mu.data_ptr(), out.data_ptr(), n, d, k, p.tile,
                 p.slots, p.dc, stream)
    _build.check(err, "esd")
    LAUNCHES += 1
    return out
