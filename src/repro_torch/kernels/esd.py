"""Fused Euclidean-squared distance D'[i, j] = ||mu_j||^2 - 2 x_i . mu_j
(paper Eq. 3, F_ESD): x (n, d) f32, mu (k, d) f32 -> (n, k) f32.

Port of the Pallas TPU kernel `repro/kernels/esd.py:esd`. The CUDA kernel
is `csrc/esd.cu`; its header says what bounds it and how its two tiles
answer that. It computes the product in full FP32 FMAs, never TF32, and
accumulates ||mu_j||^2 from the same staged mu chunks that feed the product.
Beside it:

* `esd_plain` — the plain PyTorch version, the reference's oracle formula.
  On CUDA its matmul is full FP32 as long as
  `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default);
  whoever holds the kernel to it on the card sets that flag.
* `plan` — which tile a launch takes for k centroids.
* `esd` — the wrapper. A CPU tensor takes the plain version; a CUDA tensor
  launches the kernel or raises. `LAUNCHES` counts launches.

The reference's API pads n, d and k to 128-multiples for the TPU's
layout; the kernel masks its ragged edges instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `esd` on CUDA tensors

TILES = ((256, 8), (128, 128))   # (rows, centroids) of tile ids 0 and 1
SMALL_K = 32            # up to this many centroids take tile 0


def esd_plain(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """||mu_j||^2 - 2 x_i . mu_j in plain PyTorch, on any device."""
    return (mu * mu).sum(1)[None] - 2.0 * (x @ mu.T)


def plan(k: int) -> int:
    """Tile id for k centroids: 256 x 8 while few centroids leave a wide
    tile mostly empty (each block then streams its slab of x once per 8
    centroids), 128 x 128 beyond, where the FMAs bound the kernel."""
    return 0 if k <= SMALL_K else 1


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
    tile = plan(k)
    if -(-k // TILES[tile][1]) > 65535:           # CUDA's gridDim.y limit
        raise ValueError(f"esd: {k} centroids exceed one launch")
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    x = x.contiguous()
    mu = mu.contiguous()
    fn = _build.launcher("esd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mu.data_ptr(), out.data_ptr(), n, d, k, tile,
                 stream)
    _build.check(err, "esd")
    LAUNCHES += 1
    return out
