"""The public kernel API, the port of `repro/kernels/ops.py`: ring matmul,
fused distances, argmin one-hot and blocked-ELL sparse x dense, each backed
by a hand-written CUDA kernel.

Every entry point follows its tensors' device, as the kernel wrappers do: a
CPU tensor takes the plain PyTorch version, a CUDA tensor launches the
kernel or raises. Nothing falls back from one to the other.

What is not ported: the reference pads operands to 128-multiples for the
TPU's tiles and asserts that Y fits a 12 MB VMEM budget. Both are TPU
layout matters; the kernels mask their ragged edges and stage Y a tile at a
time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import argmin as _argmin
from repro_torch.kernels import esd as _esd
from repro_torch.kernels import modmatmul as _modmatmul
from repro_torch.kernels import spmm as _spmm

__all__ = ["ring_matmul", "esd", "argmin_onehot", "spmm", "spmm_from_dense"]

# (n, d) @ (d, k): int32 words mod 2^32, int64 words mod 2^64
ring_matmul = _modmatmul.ring_matmul

# host words of each device word type: (numpy type, the view that crosses)
_HOST_WORDS = {torch.float32: (np.float32, np.float32),
               torch.int32: (np.uint32, np.int32),
               torch.int64: (np.uint64, np.int64)}


def esd(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(n, d), (k, d) -> (n, k) f32 distances ||mu_j||^2 - 2 x_i . mu_j;
    the operands are taken as float32, as the reference casts them."""
    return _esd.esd(x.to(torch.float32), mu.to(torch.float32))


def argmin_onehot(d: torch.Tensor) -> torch.Tensor:
    """(n, k) distances -> (n, k) int32 one-hot of the first row minimum
    (a row holding a NaN gives all zeros); taken as float32."""
    return _argmin.argmin_onehot(d.to(torch.float32))


def spmm(blocks: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL sparse x dense -> (nrb*bm, k). The word type of blocks
    (and y, which must match) picks the product: float32, int32 words mod
    2^32 or int64 words mod 2^64. y's rows are zero-padded to a multiple of
    the tile width bk (zero rows add nothing)."""
    bk = blocks.shape[3]
    pad = (-y.shape[0]) % bk
    if pad:
        y = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
    return _spmm.spmm_ell(blocks, idx, counts, y)


def spmm_from_dense(x_dense, y: torch.Tensor, *, bm: int = 8,
                    bk: int = 128) -> torch.Tensor:
    """x_dense (n, d) @ y (d, k) -> (n, k) through a host-side blocked-ELL
    pack of x_dense (a numpy array or a tensor) and `spmm` on y's device.
    x_dense is taken in y's word type: float32, or ring words mod 2^32
    (int32 y) or 2^64 (int64 y)."""
    if y.dtype not in _HOST_WORDS:
        raise TypeError(f"spmm_from_dense takes y of float32, int32 or "
                        f"int64 words, got {y.dtype}")
    if isinstance(x_dense, torch.Tensor):
        x_dense = x_dense.detach().cpu().numpy()
    host, view = _HOST_WORDS[y.dtype]
    x = np.asarray(x_dense).astype(host).view(view)
    blocks, idx, counts = _spmm.dense_to_ell(x, bm=bm, bk=bk)
    dev = y.device
    out = spmm(torch.from_numpy(blocks).to(dev), torch.from_numpy(idx).to(dev),
               torch.from_numpy(counts).to(dev), y)
    return out[: x.shape[0]]
