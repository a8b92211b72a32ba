"""The reference's oracle names (`repro/kernels/ref.py`) for the port's
kernels: each is the plain PyTorch version that sits beside its kernel,
under the name the reference's tests call it by. No arithmetic lives here.

One oracle differs from the reference's on purpose: `argmin_onehot` is the
Pallas kernel's formula, so a row holding a NaN gives an all-zero one-hot
row, where the reference's `jnp.argmin` oracle points at the NaN
(`kernels/argmin.py`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.argmin import argmin_onehot_plain as argmin_onehot
from repro_torch.kernels.esd import esd_plain as esd
from repro_torch.kernels.modmatmul import ring_matmul_plain
from repro_torch.kernels.spmm import spmm_ell_plain

__all__ = ["modmatmul_u32", "modmatmul_u64", "esd", "argmin_onehot",
           "spmm_ell"]

# the word type picks the ring: int32 words mod 2^32, int64 words mod 2^64
modmatmul_u32 = ring_matmul_plain
modmatmul_u64 = ring_matmul_plain


def spmm_ell(blocks: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
             y: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Blocked-ELL sparse x dense, the first n_rows rows of (nrb*bm, k)."""
    return spmm_ell_plain(blocks, idx, counts, y)[:n_rows]
