"""Fused row argmin -> one-hot: (n, k) f32 distances -> (n, k) int32 with
one 1 per row at the first minimum (paper F^k_min, Fig. 1, on the plaintext
path).

Port of the Pallas TPU kernel `repro/kernels/argmin.py:argmin_onehot`. The
CUDA kernel is `csrc/argmin.cu`; its header says what bounds it and how its
row groups answer that. Both follow the Pallas kernel's min-reduce,
compare and first-hit mask, not the reference's `jnp.argmin` oracle
(`repro/kernels/ref.py`), and the two differ on one input:

* ties go to the first column, and -0.0 ties +0.0;
* a row of +inf gives column 0;
* a row holding a NaN has a NaN minimum that equals nothing, so its
  one-hot row is all zeros (the oracle's `jnp.argmin` points at the NaN).

Beside it:

* `argmin_onehot_plain` — the plain PyTorch version of that formula.
* `argmin_onehot` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. `LAUNCHES` counts launches.

The reference's API pads rows with +inf to a multiple of 128 for the TPU's
layout; the kernel masks the ragged edge instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `argmin_onehot` on CUDA tensors


def argmin_onehot_plain(d: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's formula in plain PyTorch, on any device."""
    n, k = d.shape
    if k == 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=d.device)
    mins = d.amin(1, keepdim=True)                 # NaN if the row has one
    col = torch.arange(k, device=d.device)[None, :]
    first = torch.where(d == mins, col, k).amin(1, keepdim=True)
    return (col == first).to(torch.int32)


def group(k: int) -> int:
    """Lanes per row: the power of two >= k, at most a warp."""
    g = 1
    while g < min(k, 32):
        g *= 2
    return g


def argmin_onehot(d: torch.Tensor) -> torch.Tensor:
    """(n, k) f32 -> (n, k) int32 first-minimum one-hot. CPU tensors: plain
    version. CUDA tensors: the hand kernel, or an exception."""
    if d.dim() != 2:
        raise ValueError(f"argmin_onehot needs (n, k), got {tuple(d.shape)}")
    if d.dtype != torch.float32:
        raise TypeError(f"argmin_onehot takes float32, got {d.dtype}")
    if d.device.type == "cpu":
        return argmin_onehot_plain(d)
    if d.device.type != "cuda":
        raise ValueError(f"argmin_onehot runs on cpu or cuda, not {d.device}")
    global LAUNCHES
    n, k = d.shape
    out = torch.empty((n, k), dtype=torch.int32, device=d.device)
    if n == 0 or k == 0:
        return out
    d = d.contiguous()
    fn = _build.launcher("argmin")
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(d.data_ptr(), out.data_ptr(), n, k, group(k), stream)
    _build.check(err, "argmin_onehot")
    LAUNCHES += 1
    return out
