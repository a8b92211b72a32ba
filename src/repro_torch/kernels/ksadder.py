"""One party's fused Kogge-Stone carry share for the B-share MSB (the CMP
inside every argmin round — the S2 hot spot).

Port of the Pallas TPU kernel `repro/kernels/ksadder.py:ks_carry_share`.
Given the publicly reconstructed masked operands of all 7 AND levels of the
secure adder (level 0 plus the six `LEVELS`) and this party's triple shares,
it computes the party's share of the final carry word in one pass. The CUDA
kernel is `csrc/ksadder.cu`; its header says what bounds it and how its
design answers that. Beside it:

* `ks_carry_share_plain` — the plain PyTorch version (the g-chain of
  `_and_share` recombinations), on any device.
* `ks_carry_share` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. `LAUNCHES` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LEVELS = (1, 2, 4, 8, 16, 32)
LAUNCHES = 0            # kernel launches by `ks_carry_share` on CUDA tensors

THREADS = 256
MAX_BLOCKS = 8 * 132    # grid-stride cap: 8 blocks per H100 SM


def _and_share(e, f, u, v, z, party0: bool):
    """One party's Beaver AND recombination on packed 64-bit words."""
    out = z ^ (u & f) ^ (e & v)
    if party0:
        out = out ^ (e & f)
    return out


def ks_carry_share_plain(x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                         party0: bool) -> torch.Tensor:
    """Flat operands have x's shape; level stacks are (6, 2, *shape). Only
    the g-chain is recombined: `x` and slot 1 are not computed on."""
    g = _and_share(e0, f0, u0, v0, z0, party0)
    for li in range(len(LEVELS)):
        g = g ^ _and_share(el[li, 0], fl[li, 0], ul[li, 0], vl[li, 0],
                           zl[li, 0], party0)
    return g


def _level_stride(t: torch.Tensor, shape: tuple, what: str):
    """The level stack itself if its trailing dims are contiguous (slot 0 of
    level l then starts at l * stride(0) words), else a contiguous copy."""
    if tuple(t.shape) != (len(LEVELS), 2) + shape:
        raise ValueError(f"{what} must be {(len(LEVELS), 2) + shape}, "
                         f"got {tuple(t.shape)}")
    if not t[0, 0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def ks_carry_share(x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                   party0: bool) -> torch.Tensor:
    """This party's share of the carry word, shaped like x. CPU tensors:
    plain version. CUDA tensors: the hand kernel, or an exception."""
    tensors = (x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl)
    if any(t.dtype != torch.int64 for t in tensors):
        raise TypeError("ks_carry_share takes int64 ring words")
    if any(t.device != x.device for t in tensors):
        raise ValueError("ks_carry_share operands must share one device")
    if x.device.type == "cpu":
        return ks_carry_share_plain(*tensors, party0=party0)
    if x.device.type != "cuda":
        raise ValueError(f"ks_carry_share runs on cpu or cuda, not {x.device}")
    global LAUNCHES
    shape = tuple(x.shape)
    flat = []
    for name, t in zip(("e0", "f0", "u0", "v0", "z0"), (e0, f0, u0, v0, z0)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        flat.append(t.contiguous())
    lvls = [_level_stride(t, shape, name)
            for name, t in zip(("el", "fl", "ul", "vl", "zl"),
                               (el, fl, ul, vl, zl))]
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    blocks = min(MAX_BLOCKS, -(-n // THREADS))
    fn = _build.launcher("ksadder")
    args = [t.data_ptr() for t in flat]
    for t, stride in lvls:
        args += [t.data_ptr(), stride]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, out.data_ptr(), n, int(bool(party0)), blocks,
                 THREADS, stream)
    _build.check(err, "ks_carry_share")
    LAUNCHES += 1
    return out
