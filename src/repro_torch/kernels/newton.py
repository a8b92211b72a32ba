"""The Newton-Raphson loop of the secure reciprocal (`core/protocol.py:
reciprocal`), both parties' shares at once: `iters` times
dx = smul(dp, x) >> f, then x = smul(x, 2 - dx) >> f, each product a Beaver
multiplication with the FUSE_BEAVER recombination and SecureML's local
truncation.

The JAX package has no kernel for it (XLA fuses the chain under jit); the
CUDA kernel `csrc/newton.cu` takes the place of the 2 * iters eager
products, some twenty launches each. Beside it:

* `newton_recip_plain` — the plain PyTorch version, the chain of products
  as `protocol.smul` computes them, on any device (meta and DTensors too).
* `newton_recip` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. `LAUNCHES` counts launches.

The caller draws the 2 * iters mul triples (`MulTriple`s of dp's shape, in
the loop's order: each iteration's dx product, then its x product) and
logs the openings' traffic; these functions only compute.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ring
from repro_torch.core.sharing import AShare
from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `newton_recip` on CUDA tensors

THREADS = 128
MAX_ITERS = 40          # iterations a launch; the kernel's parameter struct
#                         holds at most `kMaxIters` (csrc/newton.cu)


def _check(dp: AShare, x0: AShare, triples, f: int, iters: int) -> list:
    """Validate the operands; returns the triples' words in the kernel's
    order (each triple's u0, u1, v0, v1, z0, z1)."""
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not 0 <= f < 62:
        raise ValueError(f"f must lie in [0, 62), got {f}")
    if len(triples) != 2 * iters:
        raise ValueError(f"{iters} iterations take {2 * iters} mul triples, "
                         f"got {len(triples)}")
    words = [w for t in triples for w in (*t.u, *t.v, *t.z)]
    shape, dev = dp.s0.shape, dp.s0.device
    for t in (*dp, *x0, *words):
        if t.dtype != torch.int64:
            raise TypeError("newton_recip takes int64 ring words")
        if t.shape != shape:
            raise ValueError(f"newton_recip operands must all be "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("newton_recip operands must share one device")
    return words


def _smul_trunc(a: AShare, b: AShare, t, f: int) -> AShare:
    """`protocol.smul(ctx, a, b, trunc_f=f)` on a drawn triple `t`."""
    e = (a.s0 - t.u.s0) + (a.s1 - t.u.s1)
    g = (b.s0 - t.v.s0) + (b.s1 - t.v.s1)
    z0 = t.z.s0 + t.u.s0 * g + e * (t.v.s0 + g)
    z1 = t.z.s1 + t.u.s1 * g + e * t.v.s1
    if f == 0:
        return AShare(z0, z1)
    return AShare(ring.logical_rshift(z0, f),
                  ring.neg(ring.logical_rshift(ring.neg(z1), f)))


def newton_recip_plain(dp: AShare, x0: AShare, triples, *, f: int,
                       iters: int) -> AShare:
    """x after `iters` Newton iterations from x0 on the share dp."""
    _check(dp, x0, triples, f, iters)
    two = ring.encode(2.0, f, device=dp.s0.device)
    x = x0
    for i in range(iters):
        dx = _smul_trunc(dp, x, triples[2 * i], f)
        x = _smul_trunc(x, AShare(two - dx.s0, ring.neg(dx.s1)),
                        triples[2 * i + 1], f)
    return x


def newton_recip(dp: AShare, x0: AShare, triples, *, f: int,
                 iters: int) -> AShare:
    """x after `iters` Newton iterations, shaped like dp. CPU tensors:
    plain version. CUDA tensors: the hand kernel (one launch per
    MAX_ITERS iterations, one for none), or an exception."""
    dev = dp.s0.device
    if dev.type == "cpu":
        return newton_recip_plain(dp, x0, triples, f=f, iters=iters)
    if dev.type != "cuda":
        raise ValueError(f"newton_recip runs on cpu or cuda, not {dev}")
    words = _check(dp, x0, triples, f, iters)
    keep = []       # contiguous copies, held until the launch is enqueued

    def ptr(t):
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        return t.data_ptr()

    table = np.array([ptr(w) for w in words], dtype=np.uint64)
    args = [ptr(t) for t in (*dp, *x0)]
    out = torch.empty((2,) + tuple(dp.s0.shape), dtype=torch.int64,
                      device=dev)
    n = out[0].numel()
    if n == 0:
        return AShare(out[0], out[1])
    global LAUNCHES
    fn = _build.launcher("newton")
    two = 1 << (f + 1)              # ring.encode(2.0, f)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.ctypes.data, iters, MAX_ITERS, *args, out.data_ptr(),
                 n, f, two, -(-n // THREADS), THREADS, stream)
    _build.check(err, "newton_recip")
    LAUNCHES += max(1, -(-iters // MAX_ITERS))
    return AShare(out[0], out[1])
