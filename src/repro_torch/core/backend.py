"""Pluggable ring-compute backend — the local hot ops of the online path.

Every *local* ring operation the 2PC protocols consume goes through one
small dispatch interface:

  * ``ring_mm``  — int64-word matmul mod 2^64 (every Beaver recombination,
                   every public-x-share product, every C^T X block).
  * ``ring_spmm`` — blocked-ELL sparse x dense over the ring (the
                   nnz-proportional step-2 compute of Protocol 2), and
                   ``ring_spmm_csr``, its CSR form (packed into ELL on the
                   torch and cuda backends, a chunked CSR loop on numpy).
  * ``ks_fused`` — one party's fused Kogge-Stone recombination: all 7 AND
                   levels of the secure-adder MSB in one local pass given the
                   exchanged masked operands.
  * ``newton_recip`` — the secure reciprocal's Newton loop: 2 * iters
                   Beaver products, openings and recombinations of both
                   parties, on drawn triples (``newton_impl`` names the
                   implementation: "plain" or "kernel").

Three implementations:

  * ``torch`` — plain PyTorch on any device; the bit-exact oracle.
  * ``cuda``  — the hand-written kernels in ``repro_torch.kernels``. It
                takes CUDA tensors only and raises on anything else: it never
                runs quietly on the CPU.
  * ``numpy`` — host only: the ``torch`` ops on CPU tensors, with
                ``ring_spmm_csr`` as a chunked CSR loop on uint64 numpy
                words that packs no ELL. It raises on CUDA tensors: it never
                copies device shares to the host on its own. It cannot run in
                the S1/S3 or scoring programs, so configs that select it take
                the eager loops.

All are bit-exact in Z_{2^64}; the parity tests assert equality.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ksadder, modmatmul, newton, spmm
from repro_torch.kernels.ksadder import LEVELS as KS_LEVELS

__all__ = ["KS_LEVELS", "RingBackend", "TorchBackend", "CudaBackend",
           "NumpyBackend", "get_backend"]


class RingBackend:
    """Dispatch interface for the local ring ops on the online hot path."""

    name = "base"

    def ring_mm(self, a, b):
        """(n, d) @ (d, k) mod 2^64."""
        raise NotImplementedError

    def ring_spmm(self, blocks, idx, counts, y):
        """Blocked-ELL sparse x dense over the ring -> (nrb*bm, k)."""
        raise NotImplementedError

    def ring_spmm_csr(self, csr, y, *, bm: int = 8, bk: int = 128):
        """CSR sparse x dense mod 2^64 -> (n, k) via the blocked-ELL op.

        `csr` is a host `core.sparse.CSRMatrix`; its ELL packing is made
        and uploaded to y's device once and memoized on it (`CSRMatrix.ell`).
        y is padded with zero rows to a multiple of bk (ring-neutral).

        The ELL layout pads every row block to the max tile count, so a
        skewed matrix (one dense row block) costs O(nrb * maxb) tiles —
        acceptable when the tiles feed a device kernel. The host-only numpy
        backend overrides this with the chunked CSR loop, O(nnz), and packs
        no ELL."""
        blocks, idx, counts = csr.ell(bm=bm, bk=bk, device=y.device)
        pad = (-y.shape[0]) % bk
        if pad:
            y = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
        return self.ring_spmm(blocks, idx, counts, y)[: csr.shape[0]]

    def ks_fused(self, x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                 party0: bool):
        """One party's fused 7-level Kogge-Stone local recombination.

        Only the g-chain is recombined: the per-level p *shares* feed nothing
        locally (the next level's public masks are part of the transcript),
        so the slot-1 operands — and `x`, the party's p0-share — are accepted
        for interface parity but not computed on. The slot-1 triples are
        still drawn and exchanged by msb_carry: they mask the transcript."""
        raise NotImplementedError

    def newton_recip(self, dp, x0, triples, *, f: int, iters: int):
        """The AShare x after `iters` Newton iterations x <- x(2 - dp x)
        from x0, each product a truncated Beaver product on the next two
        of the 2 * iters drawn `triples` (dx, then x). Bit for bit the
        chain of `protocol.smul`s; the caller draws the triples and logs
        the openings' traffic."""
        raise NotImplementedError


class TorchBackend(RingBackend):
    """Plain PyTorch on any device — the parity oracle."""

    name = "torch"
    newton_impl = "plain"

    def ring_mm(self, a, b):
        return modmatmul.ring_matmul_plain(a, b)

    def ring_spmm(self, blocks, idx, counts, y):
        return spmm.spmm_ell_plain(blocks, idx, counts, y)

    def ks_fused(self, x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                 party0: bool):
        return ksadder.ks_carry_share_plain(x, e0, f0, u0, v0, z0, el, fl,
                                            ul, vl, zl, party0=party0)

    def newton_recip(self, dp, x0, triples, *, f: int, iters: int):
        return newton.newton_recip_plain(dp, x0, triples, f=f, iters=iters)


def _require_cuda(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(
                f"the cuda backend takes CUDA tensors, got one on {t.device}; "
                "use backend='torch' for the CPU")


class CudaBackend(RingBackend):
    """The hand-written Hopper kernels (kernels/csrc)."""

    name = "cuda"
    newton_impl = "kernel"

    def __init__(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='cuda' needs a CUDA GPU and none is available; "
                "use backend='torch', device='cpu' for the CPU")

    def ring_mm(self, a, b):
        _require_cuda(a, b)
        return modmatmul.ring_matmul(a, b)

    def ring_spmm(self, blocks, idx, counts, y):
        _require_cuda(blocks, idx, counts, y)
        return spmm.spmm_ell(blocks, idx, counts, y)

    def ks_fused(self, x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                 party0: bool):
        args = (x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl)
        _require_cuda(*args)
        return ksadder.ks_carry_share(*args, party0=party0)

    def newton_recip(self, dp, x0, triples, *, f: int, iters: int):
        _require_cuda(*dp, *x0)
        return newton.newton_recip(dp, x0, triples, f=f, iters=iters)


def _csr_spmm_chunked(csr, y: np.ndarray) -> np.ndarray:
    """Host-side CSR x dense mod 2^64 on uint64 words: gather-multiply-
    scatter, chunked so the intermediate stays O(chunk * k) regardless of
    sparsity skew."""
    n = csr.shape[0]
    z = np.zeros((n, y.shape[1]), np.uint64)
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    chunk = 1 << 22
    for lo in range(0, csr.nnz, chunk):
        hi = min(csr.nnz, lo + chunk)
        contrib = csr.data[lo:hi, None] * y[csr.indices[lo:hi]]
        np.add.at(z, rows[lo:hi], contrib)
    return z


def _require_cpu(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise RuntimeError(
                f"the numpy backend takes CPU tensors, got one on {t.device}; "
                "use backend='cuda' for shares on the GPU")


class NumpyBackend(TorchBackend):
    """Host only: the plain ops on CPU tensors, and the chunked CSR loop
    in place of the ELL packing. It raises on any other device: it never
    copies device shares to the host on its own."""

    name = "numpy"

    def ring_mm(self, a, b):
        _require_cpu(a, b)
        return super().ring_mm(a, b)

    def ring_spmm(self, blocks, idx, counts, y):
        _require_cpu(blocks, idx, counts, y)
        return super().ring_spmm(blocks, idx, counts, y)

    def ring_spmm_csr(self, csr, y, *, bm: int = 8, bk: int = 128):
        _require_cpu(y)
        z = _csr_spmm_chunked(csr, y.numpy().view(np.uint64))
        return torch.from_numpy(z.view(np.int64))

    def ks_fused(self, x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl, *,
                 party0: bool):
        _require_cpu(x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl)
        return super().ks_fused(x, e0, f0, u0, v0, z0, el, fl, ul, vl, zl,
                                party0=party0)

    def newton_recip(self, dp, x0, triples, *, f: int, iters: int):
        _require_cpu(*dp, *x0)
        return super().newton_recip(dp, x0, triples, f=f, iters=iters)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

_CLASSES = {"torch": TorchBackend, "cuda": CudaBackend,
            "numpy": NumpyBackend}
_INSTANCES: dict[str, RingBackend] = {}


def get_backend(name: "str | RingBackend | None" = "cuda",
                device="cuda") -> RingBackend:
    """Resolve a backend name ('auto' | 'torch' | 'cuda' | 'numpy'; None
    means 'auto') or pass an instance through. 'auto' resolves by `device`,
    the device the shares live on: 'cuda' on a CUDA device, 'torch'
    otherwise — never by whether a GPU happens to be present, and never to
    the host-only 'numpy'. 'cuda' raises when no GPU is available."""
    if isinstance(name, RingBackend):
        return name
    if name is None or name == "auto":
        name = "cuda" if torch.device(device).type == "cuda" else "torch"
    if name not in _INSTANCES:
        try:
            cls = _CLASSES[name]
        except KeyError:
            raise ValueError(
                f"unknown ring backend {name!r}; "
                "expected 'auto', 'torch', 'cuda' or 'numpy'") from None
        _INSTANCES[name] = cls()
    return _INSTANCES[name]
