"""Additive secret sharing over Z_{2^64} (paper Sec 3.1).

A-shares are pairs (s0, s1) with x = s0 + s1 mod 2^64; B-shares are pairs of
bit-packed words with x = b0 XOR b1 — each element carries its 64 bits in
one lane. Words are int64 tensors (core/ring.py).

Both parties' shares live in one process (simulated 2PC); protocol code only
combines them at explicit `rec` points, each accounted in channel.CommLog.
Shares are drawn on the host with numpy from the caller's Generator, so a
seed gives the same words as the JAX package, then moved to `device`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ring


class AShare(NamedTuple):
    """Arithmetic share: x = s0 + s1 (mod 2^64)."""

    s0: torch.Tensor
    s1: torch.Tensor

    @property
    def shape(self):
        return tuple(self.s0.shape)


class BShare(NamedTuple):
    """Boolean share, bit-packed: x = b0 ^ b1 (64 bits per lane)."""

    b0: torch.Tensor
    b1: torch.Tensor

    @property
    def shape(self):
        return tuple(self.b0.shape)


def share(x, rng: np.random.Generator, device="cpu") -> AShare:
    """Shr(x): split uint64 ring words into two uniform shares."""
    x = np.asarray(x, np.uint64)
    s0 = ring.rand_np(rng, x.shape)
    s1 = x - s0  # uint64 wraparound == mod 2^64
    return AShare(ring.from_u64_numpy(s0, device),
                  ring.from_u64_numpy(s1, device))


def share_real(x, rng: np.random.Generator, f: int = ring.F,
               device="cpu") -> AShare:
    """Encode reals to fixed point then share."""
    enc = np.round(np.asarray(x, np.float64) * (1 << f)) \
        .astype(np.int64).astype(np.uint64)
    return share(enc, rng, device)


def rec(a: AShare) -> torch.Tensor:
    """Rec(x): reconstruct (the only point where plaintext reappears)."""
    return a.s0 + a.s1


def rec_real(a: AShare, f: int = ring.F) -> torch.Tensor:
    return ring.decode(rec(a), f)


def share_b(x, rng: np.random.Generator, device="cpu") -> BShare:
    x = np.asarray(x, np.uint64)
    b0 = ring.rand_np(rng, x.shape)
    return BShare(ring.from_u64_numpy(b0, device),
                  ring.from_u64_numpy(x ^ b0, device))


def rec_b(b: BShare) -> torch.Tensor:
    return b.b0 ^ b.b1


def zeros_like(a: AShare) -> AShare:
    z = torch.zeros_like(a.s0)
    return AShare(z, z)


def public_to_ashare(x: torch.Tensor) -> AShare:
    """Embed a public ring tensor as a (degenerate) share pair (P0 holds it)."""
    return AShare(x, torch.zeros_like(x))
