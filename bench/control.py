"""The control: the reference put in the program's place, one precision
below the configuration's.

The configuration states ring words of l = 64 bits with f = 20 fractional
bits, truncated after a product by the protocol's local truncation of
each party's share (SecureML). The nearest precision below is the 32-bit
ring (the word of the kernel API's mod-2^32 products), at the largest f
whose distance words still fit it. The control computes Lloyd's step in
those words and truncates the distances as two parties would, on a
uniform share of each word; then it hands back two shares of its
assignment and centroids, as the program does. A check that passes it
cannot tell the program from a 32-bit one.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench.reference import FRAC_BITS, decode

BITS = 32


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 words reduced to signed BITS-bit words."""
    half = 1 << (BITS - 1)
    return (v + half) % (1 << BITS) - half


def _share_trunc(gen: torch.Generator, v: torch.Tensor, f: int):
    """Local truncation of BITS-bit words split into a uniform share and
    the rest: party 0 shifts its share, party 1 negates, shifts and
    negates; wraps with probability ~|v| / 2^BITS a word."""
    mod = 1 << BITS
    r = torch.randint(0, mod, tuple(v.shape), generator=gen,
                      device=v.device, dtype=torch.int64)
    s1 = (v - r) % mod
    t0 = r >> f
    t1 = -(((-s1) % mod) >> f)
    return _wrap(t0 + t1)


def frac_bits(xa: torch.Tensor, xb: torch.Tensor) -> int:
    """The largest f at which every distance |mu|^2 - 2 x.mu, scaled by
    2^2f, fits a signed BITS-bit word for centroids within the data's
    largest norm: 3 max|x|^2 * 2^2f < 2^(BITS-1)."""
    sq = max(float((decode(xa) ** 2).sum(1).max() + (decode(xb) ** 2)
                   .sum(1).max()), 1e-12)
    return max(0, math.floor((BITS - 1 - math.log2(3 * sq)) / 2))


class Programs(NamedTuple):
    s1: object
    s3: object
    s1_requests: list
    s3_requests: list


def programs(xa: torch.Tensor, xb: torch.Tensor, seed: int) -> Programs:
    """s1 / s3 with the program's signatures over the data words xa, xb;
    they consume no offline list."""
    f = frac_bits(xa, xb)
    x = torch.round(decode(torch.cat([xa, xb], 1)) * (1 << f))
    gen = torch.Generator(device=xa.device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    n, up = x.shape[0], FRAC_BITS - f

    def to_words(words64: torch.Tensor) -> torch.Tensor:
        return torch.round(decode(words64) * (1 << f))

    def share(words: torch.Tensor):
        r = torch.randint(-2 ** 63, 2 ** 63 - 1, tuple(words.shape),
                          generator=gen, dtype=torch.int64,
                          device=words.device)
        return r, words - r

    def s1(xa_, xb_, mu0, mu1, *flat):
        mu = to_words(mu0 + mu1)
        dist = (mu * mu).sum(1)[None, :] - 2 * (x @ mu.T)
        dist = _share_trunc(gen, _wrap(dist.to(torch.int64)), f)
        lab = dist.argmin(1)
        onehot = torch.zeros((n, mu.shape[0]), dtype=torch.int64,
                             device=x.device)
        onehot[torch.arange(n, device=x.device), lab] = 1
        return share(onehot)

    def s3(xa_, xb_, mu0, mu1, c0, c1, *flat):
        mu = to_words(mu0 + mu1)
        lab = (c0 + c1).argmax(1)
        k = mu.shape[0]
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, lab, x)
        counts = torch.bincount(lab, minlength=k).to(torch.float64)
        new = torch.floor(sums / counts.clamp(min=1)[:, None])
        new = torch.where(counts[:, None] > 0, new, mu)
        return share(_wrap(new.to(torch.int64)) << up)

    return Programs(s1, s3, [], [])
