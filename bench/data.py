"""The benchmark's inputs, made from the seed on the device: blobs, their
fixed-point words, the start and its two shares.

Its own copy of the fixed-point encode (l = 64, f = 20, round half to
even), so that a change to the program cannot move the inputs.
"""
from __future__ import annotations

import torch

FRAC_BITS = 20


def encode(x: torch.Tensor, f: int = FRAC_BITS) -> torch.Tensor:
    """Reals -> two's-complement fixed-point words mod 2^64 (int64)."""
    return torch.round(x.to(torch.float64) * float(1 << f)).to(torch.int64)


def blobs(gen: torch.Generator, n: int, d: int, k: int, spec: dict,
          device) -> tuple[torch.Tensor, torch.Tensor]:
    """(words (n, d), blob of each row): k centers uniform in
    [center_low, center_high), Gaussian noise of sd `noise` around them,
    encoded in blocks of rows. With `sparsity` s, each blob keeps a random
    (1 - s) share of the columns and zeros the rest, its noise included.
    The rows' blobs are uniform."""
    lo, hi = float(spec["center_low"]), float(spec["center_high"])
    sparsity = float(spec.get("sparsity", 0.0))
    centers = (torch.rand((k, d), generator=gen, device=device,
                          dtype=torch.float64) * (hi - lo) + lo
               ).to(torch.float32)
    keep = None
    if sparsity:
        keep = torch.rand((k, d), generator=gen, device=device) >= sparsity
        centers = centers * keep
    lab = torch.randint(0, k, (n,), generator=gen, device=device)
    words = torch.empty((n, d), dtype=torch.int64, device=device)
    block = max(1, (1 << 26) // d)
    for i in range(0, n, block):
        rows = lab[i:i + block]
        x = torch.randn((rows.numel(), d), generator=gen, device=device)
        x = x * float(spec["noise"]) + centers[rows]
        if keep is not None:
            x *= keep[rows]
        words[i:i + block] = encode(x)
    return words, lab


def first_of_each(lab: torch.Tensor, k: int) -> torch.Tensor:
    """The index of the first row of each of the k blobs: the start, one
    point a blob, so no row is near-equidistant to two starts."""
    first = [(lab == c).nonzero()[:1, 0] for c in range(k)]
    if any(f.numel() == 0 for f in first):
        raise ValueError(f"a blob of the {k} is empty")
    return torch.cat(first)


def shares(gen: torch.Generator, words: torch.Tensor):
    """Two additive shares mod 2^64: a uniform word mask and the rest."""
    r = torch.randint(-2 ** 63, 2 ** 63 - 1, tuple(words.shape),
                      generator=gen, dtype=torch.int64, device=words.device)
    return r, words - r
