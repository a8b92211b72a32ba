"""Beaver triple generation — the data-independent OFFLINE phase (paper Sec 4.1).

`TrustedDealer` generates correct triples on demand. Generation stays in
numpy on the host, on the same per-class PCG64 streams as the JAX package,
so a seed gives the same words; the dealer then hands the shares out as
int64 tensors on its `device`. On-demand generation puts the dealer's host
work (and the host-to-device copy) on the online critical path — it is the
oracle and the no-preprocessing baseline.

OT-based generation is cost-modelled: per 64-bit scalar product the
Gilboa/ABY protocol transfers l correlated OTs of (kappa + l)-bit strings per
direction. Offline bytes and a rate-based time estimate are logged so the
paper's offline columns can be reproduced analytically beside the measured
dealer wall-time.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ring
from repro_torch.core.channel import CommLog
from repro_torch.core.sharing import AShare, BShare

KAPPA = 128  # computational security parameter (paper Sec 5.1)


class MatmulTriple(NamedTuple):
    u: AShare  # (n, d)
    v: AShare  # (d, k)
    z: AShare  # (n, k) with Z = U @ V mod 2^64


class MulTriple(NamedTuple):
    u: AShare
    v: AShare
    z: AShare  # elementwise, broadcastable


class BinTriple(NamedTuple):
    u: BShare
    v: BShare
    z: BShare  # bit-packed, z = u & v


# ---------------------------------------------------------------------------
# Offline communication cost model (documented formulas, paper-calibrated)
# ---------------------------------------------------------------------------

def ot_mul_triple_bytes(n_scalar_products: int, l: int = ring.L,
                        kappa: int = KAPPA) -> int:
    """Gilboa-style OT multiplication: l COTs of (kappa+l) bits, both dirs."""
    return int(n_scalar_products) * 2 * l * (kappa + l) // 8


def ot_bin_triple_bytes(n_bits: int, kappa: int = KAPPA) -> int:
    """Binary triples via R-OT: ~2(kappa+1) bits per AND gate."""
    return int(n_bits) * 2 * (kappa + 1) // 8


# Calibration: a 2.5 GHz Xeon does ~2e6 OT-extension 64-bit triple ops/s/core
# (ABY paper, Table 2 ballpark). Used only for the modelled offline *time*.
OT_TRIPLES_PER_SEC = 2.0e6
OT_BIN_TRIPLES_PER_SEC = 2.0e7


# ---------------------------------------------------------------------------
# Shape-class generation core
# ---------------------------------------------------------------------------
#
# A *shape-class* is (kind, shape); every request of a class draws the same
# flat block of full-range uint64 words from the class's own PCG64 stream,
# keyed by (seed, kind, dims) exactly as in the JAX package.

_KIND_ID = {"matmul": 0, "mul": 1, "bin": 2, "rand": 3, "seed": 4}


def _class_key(kind: str, shape) -> tuple:
    if kind == "matmul":
        sa, sb = shape
        return (kind, tuple(sa), tuple(sb))
    return (kind, tuple(shape))


def _class_rng(seed: int, key: tuple) -> np.random.Generator:
    """Deterministic per-class stream: entropy = (seed, kind, dims...)."""
    kind = key[0]
    dims = [d for s in key[1:] for d in (len(s), *s)]
    ent = (int(seed), _KIND_ID[kind], *[int(d) for d in dims])
    return np.random.default_rng(np.random.SeedSequence(ent))


def _advanced_rng(seed: int, key: tuple, skip: int) -> np.random.Generator:
    """The class stream positioned AFTER `skip` requests: `ring.rand_np`
    draws exactly `_class_words(key)` PCG64 words per request, so one
    `bit_generator.advance` jump lands on any request offset."""
    rng = _class_rng(seed, key)
    if skip:
        rng.bit_generator.advance(int(skip) * _class_words(key))
    return rng


_SERVE_DOMAIN = 0x53657276  # "Serv"


def serve_seed(fit_seed: int) -> int:
    """Domain-separated dealer seed for the SERVING side of a model fitted
    under `fit_seed`: reusing the fit's seed would replay the Beaver masks
    the fit consumed on overlapping shape-classes."""
    return int(np.random.SeedSequence(
        (int(fit_seed), _SERVE_DOMAIN)).generate_state(1, np.uint64)[0])


def _nelem(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def _check_matmul_dims(shape_a, shape_b) -> None:
    if tuple(shape_a)[1] != tuple(shape_b)[0]:
        raise ValueError(
            f"matmul triple inner dims disagree: A is {tuple(shape_a)}, "
            f"B is {tuple(shape_b)}")


def _check_elemwise_shape(kind: str, shape) -> None:
    """Elementwise (mul/bin) triples take ONE flat tuple of ints."""
    try:
        dims = tuple(shape)
    except TypeError:
        raise ValueError(
            f"{kind} triple shape must be an iterable of ints, "
            f"got {shape!r}") from None
    for s in dims:
        if isinstance(s, bool) or not isinstance(s, (int, np.integer)):
            raise ValueError(
                f"{kind} triple shape must be a flat tuple of ints, got "
                f"{dims!r} (offending entry {s!r})")
        if int(s) < 0:
            raise ValueError(
                f"{kind} triple shape has a negative dimension: {dims!r}")


def _gen_matmul(rng, sa, sb, count: int):
    """`count` matmul triples in one stacked draw + one batched ring matmul.

    Per-request word layout: u, v, mask_u, mask_v, mask_z. Returns six
    (count, ...) uint64 arrays (u0, u1, v0, v1, z0, z1)."""
    _check_matmul_dims(sa, sb)
    (n, d), (_, k) = tuple(sa), tuple(sb)
    nd, dk, nk = n * d, d * k, n * k
    per = 2 * nd + 2 * dk + nk
    flat = ring.rand_np(rng, (count, per))
    u = flat[:, :nd].reshape(count, n, d)
    v = flat[:, nd:nd + dk].reshape(count, d, k)
    mu = flat[:, nd + dk:2 * nd + dk].reshape(count, n, d)
    mv = flat[:, 2 * nd + dk:2 * (nd + dk)].reshape(count, d, k)
    mz = flat[:, 2 * (nd + dk):].reshape(count, n, k)
    z = np.einsum("bij,bjk->bik", u, v, dtype=ring.NP_DTYPE, casting="unsafe")
    return mu, u - mu, mv, v - mv, mz, z - mz


def _gen_mul(rng, shape, count: int):
    sz = _nelem(shape)
    flat = ring.rand_np(rng, (count, 5 * sz))
    u, v, mu, mv, mz = (flat[:, i * sz:(i + 1) * sz].reshape((count,) + tuple(shape))
                        for i in range(5))
    z = u * v  # uint64 wraps mod 2^64
    return mu, u - mu, mv, v - mv, mz, z - mz


def _gen_bin(rng, shape, count: int):
    sz = _nelem(shape)
    flat = ring.rand_np(rng, (count, 5 * sz))
    u, v, mu, mv, mz = (flat[:, i * sz:(i + 1) * sz].reshape((count,) + tuple(shape))
                        for i in range(5))
    z = u & v
    return mu, u ^ mu, mv, v ^ mv, mz, z ^ mz


def _gen_rand(rng, shape, count: int):
    return (ring.rand_np(rng, (count,) + tuple(shape)),)


def _gen_seed(rng, shape, count: int):
    # full-range uint64 seeds for host-side mask streams (Protocol 2 HE2SS)
    return (ring.rand_np(rng, (count,)),)


_GEN = {"mul": _gen_mul, "bin": _gen_bin, "rand": _gen_rand,
        "seed": _gen_seed}


def _gen_class(rng, kind: str, shape, count: int):
    if kind == "matmul":
        return _gen_matmul(rng, *shape, count)
    return _GEN[kind](rng, shape, count)


def _class_words(key: tuple) -> int:
    """PCG64 words ONE request of this shape-class draws. Must mirror the
    `_gen_*` draw widths above exactly."""
    kind = key[0]
    if kind == "matmul":
        (n, d), (_, k) = key[1], key[2]
        return 2 * (n * d) + 2 * (d * k) + n * k
    if kind in ("mul", "bin"):
        return 5 * _nelem(key[1])
    if kind == "rand":
        return _nelem(key[1])
    return 1  # seed


# ---------------------------------------------------------------------------
# TrustedDealer — on-demand generation (oracle / no-preprocessing baseline)
# ---------------------------------------------------------------------------

class TrustedDealer:
    """On-demand offline-phase provider. Each request synthesizes one triple
    from its shape-class stream and uploads it to `device`; logs modelled OT
    cost + measured dealer time (generation and upload)."""

    def __init__(self, seed: int = 0, log: CommLog | None = None,
                 advance: dict | None = None, device="cpu"):
        self.seed = seed
        self.log = log if log is not None else CommLog()
        self.device = torch.device(device)
        self._rngs: dict[tuple, np.random.Generator] = {}
        # {class_key: requests already consumed} — each class stream starts
        # pre-advanced past them (applied lazily in _rng_for)
        self._advance = {tuple(k): int(v)
                         for k, v in (advance or {}).items()}
        self.dealer_seconds = 0.0
        self.modelled_ot_seconds = 0.0
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0

    # -- helpers ---------------------------------------------------------
    def _rng_for(self, key: tuple) -> np.random.Generator:
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = _advanced_rng(
                self.seed, key, self._advance.get(key, 0))
        return rng

    def _clock(self) -> float:
        # The upload below waits for the device's queued work; draining it
        # first keeps that work out of dealer_seconds.
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _one(self, kind: str, shape):
        key = _class_key(kind, shape)
        out = _gen_class(self._rng_for(key), kind, shape, 1)
        return [ring.from_u64_numpy(a[0], self.device) for a in out]

    def _account(self, scalar_products: int, tag: str) -> None:
        """Model OT generation traffic + dealer->party distribution."""
        self.log.send(ot_mul_triple_bytes(scalar_products), tag=tag,
                      phase="offline", rounds=2)
        self.modelled_ot_seconds += scalar_products / OT_TRIPLES_PER_SEC

    def matmul_triple(self, shape_a, shape_b, *, tag: str = "misc") -> MatmulTriple:
        t0 = self._clock()
        (n, d), (_, k) = tuple(shape_a), tuple(shape_b)
        u0, u1, v0, v1, z0, z1 = self._one("matmul", (shape_a, shape_b))
        tr = MatmulTriple(AShare(u0, u1), AShare(v0, v1), AShare(z0, z1))
        self.dealer_seconds += time.perf_counter() - t0
        # A matrix triple is worth n*d*k scalar products under OT generation.
        self._account(n * d * k, tag)
        self.n_matmul += 1
        return tr

    def mul_triple(self, shape, *, tag: str = "misc") -> MulTriple:
        _check_elemwise_shape("mul", shape)
        t0 = self._clock()
        u0, u1, v0, v1, z0, z1 = self._one("mul", shape)
        tr = MulTriple(AShare(u0, u1), AShare(v0, v1), AShare(z0, z1))
        self.dealer_seconds += time.perf_counter() - t0
        self._account(_nelem(shape), tag)
        self.n_mul += 1
        return tr

    def bin_triple(self, shape, *, tag: str = "misc") -> BinTriple:
        """Bit-packed binary AND triples: each 64-bit lane = 64 AND gates."""
        _check_elemwise_shape("bin", shape)
        t0 = self._clock()
        u0, u1, v0, v1, z0, z1 = self._one("bin", shape)
        tr = BinTriple(BShare(u0, u1), BShare(v0, v1), BShare(z0, z1))
        self.dealer_seconds += time.perf_counter() - t0
        n_bits = _nelem(shape) * 64
        self.log.send(ot_bin_triple_bytes(n_bits), tag=tag, phase="offline",
                      rounds=2)
        self.modelled_ot_seconds += n_bits / OT_BIN_TRIPLES_PER_SEC
        self.n_bin += 1
        return tr

    def rand(self, shape) -> torch.Tensor:
        """Correlated-randomness source for share-resharing steps (B2A)."""
        return self._one("rand", shape)[0]

    def mask_seed(self) -> int:
        """Seed for a host-side statistical-mask stream (Protocol 2 HE2SS)."""
        key = _class_key("seed", ())
        return int(_gen_seed(self._rng_for(key), (), 1)[0][0])
