"""Beaver triple generation — the data-independent OFFLINE phase (paper Sec 4.1).

Generation stays in numpy on the host, on the same per-class PCG64 streams
as the JAX package, so a seed gives the same words; the dealers hand the
shares out as int64 tensors on their `device`. Provider flavours:

* `TrustedDealer` — generates correct triples on demand. Its host work (and
  the host-to-device copy) lands on the online critical path — it is the
  oracle and the no-preprocessing baseline.
* `PlanningDealer` + `TriplePlan` — a dry-run trace on zeros that records
  the exact (kind, shape, tag) schedule a protocol run consumes. The
  schedule is data-independent, which is why an offline phase exists.
* `PooledDealer` — executes a `TriplePlan` ahead of time with stacked
  draws and batched ring ops over many requests of a shape-class at once,
  writes each class into one device tensor, and serves the online phase by
  list index over views of it. Word for word equal to `TrustedDealer` under
  the same seed: a stacked full-range uint64 draw is the concatenation of
  the per-request draws.
* `StreamingPooledDealer` — the pooled dealer's generation cut into
  per-iteration tranches, generated on a background worker while the
  previous iteration runs (on CUDA: pinned staging and a side stream, the
  consumer waiting on an event), so peak pool residency is `prefetch`
  tranches, independent of `iters`.
* `SlotDealer` — the minibatch fit's schedule as a sequence of slots (per
  iteration: each batch's S1 and S3-partial, then the finalize), each slot
  acquired as a dealer view of its own, possibly ahead of lower slots;
  pregenerated (pooled) or generated on a worker within a window of slots
  (streamed), so peak residency is independent of n and iters.
* `TripleBank` — a persistent store that serves many runs (fits, scoring
  requests) from one provisioning pass, one FIFO of device views per
  shape-class, with stock-out replenishment, a top-up daemon
  (`BankReplenisher`), `save`/`load` in the JAX package's npz format, and
  dealer views for a full-batch fit or a scoring call (`BankDealer`) and
  for a minibatch fit (`BankSlotDealer`).

OT-based generation is cost-modelled: per 64-bit scalar product the
Gilboa/ABY protocol transfers l correlated OTs of (kappa + l)-bit strings per
direction. Offline bytes and a rate-based time estimate are logged so the
paper's offline columns can be reproduced analytically beside the measured
dealer wall-time.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ring
from repro_torch.core.channel import CommLog
from repro_torch.core.sharing import AShare, BShare
from repro_torch.obs import trace as _trace

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


class PoolExhaustedError(RuntimeError):
    """The online phase asked for correlated randomness the plan did not
    include (wrong shape-class, or more requests than planned)."""


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


# ---------------------------------------------------------------------------
# Planner — derive the exact offline schedule by dry-run trace
# ---------------------------------------------------------------------------

class PlanRequest(NamedTuple):
    kind: str    # matmul | mul | bin | rand | seed
    shape: tuple  # (sa, sb) for matmul, the tensor shape otherwise
    tag: str


@dataclasses.dataclass
class TriplePlan:
    """The correlated-randomness schedule of a protocol run, in consumption
    order. Data-independent: derived once per (n, k, d, iters, partition,
    sparsity) config and valid for every input of those shapes."""

    requests: list

    def repeat(self, reps: int) -> "TriplePlan":
        """Schedule of `reps` identical passes (e.g. Lloyd iterations)."""
        return TriplePlan(list(self.requests) * int(reps))

    def __add__(self, other: "TriplePlan") -> "TriplePlan":
        return TriplePlan(list(self.requests) + list(other.requests))

    def __len__(self) -> int:
        return len(self.requests)

    def class_counts(self) -> dict:
        """{class_key: count} — the shape-class histogram the bulk dealer
        generates, one stacked draw each."""
        out: dict[tuple, int] = {}
        for r in self.requests:
            key = _class_key(r.kind, r.shape)
            out[key] = out.get(key, 0) + 1
        return out

    def pool_words(self) -> int:
        """Words a generated pool/tranche of this plan holds (six share
        tensors per triple, one tensor per rand, one word per seed)."""
        return sum(_request_words(_class_key(r.kind, r.shape))
                   for r in self.requests)


class _TripleServing:
    """Shared dealer-interface surface for pool-backed providers: validate
    the request, draw its word tuple from ``self._next(kind, shape)``, wrap
    into the triple type, bump the counters. Only `_next` differs between
    the pooled and the streaming dealer."""

    def matmul_triple(self, shape_a, shape_b, *,
                      tag: str = "misc") -> MatmulTriple:
        _check_matmul_dims(shape_a, shape_b)
        u0, u1, v0, v1, z0, z1 = self._next(
            "matmul", (tuple(shape_a), tuple(shape_b)))
        self.n_matmul += 1
        return MatmulTriple(AShare(u0, u1), AShare(v0, v1), AShare(z0, z1))

    def mul_triple(self, shape, *, tag: str = "misc") -> MulTriple:
        _check_elemwise_shape("mul", shape)
        u0, u1, v0, v1, z0, z1 = self._next("mul", shape)
        self.n_mul += 1
        return MulTriple(AShare(u0, u1), AShare(v0, v1), AShare(z0, z1))

    def bin_triple(self, shape, *, tag: str = "misc") -> BinTriple:
        _check_elemwise_shape("bin", shape)
        u0, u1, v0, v1, z0, z1 = self._next("bin", shape)
        self.n_bin += 1
        return BinTriple(BShare(u0, u1), BShare(v0, v1), BShare(z0, z1))

    def rand(self, shape) -> torch.Tensor:
        return self._next("rand", shape)[0]

    def mask_seed(self) -> int:
        return int(self._next("seed", ())[0])


class PlanningDealer:
    """Records the (kind, shape, tag) schedule while the traced code runs on
    zeros on `device`. The trace executes the real protocol (eagerly, on
    zero data), so control flow that depends on tensor *shapes* is followed
    exactly — and on a GPU it launches the online path's kernels at their
    online shapes, as offline warm-up."""

    def __init__(self, device="cpu"):
        self.requests: list[PlanRequest] = []
        self.device = torch.device(device)

    def _z(self, shape):
        return torch.zeros(shape, dtype=ring.DTYPE, device=self.device)

    def plan(self) -> TriplePlan:
        return TriplePlan(list(self.requests))

    def matmul_triple(self, shape_a, shape_b, *, tag: str = "misc"):
        _check_matmul_dims(shape_a, shape_b)
        (n, d), (_, k) = tuple(shape_a), tuple(shape_b)
        self.requests.append(
            PlanRequest("matmul", (tuple(shape_a), tuple(shape_b)), tag))
        return MatmulTriple(AShare(self._z((n, d)), self._z((n, d))),
                            AShare(self._z((d, k)), self._z((d, k))),
                            AShare(self._z((n, k)), self._z((n, k))))

    def mul_triple(self, shape, *, tag: str = "misc"):
        _check_elemwise_shape("mul", shape)
        self.requests.append(PlanRequest("mul", tuple(shape), tag))
        z = self._z(shape)
        return MulTriple(AShare(z, z), AShare(z, z), AShare(z, z))

    def bin_triple(self, shape, *, tag: str = "misc"):
        _check_elemwise_shape("bin", shape)
        self.requests.append(PlanRequest("bin", tuple(shape), tag))
        z = self._z(shape)
        return BinTriple(BShare(z, z), BShare(z, z), BShare(z, z))

    def rand(self, shape):
        self.requests.append(PlanRequest("rand", tuple(shape), "misc"))
        return self._z(shape)

    def mask_seed(self) -> int:
        self.requests.append(PlanRequest("seed", (), "misc"))
        return 0


# ---------------------------------------------------------------------------
# PooledDealer — planned bulk generation, zero-host-work serving
# ---------------------------------------------------------------------------

def _account_offline_plan(plan: TriplePlan, log: CommLog) -> float:
    """Log a plan's modelled OT generation traffic (identical totals to the
    on-demand dealer serving the same schedule); returns the modelled OT
    wall-time. Shared by the pooled and streaming dealers."""
    modelled_s = 0.0
    groups: dict[tuple, int] = {}
    for r in plan.requests:
        key = (r.kind, _class_key(r.kind, r.shape), r.tag)
        groups[key] = groups.get(key, 0) + 1
    for (kind, key, tag), count in groups.items():
        if kind == "matmul":
            (n, d), (_, k) = key[1], key[2]
            sp = n * d * k
            log.send(count * ot_mul_triple_bytes(sp), tag=tag,
                     phase="offline", rounds=2 * count)
            modelled_s += count * sp / OT_TRIPLES_PER_SEC
        elif kind == "mul":
            sp = _nelem(key[1])
            log.send(count * ot_mul_triple_bytes(sp), tag=tag,
                     phase="offline", rounds=2 * count)
            modelled_s += count * sp / OT_TRIPLES_PER_SEC
        elif kind == "bin":
            n_bits = _nelem(key[1]) * 64
            log.send(count * ot_bin_triple_bytes(n_bits), tag=tag,
                     phase="offline", rounds=2 * count)
            modelled_s += count * n_bits / OT_BIN_TRIPLES_PER_SEC
    return modelled_s


class _Tranche(NamedTuple):
    pools: dict    # class key -> [per-request word tuples]
    nbytes: int    # words held, times 8
    stacks: list   # the class tensors the entries are views of
    ready: object  # CUDA event recorded after the uploads, or None


DRAW_WORDS = 1 << 22
# A stacked draw covers at most this many PCG64 words (32 MB): a class is
# drawn a few requests at a time, and consecutive draws concatenate to one
# draw of the class (the same words). Arrays this size are reused by the
# host allocator; one draw per class made multi-GB arrays that are faulted
# in page by page, which left the pooled dealer slower than the on-demand
# one (PERF.md §6).
STAGE_WORDS = 1 << 23
# pinned staging on the way to a GPU: two buffers of this many words (64
# MB), reused across classes and tranches


class _Staging:
    """Two pinned host buffers that take turns carrying generated words to
    the device on the current stream. A buffer is refilled only after the
    copy that last read it has run (its event), so no buffer is faulted in
    or pinned more than once."""

    def __init__(self):
        self.bufs = [torch.empty(STAGE_WORDS, dtype=ring.DTYPE,
                                 pin_memory=True) for _ in range(2)]
        self.views = [b.numpy().view(np.uint64) for b in self.bufs]
        self.done = [None, None]
        self.turn = 0

    def put(self, words: np.ndarray, dst: torch.Tensor) -> None:
        """Copy uint64 `words` into the contiguous device tensor `dst` of
        as many words."""
        dst = dst.reshape(-1)
        if words.size > STAGE_WORDS:
            words = np.ascontiguousarray(words).reshape(-1)
        for lo in range(0, words.size, STAGE_WORDS):
            part = words if words.size <= STAGE_WORDS \
                else words[lo:lo + STAGE_WORDS]
            i = self.turn
            self.turn ^= 1
            if self.done[i] is not None:
                self.done[i].synchronize()
            self.views[i][:part.size].reshape(part.shape)[...] = part
            dst[lo:lo + part.size].copy_(self.bufs[i][:part.size],
                                         non_blocking=True)
            self.done[i] = torch.cuda.Event()
            self.done[i].record()


def _request_shapes(kind: str, shape) -> list:
    """Shapes of the word tensors one request of a class is served as."""
    if kind == "matmul":
        (n, d), (_, k) = shape
        return [(n, d), (n, d), (d, k), (d, k), (n, k), (n, k)]
    if kind in ("mul", "bin"):
        return [tuple(shape)] * 6
    return [tuple(shape)]                       # rand


def _draws(rng, key: tuple, count: int):
    """(first request, word arrays) chunks of `count` requests of a class,
    drawn from `rng` in stacked draws of at most DRAW_WORDS words each."""
    kind = key[0]
    shape = key[1:] if kind == "matmul" else key[1]
    chunk = max(1, DRAW_WORDS // _class_words(key))
    for c0 in range(0, count, chunk):
        yield c0, _gen_class(rng, kind, shape, min(chunk, count - c0))


def _gen_tranche(rngs: dict, counts: dict, device,
                 staging: _Staging | None = None, draws=None) -> _Tranche:
    """Generate one tranche from persistent per-class RNG streams: per
    class, stacked numpy draws and batched ring ops (`_gen_class`) of up to
    DRAW_WORDS words each, written into ONE tensor on `device` (through
    `staging`'s pinned buffers when it is a GPU), and per-request entries
    that are views into that tensor. Because a class's stream advances by
    exactly count * words-per-request words per call, the draws of
    consecutive tranches concatenate to the one draw of the whole fit. Seed
    classes stay on the host: their words seed host-side mask streams
    (Protocol 2). `draws(key, count)`, when given, supplies each class's
    words as (first request, arrays) chunks in place of the draws from
    `rngs` (a parallel provisioning, or a bank loaded from disk)."""
    device = torch.device(device)
    if draws is None:
        def draws(key, count):
            return _draws(rngs[key], key, count)
    pools: dict[tuple, list] = {}
    nbytes = 0
    stacks = []
    for key, count in counts.items():
        kind = key[0]
        shape = key[1:] if kind == "matmul" else key[1]
        if kind == "seed":
            words = np.concatenate([a[0] for _, a in draws(key, count)]) \
                if count else np.zeros(0, np.uint64)
            pools[key] = [(w,) for w in words]
            nbytes += 8 * count
            continue
        shapes = _request_shapes(kind, shape)
        sizes = [_nelem(s) for s in shapes]
        stack = torch.empty(count * sum(sizes), dtype=ring.DTYPE,
                            device=device)
        parts, off = [], 0
        for s, size in zip(shapes, sizes):
            parts.append(stack[off:off + count * size].view((count,) + s))
            off += count * size
        for c0, arrays in draws(key, count):
            for words, part in zip(arrays, parts):
                dst = part[c0:c0 + len(words)]
                if staging is None:
                    dst.numpy().view(np.uint64)[...] = words
                else:
                    staging.put(words, dst)
        stacks.append(stack)
        nbytes += 8 * stack.numel()
        pools[key] = [tuple(p[i] for p in parts) for i in range(count)]
    ready = None
    if staging is not None:
        ready = torch.cuda.Event()
        ready.record()
    return _Tranche(pools, nbytes, stacks, ready)


def _take(tranche: _Tranche, device) -> None:
    """Make the current stream wait for a tranche's upload, and keep its
    memory from being reused by the uploading stream before the work queued
    here on it has run (the caching allocator reuses memory per stream)."""
    if tranche.ready is None:
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_event(tranche.ready)
    for t in tranche.stacks:
        t.record_stream(cur)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PooledDealer(_TripleServing):
    """Executes a `TriplePlan` up front and serves it back with list
    indexing over device views only.

    Generation batches each shape-class into stacked RNG draws and batched
    ring ops (`np.einsum` over the stacked operands for matmul triples,
    elementwise `*`/`&` otherwise) of up to DRAW_WORDS words, written into
    one tensor per class on `device` (`_gen_tranche`). Word for word equal
    to `TrustedDealer(seed)` serving the same request sequence.

    Serving past the planned count — or requesting a shape-class the plan
    never mentioned — raises `PoolExhaustedError`: the trace and the online
    run disagreed, which is a planner bug, not a condition to paper over.
    `advance` ({class key: requests already consumed}) starts each class
    stream past them.
    """

    def __init__(self, plan: TriplePlan, seed: int = 0,
                 log: CommLog | None = None, advance: dict | None = None,
                 device="cpu"):
        t0 = time.perf_counter()
        self.plan = plan
        self.seed = seed
        self.log = log if log is not None else CommLog()
        self.device = torch.device(device)
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0
        counts = plan.class_counts()
        advance = advance or {}
        rngs = {key: _advanced_rng(seed, key, advance.get(key, 0))
                for key in counts}
        staging = _Staging() if self.device.type == "cuda" else None
        tranche = _gen_tranche(rngs, counts, self.device, staging)
        self._pools, self.pool_bytes = tranche.pools, tranche.nbytes
        self._served = {key: 0 for key in counts}
        self.modelled_ot_seconds = _account_offline_plan(plan, self.log)
        _sync(self.device)
        self.dealer_seconds = time.perf_counter() - t0

    # -- serving ---------------------------------------------------------
    def _next(self, kind: str, shape) -> tuple:
        key = _class_key(kind, shape)
        pool = self._pools.get(key)
        if pool is None:
            raise PoolExhaustedError(
                f"no pool for {kind} {shape}: the offline plan never "
                "scheduled this shape-class (planner/online mismatch)")
        i = self._served[key]
        if i >= len(pool):
            raise PoolExhaustedError(
                f"pool exhausted for {kind} {shape}: planned "
                f"{len(pool)} requests, online asked for more")
        self._served[key] = i + 1
        return pool[i]

    def remaining(self) -> dict:
        """{class_key: unserved} — surplus after e.g. tol early-stop."""
        return {k: len(p) - self._served[k] for k, p in self._pools.items()}


# ---------------------------------------------------------------------------
# StreamingPooledDealer — double-buffered per-iteration pool generation
# ---------------------------------------------------------------------------

GROUP_TRANCHE_BYTES = 4 << 20
# auto-grouping target: when one iteration's tranche is tiny (small k*d),
# group consecutive iterations until a tranche reaches ~this many bytes, so
# the worker does not wake up per iteration for microseconds of work (the
# served words are the same either way).

SLOT_WINDOW = 4
# SlotDealer's streamed backpressure: at most this many generated but
# unconsumed slots (or one largest generation group more, if that is
# larger) are alive, unless a caller waits on a slot further ahead.


class StreamingPooledDealer(_TripleServing):
    """`PooledDealer` semantics with O(1-iteration) residency.

    The plan of ONE iteration is generated as a tranche (`_gen_tranche`,
    one device tensor per shape-class), and tranche t+1 is
    generated on a background worker while iteration t consumes tranche t.
    At most `prefetch` tranches are alive, so peak residency is independent
    of `iters`. Word for word equal to
    ``PooledDealer(iter_plan.repeat(iters), seed)``: each class keeps one
    persistent PCG64 stream across tranches.

    On CUDA the worker uploads each tranche through reused pinned staging
    buffers on a stream of its own; the consumer's stream waits on an event
    recorded after the uploads, and the tranche's memory is marked in use
    by the consumer's stream until the work queued on it has run.

    Tranche advance is request-counted: when ``len(iter_plan)`` requests
    (times the group) have been served, the tranche is dropped and the next
    generation is dispatched; the prefetched one becomes current at the
    next request. Serving past the plan — or an unplanned class — raises
    `PoolExhaustedError`. An exception in the worker reaches the consumer
    at the request that needs its tranche.

    Timing: ``dealer_seconds`` is construction (first-tranche) time;
    ``gen_seconds`` is the worker's wall-time, ``wait_seconds`` the time
    the online loop blocked on a tranche that was not ready (left in the
    online clock on purpose); ``pool_bytes`` is the peak residency.
    """

    def __init__(self, iter_plan: TriplePlan, iters: int, seed: int = 0,
                 log: CommLog | None = None, prefetch: int = 2,
                 async_gen: bool = True, group: int | str = 1,
                 advance: dict | None = None, device="cpu"):
        t0 = time.perf_counter()
        self.iter_plan = TriplePlan(list(iter_plan.requests))
        self.iters = int(iters)
        self.seed = seed
        self.log = log if log is not None else CommLog()
        self.device = torch.device(device)
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0
        self._iter_counts = self.iter_plan.class_counts()
        self._per_iter = len(self.iter_plan)
        if group == "auto":
            words = max(1, self.iter_plan.pool_words())
            group = max(1, GROUP_TRANCHE_BYTES // (8 * words))
        self.group = max(1, min(int(group), max(1, self.iters)))
        self._tranche_iters = 1      # iterations covered by _current
        advance = advance or {}
        self._rngs = {key: _advanced_rng(seed, key, advance.get(key, 0))
                      for key in self._iter_counts}
        self.modelled_ot_seconds = _account_offline_plan(
            self.iter_plan.repeat(self.iters), self.log)
        self.gen_seconds = 0.0
        self.wait_seconds = 0.0
        self.pool_bytes = 0          # PEAK concurrent residency
        self._live_bytes = 0
        self._lock = threading.Lock()
        self._executor = None
        self._stream = None
        self._staging = None
        if self.device.type == "cuda":
            self._staging = _Staging()
        if async_gen:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="triple-dealer")
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
        self._pending: list = []     # generated-or-in-flight tranches, FIFO
        self._next_gen = 0           # next tranche index to dispatch
        self._current: _Tranche | None = None
        self._cursors: dict[tuple, int] = {}
        self._served_in_tranche = 0
        self.served_iters = 0
        for _ in range(max(1, prefetch)):
            self._dispatch()
        if self._per_iter and self.iters:
            self._advance()
        # the first-tranche wait is construction (offline) time, already in
        # dealer_seconds — wait_seconds reports ONLINE stalls only
        self.wait_seconds = 0.0
        _sync(self.device)
        self.dealer_seconds = time.perf_counter() - t0

    # -- tranche lifecycle ----------------------------------------------
    def _generate(self, counts) -> _Tranche:
        t0 = time.perf_counter()
        if self._stream is not None:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                tranche = _gen_tranche(self._rngs, counts, self.device,
                                       self._staging)
        else:
            tranche = _gen_tranche(self._rngs, counts, self.device,
                                   self._staging)
        with self._lock:
            self.gen_seconds += time.perf_counter() - t0
            self._live_bytes += tranche.nbytes
            self.pool_bytes = max(self.pool_bytes, self._live_bytes)
        return tranche

    def _dispatch(self) -> None:
        """Queue generation of the next tranche (on the worker) covering
        `group` iterations (fewer for the tail). The single worker
        serializes tranches, so the per-class streams advance in tranche
        order."""
        if self._next_gen >= self.iters:
            return
        g = min(self.group, self.iters - self._next_gen)
        self._next_gen += g
        counts = self._iter_counts if g == 1 else \
            {k: c * g for k, c in self._iter_counts.items()}
        if self._executor is None:
            self._pending.append((g, "done", self._generate(counts)))
        else:
            self._pending.append(
                (g, "fut", self._executor.submit(self._generate, counts)))

    def _advance(self) -> None:
        g, kind, payload = self._pending.pop(0)
        t0 = time.perf_counter()
        tranche = payload.result() if kind == "fut" else payload
        self.wait_seconds += time.perf_counter() - t0
        _take(tranche, self.device)
        self._current = tranche
        self._tranche_iters = g
        self._cursors = {}
        self._served_in_tranche = 0

    def _drop_current(self) -> None:
        nbytes = self._current.nbytes
        self._current = None
        with self._lock:
            self._live_bytes -= nbytes

    def _finish_tranche(self) -> None:
        """Drop the consumed tranche and queue the next generation. The
        advance to the prefetched tranche waits for the next request, so
        the last iteration of an early-stopped fit never stalls on
        randomness it throws away."""
        self.served_iters += self._tranche_iters
        self._drop_current()
        self._cursors = {}
        self._served_in_tranche = 0
        self._dispatch()
        if self.served_iters >= self.iters and self._executor is not None:
            self._executor.shutdown(wait=False)

    # -- serving ---------------------------------------------------------
    def _next(self, kind: str, shape) -> tuple:
        key = _class_key(kind, shape)
        per_iter = self._iter_counts.get(key)
        if per_iter is None:
            raise PoolExhaustedError(
                f"no pool for {kind} {shape}: the offline plan never "
                "scheduled this shape-class (planner/online mismatch)")
        if self._current is None and self.served_iters < self.iters:
            self._advance()                  # lazy: first request of an iter
        i = self._cursors.get(key, 0)
        if self._current is None or i >= per_iter * self._tranche_iters:
            raise PoolExhaustedError(
                f"pool exhausted for {kind} {shape}: planned {per_iter} "
                f"requests/iteration x {self.iters} iterations, online "
                "asked for more")
        self._cursors[key] = i + 1
        out = self._current.pools[key][i]
        self._served_in_tranche += 1
        if self._served_in_tranche == self._per_iter * self._tranche_iters:
            self._finish_tranche()
        return out

    def remaining(self) -> dict:
        """{class_key: unserved across ALL remaining iterations} — surplus
        after e.g. a tol early-stop (undispatched tranches are never
        generated)."""
        rem_tranches = self.iters - self.served_iters
        return {key: rem_tranches * c - self._cursors.get(key, 0)
                for key, c in self._iter_counts.items()}

    def close(self) -> None:
        """Drop buffers and stop the worker (idempotent). Called by a fit
        in a `finally`, so prefetched tranches and the worker thread never
        outlive the loop; `remaining()` stays valid after close."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)   # let in-flight gen finish
        pending, self._pending = self._pending, []
        for _g, kind, payload in pending:
            tranche = payload.result() if kind == "fut" else payload
            with self._lock:
                self._live_bytes -= tranche.nbytes
        if self._current is not None:
            self._drop_current()
        self._staging = None


# ---------------------------------------------------------------------------
# SlotDealer — per-(iteration, batch) tranches for the pipelined executor
# ---------------------------------------------------------------------------

def _request_words(key: tuple) -> int:
    """Words one served request of a shape-class holds."""
    if key[0] == "seed":
        return 1
    shape = key[1:] if key[0] == "matmul" else key[1]
    return sum(_nelem(s) for s in _request_shapes(key[0], shape))


def _gen_tranche_split(rngs: dict, counts_list: list, device,
                       staging: _Staging | None = None) -> list:
    """Generate several consecutive tranches as ONE merged tranche (one
    device tensor per shape-class, `_gen_tranche`), then split the
    per-request entries back out per tranche. Stream-identical to
    generating each tranche separately (the draws concatenate) — this is
    what lets one worker wakeup serve several small slots. The split
    tranches share the merged tensors; each keeps its own byte count, the
    words its own entries hold."""
    merged: dict[tuple, int] = {}
    for counts in counts_list:
        for key, c in counts.items():
            merged[key] = merged.get(key, 0) + c
    whole = _gen_tranche(rngs, merged, device, staging)
    cursors = dict.fromkeys(merged, 0)
    out = []
    for counts in counts_list:
        pools: dict[tuple, list] = {}
        nbytes = 0
        for key, c in counts.items():
            i = cursors[key]
            pools[key] = whole.pools[key][i:i + c]
            cursors[key] = i + c
            nbytes += 8 * c * _request_words(key)
        out.append(_Tranche(pools, nbytes, whole.stacks, whole.ready))
    return out


def _on_dealer(name: str) -> property:
    """A view's attribute that reads and writes its dealer's."""
    return property(lambda self: getattr(self.dealer, name),
                    lambda self, v: setattr(self.dealer, name, v))


class _SlotView(_TripleServing):
    """Dealer view over ONE acquired slot tranche: serves exactly the
    slot's planned requests (per-class cursors, `PoolExhaustedError` past
    them). Counters aggregate on the owning SlotDealer; when the last
    request is served the view drops its entries and the dealer's
    generation window frees a slot."""

    def __init__(self, dealer: "SlotDealer", index: int, pools: dict,
                 counts: dict, total: int, nbytes: int):
        self.dealer = dealer
        self.index = index
        self.log = dealer.log
        self.device = dealer.device
        self._pools = pools
        self._counts = counts
        self._total = total
        self._nbytes = nbytes
        self._cursors: dict[tuple, int] = {}
        self._served = 0

    # the fit-level dealer counters live on the SlotDealer, so results can
    # compare them across offline and pipeline modes
    n_matmul = _on_dealer("n_matmul")
    n_mul = _on_dealer("n_mul")
    n_bin = _on_dealer("n_bin")

    def _next(self, kind: str, shape) -> tuple:
        key = _class_key(kind, shape)
        limit = self._counts.get(key)
        if limit is None:
            raise PoolExhaustedError(
                f"no pool for {kind} {shape} in slot {self.index}: the slot "
                "plan never scheduled this shape-class (planner/online "
                "mismatch)")
        i = self._cursors.get(key, 0)
        if i >= limit:
            raise PoolExhaustedError(
                f"slot {self.index} pool exhausted for {kind} {shape}: "
                f"planned {limit} requests, online asked for more")
        self._cursors[key] = i + 1
        out = self._pools[key][i]
        self._served += 1
        if self._served == self._total:
            self._pools = {}
            self.dealer._release(self.index, self._nbytes)
        return out


class SlotDealer:
    """Per-slot tranche pools for the pipelined minibatch executor.

    The offline schedule is a SEQUENCE of slot plans — per Lloyd iteration
    ``[S1(batch 0), S3(batch 0), S1(batch 1), ..., finalize]`` — and each
    slot's correlated randomness is generated as its own tranche from the
    same persistent per-class PCG64 streams as every other dealer, always
    in canonical slot order. ``acquire(i)`` hands slot i's tranche out as a
    dealer view; acquisition may run AHEAD of lower slots (the pipelined
    executor pins batch t+1's S1 tranche while batch t's launch is in
    flight) without changing a served word, because GENERATION order, not
    acquisition order, fixes the streams. That is what makes
    ``pipeline=True`` stream-identical to ``pipeline=False``.

    stream=False (the pooled offline phase): every slot is generated up
    front in one merged pass (one device tensor per shape-class) — the
    PooledDealer's residency and speed, slot-indexed serving. stream=True:
    a background worker generates slots in order with at most
    ``SLOT_WINDOW`` generated-but-unconsumed slots alive (backpressure,
    overridden when a caller waits on a slot further ahead), so peak
    residency is O(window x slot bytes), independent of n and iters.
    Consecutive small slots are generated in one wakeup of at least
    ``GROUP_TRANCHE_BYTES`` (still split and served per slot). On CUDA the
    worker uploads through pinned staging on a stream of its own; an
    acquired slot makes the caller's stream wait on its upload's event and
    marks its tensors in use by that stream, so their memory is reused
    only after the kernels queued there have run.

    ``start_slot`` skips the slots an interrupted run consumed: they are
    never generated and each class stream starts past their requests.
    ``pool_bytes`` is the peak of the live slots' bytes, counted per slot
    as the JAX package counts them (slots of one merged group share its
    tensors). Word for word equal to ``PooledDealer(concat(slot_plans),
    seed)`` for any acquisition order that consumes each slot's own plan
    exactly."""

    def __init__(self, slot_plans, seed: int = 0, log: CommLog | None = None,
                 stream: bool = True, start_slot: int = 0, device="cpu"):
        t0 = time.perf_counter()
        self.slot_plans = [TriplePlan(list(p.requests)) for p in slot_plans]
        self.seed = seed
        self.log = log if log is not None else CommLog()
        self.stream = bool(stream)
        self.device = torch.device(device)
        self.start_slot = int(start_slot)
        if not 0 <= self.start_slot <= len(self.slot_plans):
            raise IndexError(f"start_slot {start_slot} out of range "
                             f"({len(self.slot_plans)} slots planned)")
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0
        self.gen_seconds = 0.0
        self.wait_seconds = 0.0      # online acquire() stalls
        self.pool_bytes = 0          # PEAK concurrent residency
        self._live_bytes = 0
        self._live_slots = 0
        self._counts = [p.class_counts() for p in self.slot_plans]
        self._totals = [len(p) for p in self.slot_plans]
        keys = sorted({k for c in self._counts for k in c})
        skip: dict[tuple, int] = {}
        for counts in self._counts[:self.start_slot]:
            for key, c in counts.items():
                skip[key] = skip.get(key, 0) + c
        self._rngs = {key: _advanced_rng(seed, key, skip.get(key, 0))
                      for key in keys}
        # only the slots this dealer generates reach its offline books
        self.modelled_ot_seconds = _account_offline_plan(
            TriplePlan([r for p in self.slot_plans[self.start_slot:]
                        for r in p.requests]),
            self.log)
        # the remaining slots in generation groups of >= GROUP_TRANCHE_BYTES
        self._groups: list[tuple[int, int]] = []
        i = self.start_slot
        while i < len(self.slot_plans):
            j = i + 1
            b = 8 * self.slot_plans[i].pool_words()
            while j < len(self.slot_plans) and b < GROUP_TRANCHE_BYTES:
                b += 8 * self.slot_plans[j].pool_words()
                j += 1
            self._groups.append((i, j))
            i = j
        self._ready: dict[int, _Tranche] = {}
        self._acquired: set[int] = set(range(self.start_slot))
        self._served_class: dict[tuple, int] = dict(skip)
        self._cond = threading.Condition()
        self._closed = False
        self._error: BaseException | None = None
        self._max_requested = -1     # highest slot a caller is waiting on
        self._worker = None
        self._side = None            # the worker's upload stream (CUDA)
        self._staging = _Staging() if self.device.type == "cuda" else None
        if not self.stream:
            # pooled: ONE merged generation pass over the remaining schedule
            for i, tr in enumerate(_gen_tranche_split(
                    self._rngs, self._counts[self.start_slot:], self.device,
                    self._staging), start=self.start_slot):
                self._ready[i] = tr
                self._live_bytes += tr.nbytes
                self._live_slots += 1
            self.pool_bytes = self._live_bytes
            self._staging = None
            _sync(self.device)
        elif self._groups:
            max_group = max(hi - lo for lo, hi in self._groups)
            self._window = max(SLOT_WINDOW, max_group + 1)
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(self.device)
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="slot-dealer", daemon=True)
            self._worker.start()
        self.dealer_seconds = time.perf_counter() - t0

    # -- generation ------------------------------------------------------
    def _gen_group(self, gi: int) -> None:
        """Generate group gi's slots (caller holds no lock); fill _ready."""
        lo, hi = self._groups[gi]
        t0 = time.perf_counter()
        if self._side is not None:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._side):
                tranches = _gen_tranche_split(self._rngs, self._counts[lo:hi],
                                              self.device, self._staging)
        else:
            tranches = _gen_tranche_split(self._rngs, self._counts[lo:hi],
                                          self.device, self._staging)
        with self._cond:
            self.gen_seconds += time.perf_counter() - t0
            for i, tr in zip(range(lo, hi), tranches):
                self._ready[i] = tr
                self._live_slots += 1
                self._live_bytes += tr.nbytes
            self.pool_bytes = max(self.pool_bytes, self._live_bytes)
            self._cond.notify_all()

    def _worker_loop(self) -> None:
        try:
            for gi, (lo, hi) in enumerate(self._groups):
                with self._cond:
                    # backpressure: hold generation at `window` live slots —
                    # unless a caller already WAITS on a slot this group
                    # must be generated for (acquire can run ahead of
                    # consumption; stalling it here would deadlock)
                    while (self._live_slots + (hi - lo) > self._window
                           and lo > self._max_requested
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                self._gen_group(gi)
        except BaseException as e:             # surfaces at the next acquire
            with self._cond:
                self._error = e
                self._cond.notify_all()

    # -- acquisition -----------------------------------------------------
    def acquire(self, i: int) -> _SlotView:
        """Slot i's tranche as a dealer view (blocking until generated).
        Each slot can be acquired exactly once; out-of-order acquisition is
        fine — the words a slot serves are fixed at generation time."""
        if not 0 <= i < len(self.slot_plans):
            raise IndexError(f"slot {i} out of range "
                             f"({len(self.slot_plans)} slots planned)")
        t0 = time.perf_counter()
        with self._cond:
            if i in self._acquired:
                raise PoolExhaustedError(
                    f"slot {i} was already acquired: each slot serves its "
                    "plan exactly once")
            if self._worker is not None:      # pooled mode is pre-filled
                self._max_requested = max(self._max_requested, i)
                self._cond.notify_all()
                while i not in self._ready and self._error is None \
                        and not self._closed:
                    self._cond.wait()
            if i not in self._ready:
                if self._error is not None:
                    raise RuntimeError("slot-dealer worker failed") \
                        from self._error
                raise PoolExhaustedError(f"slot {i} unavailable "
                                         "(dealer closed)")
            tranche = self._ready.pop(i)
            self._acquired.add(i)
            self.wait_seconds += time.perf_counter() - t0
        _take(tranche, self.device)
        view = _SlotView(self, i, tranche.pools, self._counts[i],
                         self._totals[i], tranche.nbytes)
        if self._totals[i] == 0:               # empty slot: nothing to serve
            self._release(i, tranche.nbytes)
        return view

    def _release(self, i: int, nbytes: int) -> None:
        with self._cond:
            for key, c in self._counts[i].items():
                self._served_class[key] = self._served_class.get(key, 0) + c
            self._live_slots -= 1
            self._live_bytes -= nbytes
            self._cond.notify_all()

    def remaining(self) -> dict:
        """{class_key: unserved across unacquired + unconsumed slots} —
        surplus after e.g. a tol early stop."""
        total: dict[tuple, int] = {}
        for counts in self._counts:
            for key, c in counts.items():
                total[key] = total.get(key, 0) + c
        return {key: c - self._served_class.get(key, 0)
                for key, c in total.items()}

    def close(self) -> None:
        """Stop the worker and drop generated-but-unacquired tranches
        (idempotent). A fit calls it in a `finally`, so an early stop or
        an exception never leaves the worker thread alive."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        with self._cond:
            for tranche in self._ready.values():
                self._live_slots -= 1
                self._live_bytes -= tranche.nbytes
            self._ready.clear()
        self._staging = None


# ---------------------------------------------------------------------------
# TripleBank — persistent cross-fit pool: provision once, serve many
# ---------------------------------------------------------------------------

def _key_to_str(key: tuple) -> str:
    return repr(tuple(key))


def _key_from_str(s: str) -> tuple:
    import ast
    return tuple(ast.literal_eval(s))


_SLOTS = {"matmul": 6, "mul": 6, "bin": 6, "rand": 1, "seed": 1}


def _entry_bytes(entry: tuple) -> int:
    """Bytes one served request holds, counted without touching the device
    (a seed request is one host word)."""
    return 8 * sum(a.numel() if isinstance(a, torch.Tensor) else 1
                   for a in entry)


def _provision_items(counts: dict, workers: int) -> list:
    """Deterministic split of a bulk-generation request into `(class_key,
    start, count)` chunks: whole classes, the heavy ones subdivided by word
    volume so no worker idles behind one giant class. A pure function of
    `(counts, workers)` — scheduling and completion order cannot influence
    which words a chunk draws, because each chunk re-derives its stream
    position from (class stream start, request offset) alone."""
    total = sum(int(c) * _class_words(k) for k, c in counts.items())
    target = max(1, -(-total // max(1, int(workers))))
    items = []
    for key in sorted(counts):
        count = int(counts[key])
        if count <= 0:
            continue
        wpr = _class_words(key)
        nchunks = max(1, min(count, -(-(count * wpr) // target)))
        base, extra = divmod(count, nchunks)
        start = 0
        for i in range(nchunks):
            cnt = base + (1 if i < extra else 0)
            items.append((key, start, cnt))
            start += cnt
    return items


def _gen_provision_item(states: dict, item: tuple) -> tuple:
    """The word arrays of one chunk, drawn from a PRIVATE clone of its class
    stream advanced to the chunk's request offset. `ring.rand_np` draws
    exactly `_class_words(key)` PCG64 words per request, so
    advance(start * words) lands the clone on the words request `start` of
    the serial stacked draw would consume: chunked generation concatenates
    to the serial draw word for word."""
    key, start, count = item
    rng = np.random.default_rng(0)
    rng.bit_generator.state = states[key]
    if start:
        rng.bit_generator.advance(int(start) * _class_words(key))
    kind = key[0]
    shape = key[1:] if kind == "matmul" else key[1]
    return _gen_class(rng, kind, shape, count)


def _run_provision_items(items: list, states: dict, workers: int) -> list:
    """Run the chunks on a thread pool (numpy's draws and einsum release the
    GIL); results come back in ITEM order whatever the completion order."""
    with ThreadPoolExecutor(max_workers=int(workers)) as ex:
        return list(ex.map(lambda it: _gen_provision_item(states, it), items))


class _Shelved:
    """A bank tranche as its queued entries see it: the consumer streams
    that already waited on its upload and marked its tensors in use."""

    def __init__(self, tranche: _Tranche):
        self.tranche = tranche
        self.taken: set = set()

    def take(self, device) -> None:
        """`_take` once per consumer stream."""
        if self.tranche.ready is None:
            return
        sid = torch.cuda.current_stream(device).cuda_stream
        if sid not in self.taken:
            _take(self.tranche, device)
            self.taken.add(sid)


class TripleBank:
    """A persistent correlated-randomness store serving MANY protocol runs
    (fits, predict batches, scoring services) from one provisioning pass.

    Structure: one FIFO queue of per-request word tuples per shape-class,
    fed by the same per-class PCG64 streams as every dealer — so a freshly
    provisioned bank serves the words of a same-seeded `TrustedDealer` for
    any request sequence with matching per-class order. Plans are
    registered under a lookup key (`SecureKMeans.plan_predict`'s or
    `plan_fit`'s key) by `provision`; `dealer(key)` hands out a
    `BankDealer` view that draws from the shared class queues.

    The words live on `device`: each generation is one tranche
    (`_gen_tranche`: a tensor per class, the entries views of it), uploaded
    on the bank's own stream through pinned staging on a GPU. The first pop
    from a tranche on a consumer stream makes that stream wait on the
    upload's event and marks the tranche's tensors in use by it, so their
    memory is reused only after the consumer's kernels ran. A popped entry
    keeps its whole class tensor alive, so `pool_bytes` (unserved bytes) is
    not the device memory held.

    Exhaustion: an empty class is a stock-out, not corruption — with
    `auto_replenish` the bank generates one more execution of the
    requesting key's registered plan (the class streams simply advance)
    and keeps serving; the stall is counted in `replenish_events` /
    `replenish_seconds`, so a service can size its copies to keep
    replenishment off the online path.

    Persistence: `save`/`load` round-trip the unserved words and the
    per-class stream positions through one npz archive, in the JAX
    package's format, so a bank saved by either package loads in the other
    and serves the same words.

    Thread safety: a `BankReplenisher` daemon may top the bank up while
    serving threads draw from it. `_gen_lock` serializes every per-class
    STREAM advance (two generations from one snapshot would serve the same
    mask words twice), `_lock` guards the queues and counters. Lock order
    is `_gen_lock` → `_lock`; nothing takes `_gen_lock` while holding
    `_lock`.
    """

    BANK_FORMAT = "repro.triplebank"
    BANK_VERSION = 2

    def __init__(self, seed: int = 0, auto_replenish: bool = True,
                 log: CommLog | None = None, device="cuda"):
        self.seed = int(seed)
        self.auto_replenish = auto_replenish
        self.log = log if log is not None else CommLog()
        self.device = torch.device(device)
        self._rngs: dict[tuple, np.random.Generator] = {}
        self._queues: dict[tuple, list] = {}   # class key -> [(entry, shelf)]
        self._plans: dict[tuple, TriplePlan] = {}
        self._lock = threading.RLock()       # queues + counters
        self._gen_lock = threading.RLock()   # per-class stream advance
        self._stream = None                  # the upload stream (CUDA)
        self._staging = None
        self.modelled_ot_seconds = 0.0
        self.gen_seconds = 0.0
        self.replenish_seconds = 0.0
        self.replenish_events = 0
        self.pool_bytes = 0              # live (unserved) bytes
        self.served_requests = 0
        self.consumed_class: dict[tuple, int] = {}   # lifetime pops per class

    # -- generation ------------------------------------------------------
    def _shelve(self, counts: dict, draws=None) -> None:
        """One tranche of `counts` requests per class onto the queues, words
        from `draws` (default: the class streams). Caller holds
        `_gen_lock`."""
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._staging = _Staging()
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                tranche = _gen_tranche(self._rngs, counts, self.device,
                                       self._staging, draws)
        else:
            tranche = _gen_tranche(self._rngs, counts, self.device,
                                   None, draws)
        shelf = _Shelved(tranche)
        with self._lock:
            for key, entries in tranche.pools.items():
                self._queues.setdefault(key, []).extend(
                    (e, shelf) for e in entries)
            self.pool_bytes += tranche.nbytes

    def _gen(self, counts: dict, workers: int = 1) -> None:
        t0 = time.perf_counter()
        with self._gen_lock:
            for key in counts:
                self._rngs.setdefault(key, _class_rng(self.seed, key))
            if workers <= 1 or len(counts) == 0:
                self._shelve(counts)
            else:
                items = _provision_items(counts, workers)
                # chunks are offsets from the CURRENT stream positions
                states = {key: self._rngs[key].bit_generator.state
                          for key in counts}
                results = _run_provision_items(items, states, workers)
                chunks: dict[tuple, list] = {}
                for (key, start, _cnt), arrays in zip(items, results):
                    chunks.setdefault(key, []).append((start, arrays))
                self._shelve(counts, lambda key, _count: chunks.get(key, []))
                # master streams end exactly where one stacked draw would
                for key, count in counts.items():
                    self._rngs[key].bit_generator.advance(
                        int(count) * _class_words(key))
            self.gen_seconds += time.perf_counter() - t0

    # -- provisioning ----------------------------------------------------
    def provision(self, key, plan: TriplePlan, copies: int = 1,
                  workers: int = 1) -> None:
        """Register `plan` under the lookup `key` and generate `copies`
        executions' worth of it into the class queues (stacked draws and
        batched ring ops per class, like PooledDealer). Calling again with
        the same key re-registers (a changed plan replaces the old one) and
        tops the stock up.

        `workers > 1` fans the generation out over a thread pool, split by
        shape-class and, within a heavy class, by `advance`-offset chunks.
        The words are those of the serial draw for ANY worker count and
        completion order."""
        key = tuple(key)
        with self._lock:
            self._plans[key] = TriplePlan(list(plan.requests))
        if copies > 0:
            with _trace.span("bank.provision", key=str(key),
                             copies=int(copies), workers=int(workers)):
                counts = {ck: c * int(copies)
                          for ck, c in plan.class_counts().items()}
                self._gen(counts, workers=workers)
                self.modelled_ot_seconds += _account_offline_plan(
                    plan.repeat(copies), self.log)

    def keys(self) -> list:
        with self._lock:
            return list(self._plans)

    def stock(self) -> dict:
        """{class_key: unserved request count} across the whole bank."""
        with self._lock:
            return {k: len(q) for k, q in self._queues.items()}

    def stock_copies(self, key) -> int:
        """Complete executions of `key`'s registered plan in stock: the
        min over its classes of shelf depth // per-execution count."""
        key = tuple(key)
        with self._lock:
            counts = self._plans[key].class_counts()
            if not counts:
                return 0
            return min(len(self._queues.get(ck, ())) // c
                       for ck, c in counts.items())

    def dealer(self, key, log: CommLog | None = None) -> "BankDealer":
        key = tuple(key)
        if key not in self._plans:
            raise KeyError(f"TripleBank has no plan registered under "
                           f"{key!r}; call provision() first")
        return BankDealer(self, key, log=log)

    # -- serving ---------------------------------------------------------
    def _pop(self, class_key: tuple, plan_key: tuple) -> tuple:
        while True:
            with self._lock:
                q = self._queues.get(class_key)
                if q:
                    out, shelf = q.pop(0)
                    self.pool_bytes -= _entry_bytes(out)
                    self.served_requests += 1
                    self.consumed_class[class_key] = \
                        self.consumed_class.get(class_key, 0) + 1
                    break
            # shelf empty: regenerate OUTSIDE the queue lock (generation is
            # long), then retry — a racing daemon top-up may beat us to it
            self._replenish(class_key, plan_key)
        shelf.take(self.device)
        return out

    def _replenish(self, class_key: tuple, plan_key: tuple) -> None:
        """Stock-out handling: regenerate the requesting key's whole plan
        (keeping its classes aligned for the next request) — or, for a
        class the plan never mentions, a single request. Raises
        `PoolExhaustedError` only when replenishment is disabled.

        Serialized on `_gen_lock` against daemon top-ups: by the time the
        lock is held, a concurrent generation may already have restocked
        the shelf — then the wait was the whole stall (counted, no event)
        and no words are drawn."""
        if not self.auto_replenish:
            raise PoolExhaustedError(
                f"TripleBank stock-out for {class_key}: provisioned pool "
                "consumed and auto_replenish=False")
        t0 = time.perf_counter()
        with _trace.span("bank.replenish", class_key=str(class_key)), \
                self._gen_lock:
            with self._lock:
                restocked = bool(self._queues.get(class_key))
                plan = self._plans.get(tuple(plan_key))
            if restocked:
                self.replenish_seconds += time.perf_counter() - t0
                return
            if plan is not None and class_key in plan.class_counts():
                self._gen(plan.class_counts())
                self.modelled_ot_seconds += _account_offline_plan(
                    plan, self.log)
            else:
                self._gen({class_key: 1})
            self.replenish_events += 1
            self.replenish_seconds += time.perf_counter() - t0

    def consumed_counts(self) -> dict:
        """Cumulative per-class consumed-request counts (a copy)."""
        with self._lock:
            return dict(self.consumed_class)

    def discard(self, counts: dict) -> None:
        """Pop and DROP `counts[class_key]` requests per class: a reloaded
        bank skips the requests an earlier incarnation already served, so
        no word is served twice (a class's served words are always the same
        stream prefix, whenever and under whichever plan they were
        generated)."""
        for class_key in sorted(counts):
            n = int(counts[class_key])
            if n <= 0:
                continue
            with self._lock:
                plan_key = next(
                    (pk for pk, plan in self._plans.items()
                     if class_key in plan.class_counts()), class_key)
            for _ in range(n):
                self._pop(class_key, plan_key)

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz archive: per class, the unserved requests stacked per
        tensor slot as uint64, plus a JSON manifest carrying the class keys,
        stream positions, registered plans, a format marker and version,
        and a CRC32 per array — so `load` can refuse a truncated,
        bit-flipped or foreign file. The JAX package's format: either
        package loads the other's file. The path is used verbatim."""
        import json
        import zlib
        classes = []
        arrays = {}
        with self._gen_lock, self._lock:
            # every class with a stream is saved, queued stock or not:
            # stream position is state even when the shelf is empty
            all_keys = set(self._rngs) | set(self._queues)
            for i, key in enumerate(sorted(all_keys)):
                q = self._queues.get(key, [])
                rng = self._rngs.get(key) or _class_rng(self.seed, key)
                for _entry, shelf in q:
                    shelf.take(self.device)
                for s in range(_SLOTS[key[0]]):
                    if not q:
                        continue
                    if key[0] == "seed":
                        arrays[f"c{i}_s{s}"] = np.array(
                            [e[s] for e, _ in q], np.uint64)
                    else:
                        arrays[f"c{i}_s{s}"] = ring.to_u64_numpy(
                            torch.stack([e[s] for e, _ in q]))
                classes.append({"key": _key_to_str(key), "count": len(q),
                                "rng_state": rng.bit_generator.state})
            plans = {
                _key_to_str(k): [[r.kind, list(r.shape) if r.kind != "matmul"
                                  else [list(r.shape[0]), list(r.shape[1])],
                                  r.tag] for r in plan.requests]
                for k, plan in self._plans.items()}
        checksums = {name: zlib.crc32(np.ascontiguousarray(a).tobytes())
                     for name, a in arrays.items()}
        manifest = {"format": self.BANK_FORMAT, "version": self.BANK_VERSION,
                    "seed": self.seed, "classes": classes, "plans": plans,
                    "checksums": checksums}
        with open(path, "wb") as f:
            np.savez(f, manifest=np.frombuffer(
                json.dumps(manifest).encode(), np.uint8), **arrays)

    @classmethod
    def load(cls, path: str, auto_replenish: bool = True,
             log: CommLog | None = None, device="cuda") -> "TripleBank":
        """Load a `save`d bank (of either package) onto `device`, validating
        format, version and per-array checksums. Any structural damage —
        truncation, bit flips, a foreign npz, an unreadable manifest —
        raises `ValueError` naming the problem. Each class's queue is
        rebuilt as views of one tensor, as a generation builds it."""
        import json
        import zipfile
        import zlib

        def bad(reason: str) -> ValueError:
            return ValueError(f"not a valid TripleBank file {path!r}: "
                              f"{reason}")
        try:
            z = np.load(path)
        except (zipfile.BadZipFile, OSError, EOFError, ValueError) as e:
            raise bad(f"unreadable archive ({e})") from e
        with z:
            if "manifest" not in getattr(z, "files", ()):
                raise bad("no manifest (foreign or pre-format npz)")
            try:
                manifest = json.loads(bytes(z["manifest"]).decode())
            except (zipfile.BadZipFile, OSError, EOFError, KeyError,
                    UnicodeDecodeError, json.JSONDecodeError,
                    ValueError) as e:
                raise bad(f"manifest unreadable ({e})") from e
            if not isinstance(manifest, dict) \
                    or manifest.get("format") != cls.BANK_FORMAT:
                raise bad("manifest format marker missing or foreign")
            if manifest.get("version") != cls.BANK_VERSION:
                raise bad(f"format version {manifest.get('version')!r}, "
                          f"expected {cls.BANK_VERSION}")
            try:
                checksums = manifest["checksums"]
                expected_names = set(checksums)
                stored = set(z.files) - {"manifest"}
                if stored != expected_names:
                    raise bad("archive arrays do not match the manifest "
                              f"(missing {sorted(expected_names - stored)}, "
                              f"unexpected {sorted(stored - expected_names)})")
                loaded = {}
                for name in sorted(expected_names):
                    try:
                        a = z[name]
                    except (zipfile.BadZipFile, OSError, EOFError,
                            ValueError) as e:
                        raise bad(f"array {name!r} unreadable — truncated "
                                  f"archive? ({e})") from e
                    crc = zlib.crc32(np.ascontiguousarray(a).tobytes())
                    if crc != int(checksums[name]):
                        raise bad(f"checksum mismatch on array {name!r} "
                                  "(bit rot or tampering)")
                    loaded[name] = a
                bank = cls(seed=manifest["seed"],
                           auto_replenish=auto_replenish, log=log,
                           device=device)
                counts, words = {}, {}
                for i, entry in enumerate(manifest["classes"]):
                    key = _key_from_str(entry["key"])
                    rng = np.random.default_rng(0)
                    rng.bit_generator.state = entry["rng_state"]
                    bank._rngs[key] = rng
                    count = int(entry["count"])
                    if count:
                        slots = [np.asarray(loaded[f"c{i}_s{s}"], np.uint64)
                                 for s in range(_SLOTS[key[0]])]
                        if any(a.shape[0] != count for a in slots):
                            raise bad(f"class {entry['key']} declares "
                                      f"{count} requests but arrays "
                                      "disagree")
                        counts[key] = count
                        words[key] = [(0, slots)]
                plans_raw = manifest["plans"]
            except ValueError:
                raise
            except (KeyError, IndexError, TypeError, SyntaxError) as e:
                raise bad(f"malformed manifest structure ({e})") from e
        with bank._gen_lock:
            bank._shelve(counts, lambda key, _count: words[key])
        for kstr, reqs in plans_raw.items():
            reqs = [PlanRequest(kind,
                                (tuple(shape[0]), tuple(shape[1]))
                                if kind == "matmul" else tuple(shape), tag)
                    for kind, shape, tag in reqs]
            bank._plans[_key_from_str(kstr)] = TriplePlan(reqs)
        return bank


class BankReplenisher:
    """Standing top-up daemon for a `TripleBank`: a background thread that
    watches per-plan stock and regenerates BEFORE the hot path runs dry.

    Policy: whenever a registered plan key's complete-execution stock
    (`bank.stock_copies`) falls to `low_water` or below, provision enough
    copies to restore `high_water`. Generation runs on this thread under
    the bank's `_gen_lock` (on the bank's upload stream on a GPU), so a
    top-up can never fork a class stream against a hot-path replenish, and
    since every class FIFO is only ever extended with its own stream's next
    words, the words SERVED are those of a purely synchronous bank however
    daemon and hot-path generation interleave. If the daemon falls behind,
    `TripleBank._pop` still replenishes synchronously.

    A generation failure is recorded (`errors`, `last_error`) and the
    daemon keeps polling."""

    def __init__(self, bank: TripleBank, *, low_water: int = 1,
                 high_water: int | None = None, poll_s: float = 0.002,
                 workers: int = 1, keys=None):
        self.bank = bank
        self.low_water = max(0, int(low_water))
        self.high_water = int(high_water) if high_water is not None \
            else max(self.low_water + 1, 2 * self.low_water)
        if self.high_water <= self.low_water:
            raise ValueError(
                f"high_water ({self.high_water}) must exceed low_water "
                f"({self.low_water}) or the daemon top-up never gains stock")
        self.poll_s = float(poll_s)
        self.workers = int(workers)
        self._keys = None if keys is None else [tuple(k) for k in keys]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.topups = 0                 # top-up passes that generated
        self.topup_copies = 0           # plan executions generated
        self.topup_seconds = 0.0        # daemon-side generation wall
        self.errors = 0
        self.last_error: BaseException | None = None

    def poll_once(self) -> int:
        """Scan every watched key; top up those at or below the low-water
        mark. Returns the number of plan copies generated."""
        made = 0
        keys = self._keys if self._keys is not None else self.bank.keys()
        for key in keys:
            if self._stop.is_set():
                break
            with self.bank._lock:
                plan = self.bank._plans.get(tuple(key))
            if plan is None:
                continue
            have = self.bank.stock_copies(key)
            if have > self.low_water:
                continue
            need = self.high_water - have
            t0 = time.perf_counter()
            with _trace.span("bank.topup", key=str(key), copies=need,
                             stock=have):
                self.bank.provision(key, plan, copies=need,
                                    workers=self.workers)
            self.topup_seconds += time.perf_counter() - t0
            self.topups += 1
            self.topup_copies += need
            made += need
        return made

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:        # noqa: BLE001 — the daemon lives on
                self.errors += 1
                self.last_error = e
            self._stop.wait(self.poll_s)

    def start(self) -> "BankReplenisher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="bank-replenisher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "BankReplenisher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class BankDealer(_TripleServing):
    """Dealer view over a `TripleBank` for one plan key — the interface of
    `TrustedDealer` (same methods and counters), so it drops into
    `SecureKMeans.predict(..., dealer=...)`, `fit(dealer=...)` and
    `materialize_offline`. `dealer_seconds` counts only the replenishment
    stalls met while THIS view was serving (online time); provisioned
    generation stays on the bank's offline clock."""

    def __init__(self, bank: TripleBank, key: tuple,
                 log: CommLog | None = None):
        self.bank = bank
        self.key = tuple(key)
        self.log = log if log is not None else CommLog()
        self.device = bank.device
        self.dealer_seconds = 0.0
        self.modelled_ot_seconds = 0.0
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0

    def _next(self, kind: str, shape) -> tuple:
        r0 = self.bank.replenish_seconds
        out = self.bank._pop(_class_key(kind, shape), self.key)
        self.dealer_seconds += self.bank.replenish_seconds - r0
        return out

    def skip(self, plan, reps: int = 1) -> None:
        """Drain `reps` executions of `plan` without serving them: realigns
        the bank's queues past the requests an earlier run consumed."""
        for _ in range(int(reps)):
            for r in plan.requests:
                self.bank._pop(_class_key(r.kind, r.shape), self.key)


class BankSlotDealer:
    """`SlotDealer`'s interface over a provisioned `TripleBank` for the
    minibatch fit: every slot's entries are popped from the bank's class
    queues in canonical slot order at construction. The pipelined executor
    may `acquire` slots ahead of consumption; since the bank's queue
    positions were fixed at provisioning and this view drains every slot
    before the loop starts, acquisition order never changes a served word.

    Word for word `SlotDealer(slot_plans, seed)` when the bank was
    provisioned under the same seed with the concatenated slot plans (the
    bank's draw per class is the SlotDealer's per-class concatenation in
    canonical order).

    ``start_slot`` resumes a checkpointed fit against a freshly provisioned
    bank: the slots an interrupted run consumed are popped and dropped, so
    slot ``start_slot`` serves the entries it would have served."""

    def __init__(self, bank: TripleBank, key: tuple, slot_plans,
                 log: CommLog | None = None, start_slot: int = 0):
        t0 = time.perf_counter()
        self.bank = bank
        self.key = tuple(key)
        self.slot_plans = [TriplePlan(list(p.requests)) for p in slot_plans]
        self.log = log if log is not None else CommLog()
        self.device = bank.device
        self.start_slot = int(start_slot)
        if not 0 <= self.start_slot <= len(self.slot_plans):
            raise IndexError(f"start_slot {start_slot} out of range "
                             f"({len(self.slot_plans)} slots planned)")
        self.n_matmul = 0
        self.n_mul = 0
        self.n_bin = 0
        self.gen_seconds = 0.0
        self.wait_seconds = 0.0
        # provisioning's modelled OT cost lives on the bank's offline books
        self.modelled_ot_seconds = 0.0
        self._counts = [p.class_counts() for p in self.slot_plans]
        self._totals = [len(p) for p in self.slot_plans]
        self._served_class: dict[tuple, int] = {}
        self._acquired: set[int] = set()
        self._slots: list[tuple] = []
        self.pool_bytes = 0
        for si, plan in enumerate(self.slot_plans):
            if si < self.start_slot:
                for r in plan.requests:
                    bank._pop(_class_key(r.kind, r.shape), self.key)
                for ck, c in self._counts[si].items():
                    self._served_class[ck] = self._served_class.get(ck, 0) + c
                self._acquired.add(si)
                self._slots.append((None, 0))
                continue
            pools: dict[tuple, list] = {}
            nbytes = 0
            for r in plan.requests:
                ck = _class_key(r.kind, r.shape)
                out = bank._pop(ck, self.key)
                pools.setdefault(ck, []).append(out)
                nbytes += _entry_bytes(out)
            self._slots.append((pools, nbytes))
            self.pool_bytes += nbytes
        # the pin (pops and any replenish stall) is offline dealer time
        self.dealer_seconds = time.perf_counter() - t0

    def acquire(self, i: int) -> _SlotView:
        if not 0 <= i < len(self.slot_plans):
            raise IndexError(f"slot {i} out of range "
                             f"({len(self.slot_plans)} slots planned)")
        if i in self._acquired:
            raise PoolExhaustedError(
                f"slot {i} was already acquired: each slot serves its "
                "plan exactly once")
        self._acquired.add(i)
        pools, nbytes = self._slots[i]
        self._slots[i] = (None, nbytes)          # the view owns the entries
        view = _SlotView(self, i, pools, self._counts[i], self._totals[i],
                         nbytes)
        if self._totals[i] == 0:                 # empty slot: nothing to serve
            self._release(i, nbytes)
        return view

    def _release(self, i: int, nbytes: int) -> None:
        for key, c in self._counts[i].items():
            self._served_class[key] = self._served_class.get(key, 0) + c

    def remaining(self) -> dict:
        total: dict[tuple, int] = {}
        for counts in self._counts:
            for key, c in counts.items():
                total[key] = total.get(key, 0) + c
        return {key: c - self._served_class.get(key, 0)
                for key, c in total.items()}

    def close(self) -> None:
        self._slots = [(None, nb) for _pools, nb in self._slots]
