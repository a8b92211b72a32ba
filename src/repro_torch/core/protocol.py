"""2PC protocol ops over additive shares (paper Sec 3.1 / 4.2).

SADD (local), SMUL (elementwise + vectorized matmul via Beaver triples),
SecureML local truncation, MSB via a bit-packed Kogge-Stone adder (log_2 l
AND rounds), CMP, B2A, MUX, the tournament argmin F^k_min (Fig. 1), and a
Newton-Raphson secure reciprocal for the centroid-update division.

Everything is vectorized: one CMP call compares whole (n, k/2) tensors, one
matmul call moves whole matrices. All ops take a `Ctx` that carries the
triple provider (offline phase), the communication log and the ring backend.
Per-op traffic is shape-determined and exact.

Words are int64 tensors (core/ring.py): every uint64 `>>` of the protocol
is `ring.logical_rshift`.

A call that records program spans (obs/trace.py) carries them on its
`Ctx`: `beaver.open` around each masked-operand computation and its
exchange (args `kind`, `triples` opened; the reciprocal's whole Newton
loop is one), `beaver.combine` around each other recombination,
`s2.level` around each round of the tournament (args `level`, `pairs`
compared). With `ctx.spans` None an op pays one
attribute check and enters the shared no-op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ring
from repro_torch.core.backend import KS_LEVELS, RingBackend, get_backend
from repro_torch.core.channel import CommLog
from repro_torch.core.sharing import AShare, BShare
from repro_torch.core.triples import TrustedDealer
from repro_torch.obs.trace import NOOP, ProgramSpans


FUSE_BEAVER = True
# P0's Beaver recombination z0 = z + u0@F + e@v0 + e@F folds into
# z + u0@F + e@(v0 + F): one fewer ring matmul on the online critical path
# (pure local algebra, no protocol/security change).


@dataclasses.dataclass
class Ctx:
    dealer: TrustedDealer
    log: CommLog
    tag: str = "misc"  # current Lloyd step: S1 / S2 / S3
    backend: RingBackend | str | None = "cuda"  # local ring-compute
    # dispatch; "auto" / None resolve by the dealer's device
    he_seconds: float = 0.0  # modelled HE wall-time accumulated by Protocol 2
    parent: "Ctx | None" = dataclasses.field(default=None, repr=False)
    # a fork's parent: its modelled HE time is added there (see `fork`)
    spans: ProgramSpans | None = dataclasses.field(default=None, repr=False)
    # the program spans this call records (obs/trace.py:program_spans),
    # resolved once per program call; None records none

    def __post_init__(self):
        self.backend = get_backend(self.backend, self.device)

    @property
    def device(self) -> torch.device:
        return self.dealer.device

    def send(self, nbytes: int, rounds: int = 1) -> None:
        self.log.send(nbytes, tag=self.tag, phase="online", rounds=rounds)

    def add_he_seconds(self, t: float) -> None:
        if self.parent is not None:
            self.parent.add_he_seconds(t)
        else:
            self.he_seconds += t

    def fork(self, tag: str | None = None) -> "Ctx":
        """Child ctx sharing the dealer and backend but with a SCRATCH log.
        Used by the split-program fast path's Protocol-2 host exchanges:
        the programs' shape-determined traffic (the exchanges' included) is
        replayed from the planning trace, so the live exchange must consume
        the dealer streams without logging its bytes twice. Its modelled HE
        time goes straight to this ctx, exchange by exchange, in the order
        the on-demand loop adds it, so a pooled fit's `he_seconds` is the
        on-demand fit's to the last bit. (The JAX package sums an
        iteration's exchanges on the child first, which can round the last
        bit differently.)"""
        return Ctx(dealer=self.dealer, log=CommLog(),
                   tag=self.tag if tag is None else tag,
                   backend=self.backend, parent=self)


def make_ctx(seed: int = 0, backend: RingBackend | str = "cuda",
             device="cuda", wire=None) -> Ctx:
    log = CommLog()
    log.wire = wire  # online sends ship over the attached WireSession
    return Ctx(dealer=TrustedDealer(seed=seed, log=log, device=device),
               log=log, backend=backend)


# ---------------------------------------------------------------------------
# Linear ops — local, no communication (paper SADD)
# ---------------------------------------------------------------------------

def add(a: AShare, b: AShare) -> AShare:
    return AShare(a.s0 + b.s0, a.s1 + b.s1)


def sub(a: AShare, b: AShare) -> AShare:
    return AShare(a.s0 - b.s0, a.s1 - b.s1)


def add_pub(a: AShare, c) -> AShare:
    """a + c with public ring tensor c (added to one share only)."""
    return AShare(a.s0 + c, a.s1)


def pub_sub(c, a: AShare) -> AShare:
    return AShare(c - a.s0, ring.neg(a.s1))


def mul_pub(a: AShare, c) -> AShare:
    """a * c with public *integer* ring tensor c (scale-preserving)."""
    return AShare(a.s0 * c, a.s1 * c)


def lshift(a: AShare, n: int) -> AShare:
    return AShare(ring.lshift(a.s0, n), ring.lshift(a.s1, n))


def neg(a: AShare) -> AShare:
    return AShare(ring.neg(a.s0), ring.neg(a.s1))


def matmul_pub_l(x_pub, a: AShare, backend: RingBackend | str = "cuda") -> AShare:
    """Public X @ shared A — local at the party that owns X."""
    mm = get_backend(backend, x_pub.device).ring_mm
    return AShare(mm(x_pub, a.s0), mm(x_pub, a.s1))


def matmul_pub_r(a: AShare, y_pub, backend: RingBackend | str = "cuda") -> AShare:
    mm = get_backend(backend, y_pub.device).ring_mm
    return AShare(mm(a.s0, y_pub), mm(a.s1, y_pub))


# ---------------------------------------------------------------------------
# Truncation (SecureML local truncation; error <= 2^-f w.h.p.)
# ---------------------------------------------------------------------------

def trunc(a: AShare, f: int = ring.F) -> AShare:
    """SecureML local truncation: P0 logically shifts its share; P1
    negates-shifts-negates. Off-by-2^-f LSB error w.h.p.; failure probability
    2^{f+1-l} per lane for |x| < 2^{l-f-1} (SecureML Thm. 1)."""
    if f == 0:
        return a
    s0 = ring.logical_rshift(a.s0, f)
    s1 = ring.neg(ring.logical_rshift(ring.neg(a.s1), f))
    return AShare(s0, s1)


# ---------------------------------------------------------------------------
# SMUL — Beaver multiplication (elementwise and matmul forms)
# ---------------------------------------------------------------------------

def _expand(a: AShare, shape) -> AShare:
    return AShare(a.s0.expand(shape), a.s1.expand(shape))


def smul(ctx: Ctx, a: AShare, b: AShare, *, trunc_f: int | None = None) -> AShare:
    """Elementwise product (broadcasting). One round: exchange E, F."""
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    t = ctx.dealer.mul_triple(shape, tag=ctx.tag)
    a, b = _expand(a, shape), _expand(b, shape)
    with ctx.spans.span("beaver.open", kind="mul", triples=1) \
            if ctx.spans else NOOP:
        e = (a.s0 - t.u.s0) + (a.s1 - t.u.s1)  # Rec(a - u)
        f = (b.s0 - t.v.s0) + (b.s1 - t.v.s1)  # Rec(b - v)
        # Both parties exchange their local (E,F) halves: 2 tensors each way.
        ctx.send(2 * 2 * ring.nbytes(shape), rounds=1)
    # ab = uv + u*f + e*v + e*f ;  z_i = z_t_i + u_i*f + e*v_i + [i==0]*e*f
    with ctx.spans.span("beaver.combine", kind="mul") if ctx.spans else NOOP:
        if FUSE_BEAVER:
            z0 = t.z.s0 + t.u.s0 * f + e * (t.v.s0 + f)
        else:
            z0 = t.z.s0 + t.u.s0 * f + e * t.v.s0 + e * f
        z1 = t.z.s1 + t.u.s1 * f + e * t.v.s1
    out = AShare(z0, z1)
    return trunc(out, trunc_f) if trunc_f else out


def smatmul(ctx: Ctx, a: AShare, b: AShare, *, trunc_f: int | None = None) -> AShare:
    """Secret-shared matrix product (paper's vectorized SMUL). One round."""
    (n, d), (d2, k) = a.shape, b.shape
    if d != d2:
        raise ValueError(f"smatmul inner dims disagree: {a.shape} @ {b.shape}")
    t = ctx.dealer.matmul_triple((n, d), (d, k), tag=ctx.tag)
    with ctx.spans.span("beaver.open", kind="matmul", triples=1) \
            if ctx.spans else NOOP:
        e = (a.s0 - t.u.s0) + (a.s1 - t.u.s1)
        f = (b.s0 - t.v.s0) + (b.s1 - t.v.s1)
        ctx.send(2 * (ring.nbytes((n, d)) + ring.nbytes((d, k))), rounds=1)
    mm = ctx.backend.ring_mm
    # AB = UV + U F + E V + E F
    with ctx.spans.span("beaver.combine", kind="matmul") \
            if ctx.spans else NOOP:
        if FUSE_BEAVER:  # P0: E@(V0 + F) fuses the public E@F term (flag)
            z0 = t.z.s0 + mm(t.u.s0, f) + mm(e, t.v.s0 + f)
        else:
            z0 = t.z.s0 + mm(t.u.s0, f) + mm(e, t.v.s0) + mm(e, f)
        z1 = t.z.s1 + mm(t.u.s1, f) + mm(e, t.v.s1)
    out = AShare(z0, z1)
    return trunc(out, trunc_f) if trunc_f else out


def square(ctx: Ctx, a: AShare, *, trunc_f: int | None = None) -> AShare:
    return smul(ctx, a, a, trunc_f=trunc_f)


# ---------------------------------------------------------------------------
# Boolean layer: bit-packed AND / XOR, Kogge-Stone adder, MSB, CMP
# ---------------------------------------------------------------------------

def bxor(x: BShare, y: BShare) -> BShare:
    return BShare(x.b0 ^ y.b0, x.b1 ^ y.b1)


def bxor_pub(x: BShare, c) -> BShare:
    return BShare(x.b0 ^ c, x.b1)


def band(ctx: Ctx, x: BShare, y: BShare) -> BShare:
    """Bit-packed AND via binary Beaver triple. One round, 64 gates/lane."""
    shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    t = ctx.dealer.bin_triple(shape, tag=ctx.tag)
    x = BShare(x.b0.expand(shape), x.b1.expand(shape))
    y = BShare(y.b0.expand(shape), y.b1.expand(shape))
    with ctx.spans.span("beaver.open", kind="bin", triples=1) \
            if ctx.spans else NOOP:
        e = (x.b0 ^ t.u.b0) ^ (x.b1 ^ t.u.b1)
        f = (y.b0 ^ t.v.b0) ^ (y.b1 ^ t.v.b1)
        ctx.send(2 * 2 * ring.nbytes(shape), rounds=1)
    # xy = (u^e)&(v^f) = uv ^ u&f ^ e&v ^ e&f
    with ctx.spans.span("beaver.combine", kind="bin") if ctx.spans else NOOP:
        z0 = t.z.b0 ^ (t.u.b0 & f) ^ (e & (t.v.b0 ^ f))
        z1 = t.z.b1 ^ (t.u.b1 & f) ^ (e & t.v.b1)
    return BShare(z0, z1)


def msb_carry(ctx: Ctx, a: AShare) -> BShare:
    """B-share of MSB(a.s0 + a.s1 mod 2^64) via Kogge-Stone carry network.

    Each party's arithmetic share is a *local plaintext* input to a boolean
    adder: X = (s0, 0), Y = (0, s1) as B-shares. log2(64)=6 AND rounds; the
    two ANDs per level (G and P updates) are batched into ONE round by
    stacking, so the whole MSB costs 7 rounds (1 initial + 6 levels).

    The per-level Beaver *recombination* is deferred: the exchange rounds
    only produce the public masked operands (E_l, F_l), and each party's
    share of the final carry word is ONE fused ``backend.ks_fused`` call over
    all 7 AND levels (the ks_carry_share kernel on the cuda backend).
    """
    shape = tuple(a.shape)
    s0, s1 = a.s0, a.s1
    # Same triple shapes / draw order / traffic as the sequential band()
    # formulation, so offline accounting is unchanged.
    t0 = ctx.dealer.bin_triple(shape, tag=ctx.tag)
    ctx.send(2 * 2 * ring.nbytes(shape), rounds=1)        # exchange E0, F0
    lvl_shape = (2,) + shape
    lvl = []
    for _ in KS_LEVELS:
        lvl.append(ctx.dealer.bin_triple(lvl_shape, tag=ctx.tag))
        ctx.send(2 * 2 * ring.nbytes(lvl_shape), rounds=1)
    # Public masked operands per level: E_l/F_l reconstruct to
    # plaintext(lhs/rhs) ^ plaintext(triple) — the public transcript of the
    # exchange rounds, not a security shortcut.
    with (ctx.spans.span("beaver.open", kind="ks",
                         triples=1 + len(KS_LEVELS))
          if ctx.spans else NOOP):
        e0 = s0 ^ (t0.u.b0 ^ t0.u.b1)
        f0 = s1 ^ (t0.v.b0 ^ t0.v.b1)
        g, p = s0 & s1, s0 ^ s1
        els, fls = [], []
        for li, s in enumerate(KS_LEVELS):
            t = lvl[li]
            els.append(torch.stack([p, p]) ^ (t.u.b0 ^ t.u.b1))
            gs, ps = ring.lshift(g, s), ring.lshift(p, s)
            fls.append(torch.stack([gs, ps]) ^ (t.v.b0 ^ t.v.b1))
            g = g ^ (p & gs)                   # g | (p & g<<s); disjoint: xor
            p = p & ps
        el, fl = torch.stack(els), torch.stack(fls)    # (6, 2, *shape)
    ul = [torch.stack([t.u.b0 for t in lvl]), torch.stack([t.u.b1 for t in lvl])]
    vl = [torch.stack([t.v.b0 for t in lvl]), torch.stack([t.v.b1 for t in lvl])]
    zl = [torch.stack([t.z.b0 for t in lvl]), torch.stack([t.z.b1 for t in lvl])]
    g0 = ctx.backend.ks_fused(s0, e0, f0, t0.u.b0, t0.v.b0, t0.z.b0,
                              el, fl, ul[0], vl[0], zl[0], party0=True)
    g1 = ctx.backend.ks_fused(s1, e0, f0, t0.u.b1, t0.v.b1, t0.z.b1,
                              el, fl, ul[1], vl[1], zl[1], party0=False)
    # sum bit 63 = p_orig[63] ^ carry_in[63];  carry_in[63] = G[62]
    rs = ring.logical_rshift
    return bxor(BShare(rs(s0, 63) & 1, rs(s1, 63) & 1),
                BShare(rs(g0, 62) & 1, rs(g1, 62) & 1))  # bit B-share


def b2a_bit(ctx: Ctx, b: BShare) -> AShare:
    """Single-bit B-share -> A-share: b = b0 + b1 - 2*b0*b1.

    Each party arithmetically shares its own boolean share (one message each,
    half a round: batched into 1 round), then one Beaver product.
    """
    shape = b.shape
    b0, b1 = b.b0 & 1, b.b1 & 1         # LSB view of the packed share
    r0 = ctx.dealer.rand(shape)
    r1 = ctx.dealer.rand(shape)
    a0 = AShare(b0 - r0, r0)            # P0 shares its bit b0
    a1 = AShare(r1, b1 - r1)            # P1 shares its bit b1
    ctx.send(2 * ring.nbytes(shape), rounds=1)
    prod = smul(ctx, a0, a1)            # scale-1 bits: no truncation
    return sub(add(a0, a1), lshift(prod, 1))


def cmp_lt(ctx: Ctx, a: AShare, b: AShare) -> AShare:
    """CMP: A-share of the indicator [a < b] (signed fixed-point compare)."""
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    diff = sub(_expand(a, shape), _expand(b, shape))
    return b2a_bit(ctx, msb_carry(ctx, diff))


def mux(ctx: Ctx, z: AShare, x: AShare, y: AShare) -> AShare:
    """MUX(z, x, y) = z*x + (1-z)*y = z*(x-y) + y (z is a 0/1 A-share)."""
    return add(smul(ctx, z, sub(x, y)), y)


# ---------------------------------------------------------------------------
# F^k_min — tournament argmin (paper Fig. 1), fully vectorized over n
# ---------------------------------------------------------------------------

def argmin_onehot(ctx: Ctx, d: AShare, *, return_min: bool = False):
    """Secret-shared one-hot argmin along the last axis of (n, k) distances.

    ceil(log2 k) rounds of [CMP + batched MUX], each round vectorized over
    all surviving pairs of all n samples at once — k-1 CMPs total, the
    binary-tree reduction of Fig. 1. Two launch-count optimizations on top:

    * The candidate one-hots start out PUBLIC (the identity's columns) and
      are carried as indexes until the first MUX, which is a local public-
      constant product (mul_pub, no triple, no traffic).
    * From the second level on, the value MUX and the one-hot MUX share the
      selector bit, so both Beaver recombinations are batched into ONE smul
      over the stacked (values | one-hots) tensor.

    return_min=True additionally returns the (n,) share of the winning
    value — free: no extra triples, traffic, or rounds.
    """
    n, k = d.shape
    dev = d.s0.device
    eye = torch.eye(k, dtype=ring.DTYPE, device=dev)
    vals = d
    ohs: AShare | None = None   # public eye carried implicitly until 1st MUX
    m, level = k, 0
    while m > 1:
        half, odd = m // 2, m % 2
        level += 1
        with ctx.spans.span("s2.level", level=level, pairs=n * half) \
                if ctx.spans else NOOP:
            vals, ohs = _tournament_level(ctx, vals, ohs, eye, half, odd)
        m = half + odd
    if ohs is None:    # k == 1: the argmin is trivially the only column
        oh = AShare(torch.ones((n, 1), dtype=ring.DTYPE, device=dev),
                    torch.zeros((n, 1), dtype=ring.DTYPE, device=dev))
        if return_min:
            return oh, AShare(d.s0[:, 0], d.s1[:, 0])
        return oh
    oh = AShare(ohs.s0[:, 0], ohs.s1[:, 0])    # (n, k)
    if return_min:
        return oh, AShare(vals.s0[:, 0], vals.s1[:, 0])
    return oh


def _tournament_level(ctx: Ctx, vals: AShare, ohs: AShare | None, eye,
                      half: int, odd: int) -> tuple:
    """One round of `argmin_onehot`: CMP + MUX over the `half` pairs of
    the surviving columns `vals` (n, m) and their one-hots `ohs` (n, m, k;
    None while they are still the public `eye`); an odd last column passes
    through. Returns the next round's (vals, ohs)."""
    n, k = vals.shape[0], eye.shape[0]
    dev = vals.s0.device
    l_v = AShare(vals.s0[:, 0:2 * half:2], vals.s1[:, 0:2 * half:2])
    r_v = AShare(vals.s0[:, 1:2 * half:2], vals.s1[:, 1:2 * half:2])
    b = cmp_lt(ctx, l_v, r_v)                       # [l < r]  (n, half)
    b_oh = AShare(b.s0[..., None], b.s1[..., None])  # broadcast over k
    if ohs is None:
        # level 1: one-hot operands are public eye columns — the MUX
        # b*(l_o - r_o) + r_o is a local scalar-by-public product.
        v_min = mux(ctx, b, l_v, r_v)
        l_o = eye[0:2 * half:2][None]                # (1, half, k) public
        r_o = eye[1:2 * half:2][None]
        o_min = add_pub(mul_pub(b_oh, l_o - r_o), r_o)
        if odd:
            tail_o = AShare(eye[None, -1:].expand(n, 1, k),
                            torch.zeros((n, 1, k), dtype=ring.DTYPE,
                                        device=dev))
    else:
        l_o = AShare(ohs.s0[:, 0:2 * half:2], ohs.s1[:, 0:2 * half:2])
        r_o = AShare(ohs.s0[:, 1:2 * half:2], ohs.s1[:, 1:2 * half:2])
        # batched MUX: stack (values | one-hots) differences along the
        # last axis and recombine with ONE Beaver product against the
        # shared selector — (n, half, 1+k) in a single round.
        diff = AShare(
            torch.cat([(l_v.s0 - r_v.s0)[..., None], l_o.s0 - r_o.s0], -1),
            torch.cat([(l_v.s1 - r_v.s1)[..., None], l_o.s1 - r_o.s1], -1))
        zz = smul(ctx, b_oh, diff)
        v_min = add(AShare(zz.s0[..., 0], zz.s1[..., 0]), r_v)
        o_min = add(AShare(zz.s0[..., 1:], zz.s1[..., 1:]), r_o)
        if odd:
            tail_o = AShare(ohs.s0[:, -1:], ohs.s1[:, -1:])
    if odd:
        v_min = AShare(torch.cat([v_min.s0, vals.s0[:, -1:]], 1),
                       torch.cat([v_min.s1, vals.s1[:, -1:]], 1))
        o_min = AShare(torch.cat([o_min.s0, tail_o.s0], 1),
                       torch.cat([o_min.s1, tail_o.s1], 1))
    return v_min, o_min


# ---------------------------------------------------------------------------
# Secure reciprocal (division -> SADD/SMUL, paper Sec 4.2 F_SCU)
# ---------------------------------------------------------------------------

def newton_iters(max_den: float) -> int:
    """`reciprocal`'s default Newton iteration count: m + 6, with m =
    ceil(log2 max_den)."""
    return max(0, int(np.ceil(np.log2(max_den)))) + 6


def reciprocal(ctx: Ctx, den: AShare, max_den: float, *, f: int = ring.F,
               iters: int | None = None, extra_bits: int = 0) -> AShare:
    """Newton-Raphson 1/den, den an *integer-valued* share (scale 1) in
    [1, max_den]; returns a share of 1/den at scale f + extra_bits.

    Normalize d' = den / 2^m in (0, 1] (m = ceil(log2 max_den); exact local
    shift when m <= f), iterate x <- x(2 - d'x) from x0 = 2 - d'
    (error e0 = (1-d')^2 < 1 converges for ALL d' in (0,1]), then unscale
    by >> (m - extra_bits). Error doubles bits per iter: ~m + log2(f) iters.

    extra_bits <= m keeps that many bits of the internal scale, trading
    headroom for 2^-(f+extra-m)-relative precision (the centroid update uses
    it: the following num*recip product cancels den).

    Each iteration is two truncated `smul`s (dx = d'x, then x(2 - dx)): the
    2 * iters mul triples are drawn and their openings exchanged in that
    order, one round each, and the loop itself is one `backend.newton_recip`
    call (the newton kernel on the cuda backend), under one `beaver.open`.
    """
    m = max(0, int(np.ceil(np.log2(max_den))))
    extra_bits = min(extra_bits, m)
    if iters is None:
        iters = newton_iters(max_den)
    if m <= f:
        dp = lshift(den, f - m)                   # exact local rescale
    else:
        dp = trunc(mul_pub(den, ring.to_i64(1 << (2 * f - m))), f)
    two = ring.encode(2.0, f, device=den.s0.device)
    x = pub_sub(two, dp)                          # x0 = 2 - d'
    shape = dp.shape
    triples = [ctx.dealer.mul_triple(shape, tag=ctx.tag)
               for _ in range(2 * iters)]
    with ctx.spans.span("beaver.open", kind="mul", triples=2 * iters) \
            if ctx.spans else NOOP:
        for _ in range(2 * iters):
            ctx.send(2 * 2 * ring.nbytes(shape), rounds=1)  # E, F each way
        x = ctx.backend.newton_recip(dp, x, triples, f=f, iters=iters)
    # x ~ 2^(f+m)/den; drop (m - extra_bits) to land at scale f + extra_bits
    return trunc(x, m - extra_bits) if m > extra_bits else x
