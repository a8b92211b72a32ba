"""The paper's online Lloyd iteration as two programs over pre-materialized
offline tensors.

The offline phase (Beaver triples, B2A randomness) enters as *function
inputs*: a RecordingDealer first runs each program body once on zeros to
enumerate every correlated-randomness tensor it consumes (their shapes are
data-independent — that is why the offline phase exists), then each call
consumes them from its argument list through a ListDealer.

Program split — one online iteration is TWO programs with an optional host
exchange between them:

  S1  distances + tournament argmin, ending at the assignment shares. The
      joint public-x-share products are Beaver matmuls inside the program
      (dense) or Protocol-2 results entering as share INPUTS (sparse); the
      distance-phase results depend only on the centroid shares, so the
      host computes them before S1.
  S2  (sparse only, not a program) the mid-iteration Protocol-2 exchange on
      the assignment shares S1 produced, run by the host between the two.
  S3  centroid update: C^T X, empty-cluster guard, Newton-Raphson division,
      MUX — taking the S2 results as inputs (sparse) or Beaver matmuls
      (dense).

Every partition x sparsity combo runs through the same two bodies,
parameterized by a `FitGeometry`; `fit_programs` records the pair's
schedules once per (geometry, backend, device) and caches it. Minibatch
Lloyd splits S3 in two: `fit_batch_programs` pairs S1 with the S3 head
(the running sums) per batch geometry, and `finalize_program` runs the S3
tail once an iteration on the accumulated sums. `predict_program` is the S1
body alone, scoring a new batch against a fitted model. PyTorch runs
the bodies eagerly: a program is a plain function that launches the ring
backend's kernels, with no ahead-of-time compilation.

Program spans (obs/trace.py): each program call resolves once whether it
records them (`_program_spans`) and carries the answer on its `Ctx`. The
fit pair opens `prog.s1` / `prog.s3`, the batch pair `prog.s1` /
`prog.s3p`, the finalize and predict programs `prog.finalize` /
`prog.predict`, each from entry to return; the bodies open `s1.distances`
(with `s1.mu_sq`), `s2.tournament`, `s3.sums` and `s3.finalize` (with
`s3.guard`, `s3.reciprocal`, `s3.update`); `s3.reciprocal` carries the
Newton loop's `impl` ("kernel" on the cuda backend, else "plain") and
`iters`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.backend import RingBackend, get_backend
from repro_torch.core.channel import CommLog
from repro_torch.core.sharing import AShare, BShare
from repro_torch.core.triples import BinTriple, MatmulTriple, MulTriple
from repro_torch.obs import trace as _trace
from repro_torch.obs.trace import NOOP


class RecordingDealer:
    """Enumerates the offline-phase tensors (kind, shape) in consumption
    order; hands back zeros on `device` so the body runs on."""

    def __init__(self, device="cpu"):
        self.requests: list[tuple[str, tuple]] = []
        self.device = torch.device(device)

    def _z(self, shape):
        return torch.zeros(shape, dtype=ring.DTYPE, device=self.device)

    def matmul_triple(self, sa, sb, *, tag="x"):
        self.requests.append(("matmul", (tuple(sa), tuple(sb))))
        n, d = sa
        _, k = sb
        return MatmulTriple(AShare(self._z((n, d)), self._z((n, d))),
                            AShare(self._z((d, k)), self._z((d, k))),
                            AShare(self._z((n, k)), self._z((n, k))))

    def mul_triple(self, shape, *, tag="x"):
        self.requests.append(("mul", tuple(shape)))
        z = self._z(shape)
        return MulTriple(AShare(z, z), AShare(z, z), AShare(z, z))

    def bin_triple(self, shape, *, tag="x"):
        self.requests.append(("bin", tuple(shape)))
        z = self._z(shape)
        return BinTriple(BShare(z, z), BShare(z, z), BShare(z, z))

    def rand(self, shape):
        self.requests.append(("rand", tuple(shape)))
        return self._z(shape)


class ListDealer:
    """Consumes pre-materialized offline tensors in order."""

    def __init__(self, flat: list, device="cpu"):
        self.flat = list(flat)
        self.i = 0
        self.device = torch.device(device)

    def _pop(self):
        v = self.flat[self.i]
        self.i += 1
        return v

    def matmul_triple(self, sa, sb, *, tag="x"):
        return MatmulTriple(AShare(self._pop(), self._pop()),
                            AShare(self._pop(), self._pop()),
                            AShare(self._pop(), self._pop()))

    def mul_triple(self, shape, *, tag="x"):
        return MulTriple(AShare(self._pop(), self._pop()),
                         AShare(self._pop(), self._pop()),
                         AShare(self._pop(), self._pop()))

    def bin_triple(self, shape, *, tag="x"):
        return BinTriple(BShare(self._pop(), self._pop()),
                         BShare(self._pop(), self._pop()),
                         BShare(self._pop(), self._pop()))

    def rand(self, shape):
        return self._pop()


# ---------------------------------------------------------------------------
# FitGeometry — static shape info of one partition x sparsity combo
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FitGeometry:
    """Shapes of one secure-fit combo. Vertical: X = [X_A | X_B]; horizontal:
    X = [X_A ; X_B]. Hashable — it keys the program cache."""

    partition: str     # "vertical" | "horizontal"
    sparse: bool
    shape_a: tuple     # party A's encoded-data shape
    shape_b: tuple
    k: int

    def __post_init__(self):
        if self.partition not in ("vertical", "horizontal"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.partition == "vertical" and self.shape_a[0] != self.shape_b[0]:
            raise ValueError("vertical partition requires equal sample counts")
        if self.partition == "horizontal" and self.shape_a[1] != self.shape_b[1]:
            raise ValueError("horizontal partition requires equal feature counts")

    @property
    def n(self) -> int:
        return self.shape_a[0] if self.partition == "vertical" \
            else self.shape_a[0] + self.shape_b[0]

    @property
    def d(self) -> int:
        return self.shape_a[1] + self.shape_b[1] \
            if self.partition == "vertical" else self.shape_a[1]

    @property
    def d_a(self) -> int:
        return self.shape_a[1]

    def he_shapes_s1(self) -> list:
        """Protocol-2 result shapes entering S1 (the X mu^T joint blocks)."""
        if not self.sparse:
            return []
        if self.partition == "vertical":
            return [(self.n, self.k), (self.n, self.k)]
        return [(self.shape_a[0], self.k), (self.shape_b[0], self.k)]

    def he_shapes_s3(self) -> list:
        """Protocol-2 result shapes entering S3 (the C^T X joint blocks)."""
        if not self.sparse:
            return []
        if self.partition == "vertical":
            return [(self.k, self.shape_a[1]), (self.k, self.shape_b[1])]
        return [(self.k, self.d), (self.k, self.d)]


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=ring.DTYPE, device=device)


def _zero_he(shapes, device):
    if not shapes:
        return None
    return tuple(AShare(_zeros(s, device), _zeros(s, device)) for s in shapes)


def _split_he(flat, shapes):
    """(he tuple | None, remaining flat) from a program's trailing args."""
    flat = list(flat)
    if not shapes:
        return None, flat
    n_he = 2 * len(shapes)
    he = tuple(AShare(flat[2 * i], flat[2 * i + 1])
               for i in range(len(shapes)))
    return he, flat[n_he:]


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """`t` all-reduced to Replicate where it is a DTensor holding partial
    sums (a product or a sum over the sharded sample axis); any other
    tensor as it is, as `models.lm._pin_batch` leaves a plain one.

    The reduction has to come before a partial sum meets a non-linear ring
    op (xor, and, a right shift), and before it meets a replicated word:
    DTensor would turn the replicated operand into a partial one by
    dividing it over the ranks, which leaves the ring for float32."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) \
            or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def _replicated_share(a: AShare) -> AShare:
    return AShare(_replicated(a.s0), _replicated(a.s1))


class _ReducedProducts(RingBackend):
    """`inner` with each dense ring product passed through `_replicated`: a
    product over the sharded sample axis comes back replicated. Every other
    op is the inner backend's own (the sparse products contract the
    features, never the samples)."""

    def __init__(self, inner: RingBackend):
        self.inner = inner
        self.name = inner.name

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def ring_mm(self, a, b):
        return _replicated(self.inner.ring_mm(a, b))

    def ring_spmm(self, *args, **kwargs):
        return self.inner.ring_spmm(*args, **kwargs)

    def ring_spmm_csr(self, *args, **kwargs):
        return self.inner.ring_spmm_csr(*args, **kwargs)

    def ks_fused(self, *args, **kwargs):
        return self.inner.ks_fused(*args, **kwargs)

    def newton_recip(self, *args, **kwargs):
        return self.inner.newton_recip(*args, **kwargs)


def _program_spans(t: torch.Tensor):
    """The program spans of one program call whose tensors are on `t`'s
    device (obs/trace.py:program_spans): None unless the tracer is
    configured for them or a torch.profiler session records."""
    return _trace.program_spans(t.is_cuda,
                                torch.autograd._profiler_enabled())


# ---------------------------------------------------------------------------
# Program bodies — ONE implementation per online stage, all combos
# ---------------------------------------------------------------------------

def _s1_body(ctx, geo: FitGeometry, xa, xb, mu: AShare, he,
             return_min: bool = False):
    """S1: vectorized distances D' = U - 2 X mu^T + tournament argmin, up to
    the Protocol-2 boundary. Returns the (n, k) assignment shares (plus,
    with return_min, the (n,) share of the winning D' value — the scoring
    path's distance to the assigned centroid, free from the tournament).

    he=None -> dense: the joint public-x-share blocks are Beaver matmuls
    consuming pool triples inside the program.
    he=(j1, j2) -> sparse: the blocks were computed on the host by Protocol
    2 from the centroid shares and enter as share inputs."""
    with ctx.spans.span("s1.distances") if ctx.spans else NOOP:
        dist = _s1_distances(ctx, geo, xa, xb, mu, he)
    with ctx.spans.span("s2.tournament") if ctx.spans else NOOP:
        return P.argmin_onehot(ctx, dist, return_min=return_min)


def _s1_distances(ctx, geo: FitGeometry, xa, xb, mu: AShare, he) -> AShare:
    """S1's (n, k) distance shares D' = |mu|^2 - 2 X mu^T at scale f. Its
    temporaries (ten (n, k) word tensors) die on return, before the
    tournament allocates."""
    mm = ctx.backend.ring_mm
    with ctx.spans.span("s1.mu_sq") if ctx.spans else NOOP:
        mu_sq = P.smul(ctx, mu, mu)
        u = AShare(mu_sq.s0.sum(1), mu_sq.s1.sum(1))
    mut = AShare(mu.s0.T, mu.s1.T)
    zl = torch.zeros_like
    if geo.partition == "vertical":
        da = geo.d_a
        loc_a = mm(xa, mut.s0[:da])
        loc_b = mm(xb, mut.s1[da:])
        if he is None:
            j1 = P.smatmul(ctx, AShare(xa, zl(xa)),
                           AShare(zl(mut.s1[:da]), mut.s1[:da]))
            j2 = P.smatmul(ctx, AShare(zl(xb), xb),
                           AShare(mut.s0[da:], zl(mut.s0[da:])))
        else:
            j1, j2 = he
        xmu = AShare(loc_a + j1.s0 + j2.s0, loc_b + j1.s1 + j2.s1)
    else:
        # horizontal: rows split; each party's rows hit BOTH mu shares
        loc_a = mm(xa, mut.s0)
        loc_b = mm(xb, mut.s1)
        if he is None:
            j_a = P.smatmul(ctx, AShare(xa, zl(xa)),
                            AShare(zl(mut.s1), mut.s1))
            j_b = P.smatmul(ctx, AShare(zl(xb), xb),
                            AShare(mut.s0, zl(mut.s0)))
        else:
            j_a, j_b = he
        xmu = AShare(torch.cat([loc_a + j_a.s0, j_b.s0], 0),
                     torch.cat([j_a.s1, loc_b + j_b.s1], 0))
    d2 = P.sub(AShare(u.s0[None, :], u.s1[None, :]), P.lshift(xmu, 1))
    return P.trunc(d2, ring.F)


def _s3_partial_body(ctx, geo: FitGeometry, xa, xb, c: AShare, he):
    """S3 head: the (k, d) numerator C^T X and (k,) denominator 1^T C —
    local and Beaver products, no division.

    he=None -> dense Beaver joint blocks; he=(ja, jb) -> the Protocol-2
    results of the mid-iteration host exchange on the assignment shares S1
    produced."""
    with ctx.spans.span("s3.sums") if ctx.spans else NOOP:
        return _s3_sums(ctx, geo, xa, xb, c, he)


def _s3_sums(ctx, geo: FitGeometry, xa, xb, c: AShare, he):
    mm = ctx.backend.ring_mm
    k = geo.k
    dev = c.s0.device
    ct = AShare(c.s0.T, c.s1.T)
    zl = torch.zeros_like
    if geo.partition == "vertical":
        da, db = geo.shape_a[1], geo.shape_b[1]
        za = AShare(mm(ct.s0, xa), _zeros((k, da), dev))
        zb = AShare(_zeros((k, db), dev), mm(ct.s1, xb))
        if he is None:
            ja = P.smatmul(ctx, AShare(zl(ct.s1), ct.s1), AShare(xa, zl(xa)))
            jb = P.smatmul(ctx, AShare(ct.s0, zl(ct.s0)), AShare(zl(xb), xb))
        else:
            ja, jb = he
        num = AShare(torch.cat([za.s0 + ja.s0, zb.s0 + jb.s0], 1),
                     torch.cat([za.s1 + ja.s1, zb.s1 + jb.s1], 1))
    else:
        na = geo.shape_a[0]
        ct_a = AShare(ct.s0[:, :na], ct.s1[:, :na])
        ct_b = AShare(ct.s0[:, na:], ct.s1[:, na:])
        loc_a = mm(ct_a.s0, xa)
        if he is None:
            ja = P.smatmul(ctx, AShare(zl(ct_a.s1), ct_a.s1),
                           AShare(xa, zl(xa)))
        else:
            ja = he[0]
        za = AShare(loc_a + ja.s0, ja.s1)
        loc_b = mm(ct_b.s1, xb)
        if he is None:
            jb = P.smatmul(ctx, AShare(ct_b.s0, zl(ct_b.s0)),
                           AShare(zl(xb), xb))
        else:
            jb = he[1]
        zb = AShare(jb.s0, loc_b + jb.s1)
        num = P.add(za, zb)
    den = AShare(c.s0.sum(0), c.s1.sum(0))
    return num, den


def _s3_final_body(ctx, k: int, n: int, mu: AShare, num: AShare,
                   den: AShare, f: int = ring.F):
    """S3 tail: mu' = num / den at scale f with the empty-cluster guard
    (CMP + MUX keep the old centroid) and a balanced-split division. `n` is
    the total sample count; it sizes the division constants.

    Balanced split: computing num * (2^f/den) naively either loses
    den*2^-f relative precision or pushes the pre-truncation product to
    ~2^(2f+m) bits, where SecureML local truncation fails often. So the
    2^m rescale is split: num is shifted down by s = m//2 and 2^s/den is
    kept in the reciprocal; the product (num/2^s)*(2^s/den) stays at
    ~2^(2f+4) bits.

    On DTensors sharded over the samples, num and den arrive as partial
    sums; they are all-reduced here, before the first op that is not
    linear over a sum (CMP, truncation)."""
    sp = ctx.spans
    with sp.span("s3.finalize") if sp else NOOP:
        num, den = _replicated_share(num), _replicated_share(den)
        dev = num.s0.device
        one = AShare(torch.ones((k,), dtype=ring.DTYPE, device=dev),
                     _zeros((k,), dev))
        with sp.span("s3.guard") if sp else NOOP:
            is_empty = P.cmp_lt(ctx, den, one)
            den_safe = P.mux(ctx, is_empty, one, den)
        m = int(np.ceil(np.log2(max(2, n))))
        s = m // 2
        iters = P.newton_iters(n)
        with sp.span("s3.reciprocal", impl=ctx.backend.newton_impl,
                     iters=iters) if sp else NOOP:
            r = P.reciprocal(ctx, den_safe, max_den=n, f=f, iters=iters,
                             extra_bits=s)
        with sp.span("s3.update") if sp else NOOP:
            num_s = P.trunc(num, s)
            mu_new = P.smul(ctx, num_s, AShare(r.s0[:, None], r.s1[:, None]),
                            trunc_f=f)
            guard = AShare(is_empty.s0[:, None], is_empty.s1[:, None])
            return P.mux(ctx, guard, mu, mu_new)


def _s3_body(ctx, geo: FitGeometry, xa, xb, mu: AShare, c: AShare, he):
    """S3: centroid update mu' = C^T X / 1^T C — the partial-sum head and
    the finalize tail back to back."""
    num, den = _s3_partial_body(ctx, geo, xa, xb, c, he)
    return _s3_final_body(ctx, geo.k, geo.n, mu, num, den)


def _iteration(xa_enc, xb_enc, mu: AShare, dealer, n: int, k: int,
               d_a: int, he_results: tuple | None = None,
               backend=None, return_assignment: bool = False):
    """One vertical-partition online Lloyd iteration on shares (Alg. 3) —
    S1 and S3 bodies composed back to back over ONE dealer. Kept as the
    single-launch legacy form behind `online_iteration_fn`; the production
    fast path uses the split `fit_programs` pair. `backend` None resolves
    by the dealer's device.

    The arguments may be DTensors laid out by `arg_shardings` (the dry
    run): every ring product that contracts the sharded sample axis (S3's
    C^T X blocks) is all-reduced as it comes out (`_ReducedProducts`), as
    the JAX package's partitioner places one all-reduce after each such
    dot, and S3's sums are all-reduced before its tail. Plain tensors pass
    as they are."""
    d_b = xb_enc.shape[1]
    geo = FitGeometry("vertical", he_results is not None,
                      (n, d_a), (n, d_b), k)
    ctx = P.Ctx(dealer=dealer, log=CommLog(),
                backend=_ReducedProducts(get_backend(backend,
                                                     dealer.device)))
    he1 = he3 = None
    if he_results is not None:
        he1, he3 = tuple(he_results[:2]), tuple(he_results[2:])
    c = _s1_body(ctx, geo, xa_enc, xb_enc, mu, he1)
    out = _s3_body(ctx, geo, xa_enc, xb_enc, mu, c, he3)
    return (out, c) if return_assignment else out


def _record_iteration(n: int, d: int, k: int, d_a: int, he_shapes,
                      return_assignment: bool = False) -> list:
    """The offline schedule of one `_iteration`, recorded by running it on
    meta zeros (the torch backend; nothing is allocated at any n)."""
    meta = torch.device("meta")
    dealer = RecordingDealer(meta)
    mu = AShare(_zeros((k, d), meta), _zeros((k, d), meta))
    _iteration(_zeros((n, d_a), meta), _zeros((n, d - d_a), meta), mu,
               dealer, n, k, d_a, he_results=_zero_he(he_shapes, meta),
               backend="torch", return_assignment=return_assignment)
    return list(dealer.requests)


def record_offline_shapes(n: int, d: int, k: int, d_a: int,
                          sparse: bool = False):
    """Run the iteration once on meta tensors to enumerate the offline
    tensor list. sparse=True enumerates the Protocol-2 variant (the four
    joint-product Beaver matmul triples are replaced by HE-result share
    inputs)."""
    he_shapes = [(n, k), (n, k), (k, d_a), (k, d - d_a)] if sparse else []
    return _record_iteration(n, d, k, d_a, he_shapes)


def _sds(shape) -> torch.Tensor:
    """The stand-in for a ShapeDtypeStruct: a ring-word tensor on the meta
    device (shape and dtype, no storage)."""
    return torch.empty(tuple(shape), dtype=ring.DTYPE, device="meta")


def _he_specs(shapes) -> list:
    out = []
    for s in shapes:
        out += [_sds(s), _sds(s)]
    return out


def offline_tensor_specs(requests, n: int) -> list:
    """Flat list of meta stand-ins mirroring ListDealer consumption."""
    flat = []
    for kind, shape in requests:
        if kind == "matmul":
            (nn, d), (d2, k) = shape
            flat += [_sds(s) for s in [(nn, d), (nn, d), (d, k), (d, k),
                                       (nn, k), (nn, k)]]
        elif kind in ("mul", "bin"):
            flat += [_sds(shape) for _ in range(6)]
        else:  # rand
            flat.append(_sds(shape))
    return flat


def materialize_offline(requests, dealer) -> list:
    """Flat tensor list the ListDealer consumes, in recorded order.
    `dealer` is any triple provider (TrustedDealer on demand, PooledDealer
    or StreamingPooledDealer for the planned offline phase)."""
    flat = []
    for kind, shape in requests:
        if kind == "matmul":
            t = dealer.matmul_triple(*shape)
        elif kind == "mul":
            t = dealer.mul_triple(shape)
        elif kind == "bin":
            t = dealer.bin_triple(shape)
            flat += [t.u.b0, t.u.b1, t.v.b0, t.v.b1, t.z.b0, t.z.b1]
            continue
        else:  # rand
            flat.append(dealer.rand(shape))
            continue
        flat += [t.u.s0, t.u.s1, t.v.s0, t.v.s1, t.z.s0, t.z.s1]
    return flat


def pooled_offline_arrays(requests, seed: int, iters: int = 1,
                          tag: str = "launch", device="cpu"):
    """Bulk-generate `iters` iterations' worth of a recorded schedule with
    ONE stacked draw, one batched ring op and one upload per shape-class,
    and return ([flat_per_iteration...], dealer). Each flat list feeds one
    program call via its ListDealer. Word for word equal to
    `materialize_offline` against a same-seeded TrustedDealer."""
    from repro_torch.core.triples import PlanRequest, PooledDealer, TriplePlan
    plan = TriplePlan([PlanRequest(kind, tuple(shape) if kind != "matmul"
                                   else shape, tag)
                       for kind, shape in requests]).repeat(iters)
    dealer = PooledDealer(plan, seed=seed, device=device)
    return [materialize_offline(requests, dealer) for _ in range(iters)], \
        dealer


# ---------------------------------------------------------------------------
# fit_programs — the per-iteration S1/S3 pair, all fit shapes
# ---------------------------------------------------------------------------

class FitPrograms(NamedTuple):
    """The S1/S3 pair plus the offline schedule each call consumes. Per
    online iteration:

        he1 = host Protocol-2 on the centroid shares        (sparse only)
        c   = s1(xa, xb, mu0, mu1, *he1, *flat_s1)          program 1
        he3 = host Protocol-2 on the assignment shares      (sparse only)
        mu' = s3(xa, xb, mu0, mu1, c0, c1, *he3, *flat_s3)  program 2

    where flat_s1/flat_s3 = materialize_offline(s{1,3}_requests, pool)."""

    geo: FitGeometry
    s1: Any
    s3: Any
    s1_requests: list
    s3_requests: list


_PROGRAM_CACHE: dict[tuple, FitPrograms] = {}


def fit_programs(partition: str, sparse: bool, shape_a, shape_b, k: int,
                 backend="cuda", device="cuda") -> FitPrograms:
    """Build (or fetch from the cross-fit cache) the S1/S3 pair for one fit
    combo. Each body runs once on zeros on `device` with a RecordingDealer
    to record its schedule (on a GPU this launches its kernels at their
    online shapes); the programs then run the same bodies over a
    ListDealer. Hardcodes f = ring.F; the schedules consume the same
    per-class dealer streams as the eager loop, so pooled serving is word
    for word the on-demand fit."""
    device = torch.device(device)
    ring_backend = get_backend(backend, device)
    geo = FitGeometry(partition, bool(sparse),
                      tuple(int(s) for s in shape_a),
                      tuple(int(s) for s in shape_b), int(k))
    key = (geo, ring_backend.name, str(device))
    hit = _PROGRAM_CACHE.get(key)
    if hit is not None:
        return hit

    n, d = geo.n, geo.d
    xa, xb = _zeros(geo.shape_a, device), _zeros(geo.shape_b, device)
    mu = AShare(_zeros((k, d), device), _zeros((k, d), device))

    def ctx_over(dealer, spans=None):
        return P.Ctx(dealer=dealer, log=CommLog(), backend=ring_backend,
                     spans=spans)

    rec1 = RecordingDealer(device)
    _s1_body(ctx_over(rec1), geo, xa, xb, mu,
             _zero_he(geo.he_shapes_s1(), device))
    rec3 = RecordingDealer(device)
    c = AShare(_zeros((n, k), device), _zeros((n, k), device))
    _s3_body(ctx_over(rec3), geo, xa, xb, mu, c,
             _zero_he(geo.he_shapes_s3(), device))

    def s1(xa, xb, mu0, mu1, *rest):
        sp = _program_spans(mu0)
        with sp.span("prog.s1") if sp else NOOP:
            he, flat = _split_he(rest, geo.he_shapes_s1())
            ctx = ctx_over(ListDealer(flat, mu0.device), sp)
            c = _s1_body(ctx, geo, xa, xb, AShare(mu0, mu1), he)
            return c.s0, c.s1

    def s3(xa, xb, mu0, mu1, c0, c1, *rest):
        sp = _program_spans(mu0)
        with sp.span("prog.s3") if sp else NOOP:
            he, flat = _split_he(rest, geo.he_shapes_s3())
            ctx = ctx_over(ListDealer(flat, mu0.device), sp)
            out = _s3_body(ctx, geo, xa, xb, AShare(mu0, mu1),
                           AShare(c0, c1), he)
            return out.s0, out.s1

    progs = FitPrograms(geo, s1, s3, list(rec1.requests), list(rec3.requests))
    _PROGRAM_CACHE[key] = progs
    return progs


# ---------------------------------------------------------------------------
# Minibatch programs — S1 + S3-partial per batch geometry, one finalize
# ---------------------------------------------------------------------------

class BatchPrograms(NamedTuple):
    """The (S1, S3-partial) pair for ONE minibatch geometry plus the offline
    schedule each call consumes. Per batch t of an iteration:

        he1 = host Protocol-2 on the centroid shares            (sparse)
        c   = s1(xa_t, xb_t, mu0, mu1, *he1, *flat1)            program 1
        he3 = host Protocol-2 on the assignment shares          (sparse)
        n0, n1, d0, d1 = s3p(xa_t, xb_t, c0, c1, *he3, *flat3)  program 2

    The (k, d) numerator and (k,) denominator partials accumulate across
    batches by share addition; the iteration closes with one
    `finalize_program` call. One cached pair serves every batch of its
    geometry — a fit needs at most a handful of entries (full batch shape
    and remainder)."""

    geo: FitGeometry
    s1: Any
    s3p: Any
    s1_requests: list
    s3p_requests: list


_BATCH_PROGRAM_CACHE: dict[tuple, BatchPrograms] = {}


def fit_batch_programs(partition: str, sparse: bool, shape_a, shape_b,
                       k: int, backend="cuda",
                       device="cuda") -> BatchPrograms:
    """Build (or fetch from the cross-fit cache) the S1/S3-partial pair for
    one BATCH geometry, recorded as `fit_programs` records its pair. The S1
    body is the one `fit_programs` runs — a batch is a fit geometry with
    the batch rows in place of the training rows; S3-partial stops at the
    running sums."""
    device = torch.device(device)
    ring_backend = get_backend(backend, device)
    geo = FitGeometry(partition, bool(sparse),
                      tuple(int(s) for s in shape_a),
                      tuple(int(s) for s in shape_b), int(k))
    key = (geo, ring_backend.name, str(device))
    hit = _BATCH_PROGRAM_CACHE.get(key)
    if hit is not None:
        return hit

    n, d = geo.n, geo.d
    xa, xb = _zeros(geo.shape_a, device), _zeros(geo.shape_b, device)

    def ctx_over(dealer, spans=None):
        return P.Ctx(dealer=dealer, log=CommLog(), backend=ring_backend,
                     spans=spans)

    rec1 = RecordingDealer(device)
    _s1_body(ctx_over(rec1), geo, xa, xb,
             AShare(_zeros((k, d), device), _zeros((k, d), device)),
             _zero_he(geo.he_shapes_s1(), device))
    rec3 = RecordingDealer(device)
    _s3_partial_body(ctx_over(rec3), geo, xa, xb,
                     AShare(_zeros((n, k), device), _zeros((n, k), device)),
                     _zero_he(geo.he_shapes_s3(), device))

    def s1(xa, xb, mu0, mu1, *rest):
        sp = _program_spans(mu0)
        with sp.span("prog.s1") if sp else NOOP:
            he, flat = _split_he(rest, geo.he_shapes_s1())
            ctx = ctx_over(ListDealer(flat, mu0.device), sp)
            c = _s1_body(ctx, geo, xa, xb, AShare(mu0, mu1), he)
            return c.s0, c.s1

    def s3p(xa, xb, c0, c1, *rest):
        sp = _program_spans(c0)
        with sp.span("prog.s3p") if sp else NOOP:
            he, flat = _split_he(rest, geo.he_shapes_s3())
            ctx = ctx_over(ListDealer(flat, c0.device), sp)
            num, den = _s3_partial_body(ctx, geo, xa, xb, AShare(c0, c1), he)
            return num.s0, num.s1, den.s0, den.s1

    progs = BatchPrograms(geo, s1, s3p, list(rec1.requests),
                          list(rec3.requests))
    _BATCH_PROGRAM_CACHE[key] = progs
    return progs


class FinalizeProgram(NamedTuple):
    """The per-iteration S3 tail: one call on the accumulated sums.

        mu'0, mu'1 = fn(mu0, mu1, num0, num1, den0, den1, *flat)

    where flat = materialize_offline(requests, dealer)."""

    fn: Any
    requests: list


_FINALIZE_CACHE: dict[tuple, FinalizeProgram] = {}


def finalize_program(k: int, d: int, n: int, backend="cuda",
                     device="cuda") -> FinalizeProgram:
    """Build (or fetch) the minibatch finalize program. `n` is the TOTAL
    sample count (division constants), so every batch layout of one fit
    shares a single entry — and the batch_size >= n fit runs the exact
    algebra of the full-batch S3 program's tail."""
    device = torch.device(device)
    ring_backend = get_backend(backend, device)
    key = (int(k), int(d), int(n), ring_backend.name, str(device))
    hit = _FINALIZE_CACHE.get(key)
    if hit is not None:
        return hit

    def ctx_over(dealer, spans=None):
        return P.Ctx(dealer=dealer, log=CommLog(), backend=ring_backend,
                     spans=spans)

    rec = RecordingDealer(device)
    _s3_final_body(ctx_over(rec), k, n,
                   *(AShare(_zeros(s, device), _zeros(s, device))
                     for s in ((k, d), (k, d), (k,))))

    def fn(mu0, mu1, num0, num1, den0, den1, *flat):
        sp = _program_spans(mu0)
        with sp.span("prog.finalize") if sp else NOOP:
            ctx = ctx_over(ListDealer(list(flat), mu0.device), sp)
            out = _s3_final_body(ctx, k, n, AShare(mu0, mu1),
                                 AShare(num0, num1), AShare(den0, den1))
            return out.s0, out.s1

    prog = FinalizeProgram(fn, list(rec.requests))
    _FINALIZE_CACHE[key] = prog
    return prog


# ---------------------------------------------------------------------------
# predict_program — the S1 body alone, scoring new batches against a model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PredictGeometry:
    """Shapes of one secure-scoring batch against a fitted (k, d) model.
    Vertical: both parties hold the same batch rows' column slices,
    shape_a = (m, d_a), shape_b = (m, d_b). Horizontal: each party owns
    whole arrival rows, shape_a = (m_a, d), shape_b = (m_b, d); outputs are
    ordered [A rows; B rows]. Hashable — it keys the program cache."""

    partition: str
    sparse: bool
    shape_a: tuple
    shape_b: tuple
    k: int
    with_scores: bool = False

    def fit_geometry(self) -> FitGeometry:
        """A predict batch is a fit geometry with the batch rows in place
        of the training rows (validation included)."""
        return FitGeometry(self.partition, self.sparse,
                           self.shape_a, self.shape_b, self.k)


class PredictProgram(NamedTuple):
    """One batched scoring call plus the offline schedule it consumes. Per
    request:

        he1  = host Protocol-2 on the centroid shares          (sparse only)
        outs = fn(xa, xb, mu0, mu1, *he1, *flat)
        (c0, c1) = outs[:2]; (v0, v1) = outs[2:]               (with_scores)

    where flat = materialize_offline(requests, dealer). The min-distance
    shares v are D'(x, mu_c) = ||mu_c||^2 - 2 x.mu_c at scale f; the caller
    adds the party-local ||x||^2 shares to get the squared distance
    (core/kmeans.SecureKMeans.score)."""

    geo: PredictGeometry
    fn: Any
    requests: list


_PREDICT_PROGRAM_CACHE: dict[tuple, PredictProgram] = {}


def predict_program(partition: str, sparse: bool, shape_a, shape_b, k: int,
                    with_scores: bool = False, backend="cuda",
                    device="cuda") -> PredictProgram:
    """Build (or fetch from the cross-request cache) the scoring program of
    one batch geometry — the S1 body of `fit_programs`, its schedule
    recorded by running the body once on zeros on `device`. Dense combos
    consume pool triples inside the program; sparse combos take the
    Protocol-2 joint products (computable from the centroid shares alone,
    so the host runs the exchange before the call) as share inputs.
    Hardcodes f = ring.F."""
    device = torch.device(device)
    ring_backend = get_backend(backend, device)
    geo = PredictGeometry(partition, bool(sparse),
                          tuple(int(s) for s in shape_a),
                          tuple(int(s) for s in shape_b), int(k),
                          bool(with_scores))
    key = (geo, ring_backend.name, str(device))
    hit = _PREDICT_PROGRAM_CACHE.get(key)
    if hit is not None:
        return hit

    fgeo = geo.fit_geometry()

    def ctx_over(dealer, spans=None):
        return P.Ctx(dealer=dealer, log=CommLog(), backend=ring_backend,
                     spans=spans)

    rec = RecordingDealer(device)
    _s1_body(ctx_over(rec), fgeo, _zeros(geo.shape_a, device),
             _zeros(geo.shape_b, device),
             AShare(_zeros((k, fgeo.d), device), _zeros((k, fgeo.d), device)),
             _zero_he(fgeo.he_shapes_s1(), device), return_min=with_scores)

    def fn(xa, xb, mu0, mu1, *rest):
        sp = _program_spans(mu0)
        with sp.span("prog.predict") if sp else NOOP:
            he, flat = _split_he(rest, fgeo.he_shapes_s1())
            ctx = ctx_over(ListDealer(flat, mu0.device), sp)
            out = _s1_body(ctx, fgeo, xa, xb, AShare(mu0, mu1), he,
                           return_min=with_scores)
            if with_scores:
                c, v = out
                return c.s0, c.s1, v.s0, v.s1
            return out.s0, out.s1

    prog = PredictProgram(geo, fn, list(rec.requests))
    _PREDICT_PROGRAM_CACHE[key] = prog
    return prog


def clear_program_cache() -> None:
    """Empty the full-batch, the batch, the finalize and the predict
    program caches."""
    _PROGRAM_CACHE.clear()
    _PREDICT_PROGRAM_CACHE.clear()
    _BATCH_PROGRAM_CACHE.clear()
    _FINALIZE_CACHE.clear()


# ---------------------------------------------------------------------------
# The single-launch legacy forms (the dry run, the perf hillclimb, the cell)
# ---------------------------------------------------------------------------

def _iteration_fn(n: int, d: int, k: int, d_a: int, sparse: bool,
                  backend, device, return_assignment: bool):
    """(fn, arg stand-ins, schedule) of the single-launch iteration:
    fn(xa, xb, mu0, mu1, *he, *flat) -> (mu0', mu1'), and then (c0, c1)
    with `return_assignment`."""
    ring_backend = get_backend(backend, device)
    he_shapes = [(n, k), (n, k), (k, d_a), (k, d - d_a)] if sparse else []
    requests = _record_iteration(n, d, k, d_a, he_shapes,
                                 return_assignment=return_assignment)

    def fn(xa_enc, xb_enc, mu_s0, mu_s1, *flat):
        he, rest = _split_he(flat, he_shapes)
        out = _iteration(xa_enc, xb_enc, AShare(mu_s0, mu_s1),
                         ListDealer(rest, mu_s0.device), n, k, d_a,
                         he_results=he, backend=ring_backend,
                         return_assignment=return_assignment)
        if return_assignment:
            mu, c = out
            return mu.s0, mu.s1, c.s0, c.s1
        return out.s0, out.s1

    args = (_sds((n, d_a)), _sds((n, d - d_a)), _sds((k, d)), _sds((k, d))) \
        + tuple(_he_specs(he_shapes)) \
        + tuple(offline_tensor_specs(requests, n))
    return fn, args, requests


def online_iteration_fn(n: int, d: int, k: int, d_a: int,
                        sparse: bool = False, backend="auto",
                        device="cuda"):
    """(fn, arg stand-ins) with fn(xa, xb, mu0, mu1, *he, *flat) -> the new
    centroid shares (mu0', mu1'). sparse=True adds the 8 Protocol-2 result
    shares as inputs and drops the joint Beaver matmuls (paper Sec 4.3).
    `backend` picks the ring-compute implementation; 'auto' resolves by
    `device`, where the arguments live. The stand-ins are meta tensors
    (the schedule is recorded on meta, so nothing is allocated).

    Legacy single-launch form (S1+S3 fused, no mid-iteration callback) kept
    for the mesh/perf harnesses; `fit_programs` is the production split."""
    fn, args, _ = _iteration_fn(n, d, k, d_a, sparse, backend, device,
                                return_assignment=False)
    return fn, args


def fit_iteration_fn(n: int, d: int, k: int, d_a: int, backend="auto",
                     device="cuda"):
    """`online_iteration_fn` variant that also exposes the assignment
    shares: fn(xa, xb, mu0, mu1, *flat) -> (mu0', mu1', c0, c1), plus the
    offline schedule one call consumes. Superseded by `fit_programs` (the
    S1/S3 split) on SecureKMeans' pooled fast path; kept for callers that
    want the fused single-launch dense-vertical iteration."""
    return _iteration_fn(n, d, k, d_a, False, backend, device,
                         return_assignment=True)


def arg_shardings(mesh, args, n: int) -> tuple:
    """Shard the sample axis over ('pod','data') WHEREVER it appears —
    including dim-1 of the transposed (k, n) Beaver triples — and replicate
    the rest: one `models.sharding.Sharding` (its spec and its DTensor
    placements) per argument."""
    from repro_torch.models.sharding import Sharding, Spec
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    out = []
    for a in args:
        spec = [None] * len(a.shape)
        for dim, sz in enumerate(a.shape):
            if sz == n:
                spec[dim] = axes
                break
        out.append(Sharding(mesh, Spec(*spec)))
    return tuple(out)
