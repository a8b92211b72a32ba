"""Privacy-preserving (sparse) K-means — paper Algorithm 3, both partitions.

Secure Lloyd iteration (Sec 4.2):
  S1 F_ESD  — vectorized distances  D' = U - 2 X mu^T  (Eq. 3-5); the
              ||X_i||^2 term is dropped (constant per row under argmin) and
              U is computed once per iteration with ONE batched SMUL.
  S2 F_min  — tournament argmin over k (Fig. 1), vectorized over all n.
  S3 F_SCU  — mu = C^T X / 1^T C with Newton-Raphson secure division and a
              secure empty-cluster guard (CMP + MUX keep the old centroid).
  F_CSC     — secure convergence check, only the stop bit is revealed.

Vertical:   X = [X_A | X_B]   (Eq. 4, Alg. 3)      n x (dA + dB)
Horizontal: X = [X_A ; X_B]   (Eq. 5)              (nA + nB) x d

`sparse=True` swaps every joint public-x-share product for Protocol 2
(HE + HE2SS, core/sparse.py) — X never leaves its owner, traffic is
independent of n*d, and the step-2 product runs on the ring backend's
blocked-ELL spmm.

`vectorized=False` keeps results identical but *accounts* communication the
way the pre-vectorization protocol would ship it (one interaction per scalar
product / per comparison, Sec 4.2) — the Fig. 3 baseline.

`offline="pooled"` / `"streamed"` split the fit into the paper's offline
and online phases: one iteration is traced on zeros to plan the
data-independent triple schedule (cached across same-shape fits), the
pooled or streaming dealer generates it ahead of the loop, and each
iteration runs as two programs, S1 and S3 (launch/kmeans_step.py), with the
sparse combos' Protocol-2 exchanges on the host before S1 and between the
two. A custom `f` or `vectorized=False` runs the eager loop against the
pooled dealer instead.

The options that belong to later slices raise NotImplementedError naming
their ROADMAP.md item. Entry points run on the GPU unless the config asks
for the CPU (`backend="torch", device="cpu"`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.channel import CommLog, NetModel
from repro_torch.core.he import OU_COST_S, SimulatedPHE
from repro_torch.core.sharing import AShare, rec, rec_real, share
from repro_torch.core.sparse import CSRMatrix, secure_sparse_matmul
from repro_torch.core.triples import (PlanningDealer, PooledDealer,
                                      StreamingPooledDealer, TriplePlan,
                                      TrustedDealer)
from repro_torch.launch import kmeans_step as KS

_LATER = {
    "batch_size": "ROADMAP.md Queue 1 item 8 (minibatch and pipelining)",
    "dealer": "ROADMAP.md Queue 1 item 9 (predict, bank and serving)",
    "wire": "ROADMAP.md Queue 1 item 10 (durability, wire and runtime)",
    "checkpoint": "ROADMAP.md Queue 1 item 10 (durability, wire and runtime)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_LATER[key]}")


@dataclasses.dataclass
class KMeansConfig:
    k: int
    iters: int = 10
    partition: Literal["vertical", "horizontal"] = "vertical"
    sparse: bool = False
    vectorized: bool = True
    f: int = ring.F
    seed: int = 0
    init: Literal["random_data", "random_uniform"] = "random_data"
    tol: float | None = None        # if set, F_CSC early-stops
    he_backend: object | None = None  # default: SimulatedPHE()
    backend: str = "cuda"           # ring-compute backend (core/backend.py);
    # "auto" / None resolve by `device`
    device: str = "cuda"            # where shares and triples live
    # "pooled": plan the data-independent triple schedule up front and run
    # the online loop against a PooledDealer (the paper's offline/online
    # split). "streamed": same split, each iteration's tranche generated on
    # a background worker while the previous one runs — peak pool residency
    # O(1 iteration). "on_demand": synthesize triples inside the loop.
    offline: Literal["on_demand", "pooled", "streamed"] = "on_demand"
    batch_size: int | None = None
    pipeline: bool = True           # minibatch pipelining (item 8); inert

    def __post_init__(self):
        if self.iters < 1:
            raise ValueError(
                f"KMeansConfig.iters must be >= 1, got {self.iters}: the "
                "secure Lloyd loop must run at least once to produce an "
                "assignment")
        if self.offline not in ("on_demand", "pooled", "streamed"):
            raise ValueError(
                f"KMeansConfig.offline must be 'on_demand', 'pooled' or "
                f"'streamed', got {self.offline!r}")
        if self.init not in ("random_data", "random_uniform"):
            raise ValueError(
                f"KMeansConfig.init must be 'random_data' or "
                f"'random_uniform', got {self.init!r}")
        if self.batch_size is not None:
            raise _not_ported("batch_size", "batch_size")
        if self.partition not in ("vertical", "horizontal"):
            raise ValueError(
                f"KMeansConfig.partition must be 'vertical' or "
                f"'horizontal', got {self.partition!r}")
        if self.backend == "cuda" and torch.device(self.device).type != "cuda":
            raise ValueError(
                f"backend='cuda' runs on device='cuda', got "
                f"device={self.device!r}; use backend='torch' for the CPU")


@dataclasses.dataclass
class KMeansResult:
    centroids: AShare                 # (k, d) shares, scale f
    assignment: AShare                # (n, k) one-hot shares, scale 1
    iters_run: int
    log: CommLog
    dealer: "TrustedDealer | PooledDealer | StreamingPooledDealer | None"
    online_seconds: float             # loop wall minus in-loop dealer work
    offline_dealer_seconds: float     # triple synthesis + upload (+ plan)
    offline_modelled_ot_seconds: float
    he_seconds: float = 0.0           # modelled HE time (Protocol 2 only)
    loop_seconds: float = 0.0         # raw Lloyd-loop wall-clock: with the
    # on-demand dealer this INCLUDES triple synthesis; pooled, it equals
    # online_seconds
    offline_plan_seconds: float = 0.0  # dry-run trace + program recording
    # (pooled / streamed only; a plan-cache hit skips the trace)

    # -- convenience reconstructions (the protocol's single final Rec) -----
    def centroids_plain(self, f: int = ring.F) -> np.ndarray:
        return rec_real(self.centroids, f).cpu().numpy()

    def labels_plain(self) -> np.ndarray:
        return rec(self.assignment).cpu().numpy().argmax(1)

    def wan_lan_estimate(self, net: NetModel) -> dict:
        online = self.log.time_estimate(net, "online") + self.online_seconds \
            + self.he_seconds
        offline = self.log.time_estimate(net, "offline") \
            + self.offline_modelled_ot_seconds
        return {"online_s": online, "offline_s": offline,
                "total_s": online + offline}


# (shapes, cfg-key) -> (one-iteration TriplePlan, one-iteration CommLog).
# The schedule is data-independent, so identical-shape fits share it; see
# SecureKMeans._plan_offline_iter.
_PLAN_CACHE: dict[tuple, tuple] = {}


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


class SecureKMeans:
    """Two-party secure K-means. Party data stays plaintext at its owner;
    centroids/assignments are secret-shared end to end."""

    def __init__(self, cfg: KMeansConfig):
        self.cfg = cfg
        self.he = cfg.he_backend or SimulatedPHE()

    # ------------------------------------------------------------------ #
    def fit(self, x_a: np.ndarray, x_b: np.ndarray, *, dealer=None,
            wire=None, checkpoint=None) -> KMeansResult:
        """Jointly cluster the two parties' data."""
        for key, val in (("dealer", dealer), ("wire", wire),
                         ("checkpoint", checkpoint)):
            if val is not None:
                raise _not_ported(f"fit({key}=...)", key)
        cfg = self.cfg
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"KMeansConfig(device={cfg.device!r}) needs a CUDA GPU and "
                "none is available; pass backend='torch', device='cpu' to "
                "run on the CPU")
        rng = np.random.default_rng(cfg.seed)
        ctx = P.make_ctx(cfg.seed, backend=cfg.backend, device=device)
        x_a = np.asarray(x_a, np.float64)
        x_b = np.asarray(x_b, np.float64)
        if cfg.partition == "vertical":
            if x_a.shape[0] != x_b.shape[0]:
                raise ValueError(f"vertical partition needs equal row counts, "
                                 f"got {x_a.shape[0]} and {x_b.shape[0]}")
            n = x_a.shape[0]
        else:
            if x_a.shape[1] != x_b.shape[1]:
                raise ValueError(f"horizontal partition needs equal widths, "
                                 f"got {x_a.shape[1]} and {x_b.shape[1]}")
            n = x_a.shape[0] + x_b.shape[0]
        # each party's encoded plaintext, uploaded once; the sparse path
        # also keeps it as a host CSR matrix for Protocol 2
        enc_a_np, enc_b_np = _encode_np(x_a, cfg.f), _encode_np(x_b, cfg.f)
        enc_a = ring.from_u64_numpy(enc_a_np, device)
        enc_b = ring.from_u64_numpy(enc_b_np, device)
        csr_a = CSRMatrix.from_dense(enc_a_np) if cfg.sparse else None
        csr_b = CSRMatrix.from_dense(enc_b_np) if cfg.sparse else None
        mu = self._init_centroids(ctx, rng, x_a, x_b)

        # pooled / streamed offline phase: trace the schedule (cached across
        # same-shape fits), bulk-generate the pools, upload them, and record
        # the S1/S3 program pair that consumes them. All of it is data-
        # independent; the loop then runs with no dealer work, the sparse
        # combos' Protocol-2 exchanges on the host around S1.
        plan_s = 0.0
        fast = None
        if cfg.offline in ("pooled", "streamed"):
            t0 = time.perf_counter()
            iter_plan, iter_comm = self._plan_offline_iter(x_a.shape,
                                                           x_b.shape)
            # the programs hardcode f = ring.F, and the unvectorized
            # accounting is the eager loop's: those configs run the eager
            # loop against the pooled dealer
            if cfg.vectorized and cfg.f == ring.F:
                progs = KS.fit_programs(cfg.partition, cfg.sparse,
                                        enc_a.shape, enc_b.shape, cfg.k,
                                        backend=ctx.backend, device=device)
                # the exchange on the assignment shares consumes the
                # pre-transposed CSRs
                csr_at = csr_a.transpose() if cfg.sparse else None
                csr_bt = csr_b.transpose() if cfg.sparse else None
                fast = (progs, iter_comm, csr_at, csr_bt)
            plan_s = time.perf_counter() - t0
            if cfg.offline == "pooled":
                ctx.dealer = PooledDealer(iter_plan.repeat(cfg.iters),
                                          seed=cfg.seed, log=ctx.log,
                                          device=device)
            else:
                # group="auto": tiny k*d tranches share one worker wakeup
                ctx.dealer = StreamingPooledDealer(
                    iter_plan, cfg.iters, seed=cfg.seed, log=ctx.log,
                    group="auto", device=device)

        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t_start = time.perf_counter()
        dealer_s_pre = ctx.dealer.dealer_seconds
        it = 0
        try:
            for it in range(1, cfg.iters + 1):
                mu_old = mu
                if fast is not None:
                    mu, c = self._fast_iteration(ctx, fast, enc_a, enc_b,
                                                 csr_a, csr_b, mu)
                else:
                    ctx.tag = "S1"
                    dist = self._distances(ctx, enc_a, enc_b, csr_a, csr_b,
                                           mu)
                    ctx.tag = "S2"
                    r_before = ctx.log.total_rounds("online")
                    c = P.argmin_onehot(ctx, dist)            # (n, k) scale 1
                    if not cfg.vectorized:
                        # pre-vectorization: each of the n samples runs its
                        # own tournament (n interaction chains per round)
                        dr = ctx.log.total_rounds("online") - r_before
                        _naive_extra_rounds(ctx, (n - 1) * dr + 1)
                    ctx.tag = "S3"
                    mu = self._update(ctx, enc_a, enc_b, csr_a, csr_b, c,
                                      mu_old, n)
                if cfg.tol is not None:
                    ctx.tag = "CSC"
                    if self._converged(ctx, mu_old, mu, cfg.tol):
                        break
            sync()
            wall = time.perf_counter() - t_start
        finally:
            if isinstance(ctx.dealer, StreamingPooledDealer):
                # an early stop, or an exception unwinding the loop, leaves
                # prefetched tranches and the worker thread alive
                ctx.dealer.close()
        dealer = ctx.dealer
        in_loop_dealer_s = dealer.dealer_seconds - dealer_s_pre
        self.result_ = KMeansResult(
            centroids=mu, assignment=c, iters_run=it, log=ctx.log,
            dealer=dealer,
            online_seconds=max(0.0, wall - in_loop_dealer_s),
            offline_dealer_seconds=dealer.dealer_seconds + plan_s,
            offline_modelled_ot_seconds=dealer.modelled_ot_seconds,
            he_seconds=ctx.he_seconds,
            loop_seconds=wall,
            offline_plan_seconds=plan_s,
        )
        return self.result_

    def _fast_iteration(self, ctx, fast, enc_a, enc_b, csr_a, csr_b,
                        mu: AShare) -> tuple:
        """One iteration as the S1 and S3 programs over the pool's tensors
        (ListDealer discipline). The sparse combos run Protocol 2 on the
        host on a forked ctx: exchange #1 needs only the centroid shares,
        exchange #2 the assignment shares S1 just produced; the results
        enter the programs as share inputs. Returns (mu', c)."""
        progs, iter_comm, csr_at, csr_bt = fast
        he1 = he3 = []
        hx = None
        if self.cfg.sparse:
            # scratch log: the iteration's shape-determined traffic (the
            # exchanges' included) is replayed from iter_comm below; the
            # modelled HE time flows into ctx
            hx = ctx.fork(tag="S1")
            he1 = self._s1_he_inputs(hx, enc_a, enc_b, csr_a, csr_b, mu)
        flat1 = KS.materialize_offline(progs.s1_requests, ctx.dealer)
        c0, c1 = progs.s1(enc_a, enc_b, mu.s0, mu.s1, *he1, *flat1)
        c = AShare(c0, c1)
        if self.cfg.sparse:
            hx.tag = "S3"
            he3 = self._s3_he_inputs(hx, csr_at, csr_bt, c)
        flat3 = KS.materialize_offline(progs.s3_requests, ctx.dealer)
        mu0, mu1 = progs.s3(enc_a, enc_b, mu.s0, mu.s1, c0, c1, *he3, *flat3)
        # the traced iteration's online tallies (sends inside the programs
        # go to a scratch log)
        ctx.log.merge(iter_comm, phase="online")
        return AShare(mu0, mu1), c

    # ------------------------------------------------------------------ #
    def plan_offline(self, shape_a, shape_b) -> TriplePlan:
        """The exact correlated-randomness schedule of `fit` for party-input
        shapes (shape_a, shape_b) — without seeing any data.

        One Lloyd iteration (+ the CSC check when `tol` is set) runs on
        zero-filled inputs on the config's device with a `PlanningDealer`;
        every triple shape is data-independent, so the full-fit schedule is
        that trace repeated `iters` times. A `tol` early stop only leaves
        pool surplus. The trace runs the real protocol ops, so on a GPU it
        also launches the kernels at the online shapes — offline warm-up.
        """
        return self._plan_offline_iter(shape_a, shape_b)[0] \
            .repeat(self.cfg.iters)

    def _plan_cache_key(self, shape_a, shape_b) -> tuple:
        cfg = self.cfg
        key = (tuple(shape_a), tuple(shape_b), cfg.k, cfg.partition,
               cfg.sparse, cfg.vectorized, cfg.f, cfg.tol is not None)
        if cfg.sparse:
            # the HE backend's sizes shape Protocol 2's logged traffic
            he = self.he
            key += (getattr(he, "name", type(he).__name__),
                    getattr(he, "ct_bytes", 0), getattr(he, "plain_bits", 0))
        return key

    def _plan_offline_iter(self, shape_a, shape_b):
        """(iter_plan, iter_comm): ONE iteration's TriplePlan plus a CommLog
        of its online traffic (S1/S2/S3, without CSC) — the tallies the
        program fast path replays per iteration. Cached across fits by
        (shapes, config key), so a second same-shape fit skips the trace.
        Returns copies; cached state is never handed out mutable."""
        key = self._plan_cache_key(shape_a, shape_b)
        hit = _PLAN_CACHE.get(key)
        if hit is None:
            hit = _PLAN_CACHE[key] = self._trace_iteration(shape_a, shape_b)
        plan, comm = hit
        return TriplePlan(list(plan.requests)), comm.copy()

    def _trace_iteration(self, shape_a, shape_b):
        """Dry-run trace of one Lloyd iteration (+CSC when tol is set) with
        a PlanningDealer on zero-filled inputs on the config's device."""
        cfg = self.cfg
        device = torch.device(cfg.device)
        ctx = P.Ctx(dealer=PlanningDealer(device), log=CommLog(),
                    backend=cfg.backend)
        enc_a = torch.zeros(tuple(shape_a), dtype=ring.DTYPE, device=device)
        enc_b = torch.zeros(tuple(shape_b), dtype=ring.DTYPE, device=device)
        n = enc_a.shape[0] if cfg.partition == "vertical" \
            else enc_a.shape[0] + enc_b.shape[0]
        d = enc_a.shape[1] + enc_b.shape[1] if cfg.partition == "vertical" \
            else enc_a.shape[1]
        zeros_np = [np.zeros(tuple(s), np.uint64) for s in (shape_a, shape_b)]
        csr_a, csr_b = ([CSRMatrix.from_dense(z) for z in zeros_np]
                        if cfg.sparse else (None, None))
        mu = AShare(torch.zeros((cfg.k, d), dtype=ring.DTYPE, device=device),
                    torch.zeros((cfg.k, d), dtype=ring.DTYPE, device=device))
        ctx.tag = "S1"
        dist = self._distances(ctx, enc_a, enc_b, csr_a, csr_b, mu)
        ctx.tag = "S2"
        c = P.argmin_onehot(ctx, dist)
        ctx.tag = "S3"
        mu_new = self._update(ctx, enc_a, enc_b, csr_a, csr_b, c, mu, n)
        iter_comm = CommLog()
        iter_comm.merge(ctx.log, phase="online")
        if cfg.tol is not None:
            ctx.tag = "CSC"
            self._converged(ctx, mu, mu_new, cfg.tol)
        return ctx.dealer.plan(), iter_comm

    # ------------------------------------------------------------------ #
    def _init_centroids(self, ctx, rng, x_a, x_b) -> AShare:
        """Jointly negotiated random sample indexes (paper Sec 4.2); each
        party secret-shares its slice of the chosen rows."""
        cfg = self.cfg
        dev = ctx.device
        if cfg.partition == "vertical":
            n = x_a.shape[0]
            idx = rng.choice(n, cfg.k, replace=False)
            mu_a = _encode_np(x_a[idx], cfg.f)        # A shares its columns
            mu_b = _encode_np(x_b[idx], cfg.f)
            sh = _share_cat(rng, [mu_a, mu_b], axis=1, device=dev)
        else:
            n = x_a.shape[0] + x_b.shape[0]
            idx = rng.choice(n, cfg.k, replace=False)
            mask = idx < x_a.shape[0]
            rows_a = _encode_np(x_a[idx[mask]], cfg.f)
            rows_b = _encode_np(x_b[idx[~mask] - x_a.shape[0]], cfg.f)
            sh = _share_cat(rng, [rows_a, rows_b], axis=0, device=dev)
            # restore the jointly-negotiated index order (A rows then B rows
            # were concatenated; undo that permutation)
            perm = np.concatenate([np.where(mask)[0], np.where(~mask)[0]])
            inv = torch.as_tensor(np.argsort(perm), device=dev)
            sh = AShare(sh.s0[inv], sh.s1[inv])
        ctx.log.send(2 * ring.nbytes(sh.shape), tag="init", phase="online")
        return sh

    # ------------------------------------------------------------------ #
    def _distances(self, ctx, enc_a, enc_b, csr_a, csr_b, mu: AShare) -> AShare:
        """F_ESD: D' = U - 2 X mu^T at scale f (one final truncation)."""
        cfg = self.cfg
        # U_j = ||mu_j||^2 : one batched SMUL + row-sum  (scale 2f)
        mu_sq = P.smul(ctx, mu, mu)
        u = AShare(mu_sq.s0.sum(1), mu_sq.s1.sum(1))          # (k,)
        if not cfg.vectorized:
            _naive_extra_rounds(ctx, cfg.k * mu.shape[1])
        xmu = self._x_mut(ctx, enc_a, enc_b, csr_a, csr_b, mu)  # (n,k) 2f
        d2 = P.sub(AShare(u.s0[None, :], u.s1[None, :]), P.lshift(xmu, 1))
        return P.trunc(d2, cfg.f)

    def _x_mut(self, ctx, enc_a, enc_b, csr_a, csr_b, mu: AShare) -> AShare:
        """X @ mu^T as shares, splitting local vs joint blocks (Eq. 4/5)."""
        mm = ctx.backend.ring_mm
        mut = AShare(mu.s0.T, mu.s1.T)                        # (d, k)
        j1, j2 = self._joint_x_mut(ctx, enc_a, enc_b, csr_a, csr_b, mut)
        if self.cfg.partition == "vertical":
            da = enc_a.shape[1]
            # local: A's data x A's share slice; B's data x B's share slice
            loc_a = mm(enc_a, mut.s0[:da])
            loc_b = mm(enc_b, mut.s1[da:])
            return AShare(loc_a + j1.s0 + j2.s0, loc_b + j1.s1 + j2.s1)
        # horizontal: rows split; each party's rows hit BOTH mu shares
        loc_a = mm(enc_a, mut.s0)                             # A x own share
        loc_b = mm(enc_b, mut.s1)
        top = AShare(loc_a + j1.s0, j1.s1)
        bot = AShare(j2.s0, loc_b + j2.s1)
        return AShare(torch.cat([top.s0, bot.s0], 0),
                      torch.cat([top.s1, bot.s1], 0))

    def _joint_x_mut(self, ctx, enc_a, enc_b, csr_a, csr_b,
                     mut: AShare) -> tuple:
        """The two JOINT blocks of X mu^T — A's data x B's share slice and
        vice versa (vertical: column slices of mu^T; horizontal: each
        party's rows x the other's full share)."""
        if self.cfg.partition == "vertical":
            da = enc_a.shape[1]
            j1 = self._pub_times_share(ctx, enc_a, csr_a,
                                       AShare(torch.zeros_like(mut.s1[:da]),
                                              mut.s1[:da]), owner="A")
            j2 = self._pub_times_share(ctx, enc_b, csr_b,
                                       AShare(mut.s0[da:],
                                              torch.zeros_like(mut.s0[da:])),
                                       owner="B")
            return j1, j2
        j1 = self._pub_times_share(ctx, enc_a, csr_a,
                                   AShare(torch.zeros_like(mut.s1), mut.s1),
                                   owner="A")                  # A x B's share
        j2 = self._pub_times_share(ctx, enc_b, csr_b,
                                   AShare(mut.s0, torch.zeros_like(mut.s0)),
                                   owner="B")                  # B x A's share
        return j1, j2

    def _pub_times_share(self, ctx, enc, csr, other_share: AShare,
                         owner: str) -> AShare:
        """One party's plaintext matrix x the OTHER party's share matrix.

        Dense path: Beaver matmul with the plaintext embedded as a degenerate
        share (this is what ships X-sized masked matrices).
        Sparse path: Protocol 2 — nnz-proportional HE compute, X never moves.
        """
        if self.cfg.sparse:
            b_mat = other_share.s1 if owner == "A" else other_share.s0
            z = secure_sparse_matmul(ctx, csr, b_mat, self.he,
                                     time_model=OU_COST_S)
            return z if owner == "A" else AShare(z.s1, z.s0)
        zero = torch.zeros_like(enc)
        pub = AShare(enc, zero) if owner == "A" else AShare(zero, enc)
        out = P.smatmul(ctx, pub, other_share)
        if not self.cfg.vectorized:
            _naive_extra_rounds(ctx, enc.shape[0] * other_share.shape[1])
        return out

    # ------------------------------------------------------------------ #
    def _update(self, ctx, enc_a, enc_b, csr_a, csr_b, c: AShare,
                mu_old: AShare, n: int) -> AShare:
        """F_SCU: mu = C^T X / 1^T C with empty-cluster MUX guard."""
        num = self._ct_x(ctx, enc_a, enc_b, csr_a, csr_b, c)   # (k, d) scale f
        den = AShare(c.s0.sum(0), c.s1.sum(0))                 # (k,) scale 1
        # the S3 program's tail, at the config's f
        return KS._s3_final_body(ctx, self.cfg.k, n, mu_old, num, den,
                                 f=self.cfg.f)

    def _ct_x(self, ctx, enc_a, enc_b, csr_a, csr_b, c: AShare) -> AShare:
        """C^T X -> (k, d) shares at scale f (C is scale-1 one-hot)."""
        ct = AShare(c.s0.T, c.s1.T)                            # (k, n)
        if self.cfg.partition == "vertical":
            # [C^T X_A | C^T X_B]; each block: share x one party's plaintext
            za = self._share_times_pub(ctx, ct, enc_a, csr_a, owner="A")
            zb = self._share_times_pub(ctx, ct, enc_b, csr_b, owner="B")
            return AShare(torch.cat([za.s0, zb.s0], 1),
                          torch.cat([za.s1, zb.s1], 1))
        na = enc_a.shape[0]
        ct_a = AShare(ct.s0[:, :na], ct.s1[:, :na])
        ct_b = AShare(ct.s0[:, na:], ct.s1[:, na:])
        za = self._share_times_pub(ctx, ct_a, enc_a, csr_a, owner="A")
        zb = self._share_times_pub(ctx, ct_b, enc_b, csr_b, owner="B")
        return P.add(za, zb)

    def _share_times_pub(self, ctx, ct: AShare, x, csr, owner: str) -> AShare:
        """<C>^T @ X_owner: the owner's share-product is local; the other
        party's requires a joint product (Beaver dense / Protocol 2 sparse,
        via the transpose identity <C>_other^T X = (X^T <C>_other)^T)."""
        cfg = self.cfg
        mm = ctx.backend.ring_mm
        zero = torch.zeros_like(x)
        local = mm(ct.s0 if owner == "A" else ct.s1, x)        # owner local
        if cfg.sparse:
            joint = self._joint_share_times_pub(ctx, ct, csr.transpose(),
                                                owner=owner)
        else:
            if owner == "A":
                joint = P.smatmul(ctx, AShare(torch.zeros_like(ct.s1), ct.s1),
                                  AShare(x, zero))
            else:
                joint = P.smatmul(ctx, AShare(ct.s0, torch.zeros_like(ct.s0)),
                                  AShare(zero, x))
            if not cfg.vectorized:
                _naive_extra_rounds(ctx, ct.shape[0] * x.shape[1])
        if owner == "A":
            return AShare(local + joint.s0, joint.s1)
        return AShare(joint.s0, local + joint.s1)

    def _joint_share_times_pub(self, ctx, ct: AShare, csr_t: CSRMatrix,
                               owner: str) -> AShare:
        """The sparse joint block of <C>^T X_owner: Protocol 2 on the pre-
        transposed CSR (transpose identity), on the other party's share."""
        if owner == "A":
            z = secure_sparse_matmul(ctx, csr_t, ct.s1.T, self.he,
                                     time_model=OU_COST_S)
            return AShare(z.s0.T, z.s1.T)
        z = secure_sparse_matmul(ctx, csr_t, ct.s0.T, self.he,
                                 time_model=OU_COST_S)
        return AShare(z.s1.T, z.s0.T)

    # -- Protocol-2 host exchanges for the split-program fast path -------- #
    def _s1_he_inputs(self, ctx, enc_a, enc_b, csr_a, csr_b,
                      mu: AShare) -> list:
        """Host exchange #1 (before S1): the distance-phase joint products
        of X mu^T, computable from the centroid shares alone. Returns the
        flat [s0, s1, ...] share list the S1 program takes as inputs, in
        the FitGeometry.he_shapes_s1 order."""
        mut = AShare(mu.s0.T, mu.s1.T)
        j1, j2 = self._joint_x_mut(ctx, enc_a, enc_b, csr_a, csr_b, mut)
        return [t for h in (j1, j2) for t in (h.s0, h.s1)]

    def _s3_he_inputs(self, ctx, csr_at, csr_bt, c: AShare) -> list:
        """Host exchange #2 (after S1): the update-phase joint products of
        C^T X on the assignment shares S1 produced. Flat share list in the
        FitGeometry.he_shapes_s3 order."""
        ct = AShare(c.s0.T, c.s1.T)
        if self.cfg.partition == "vertical":
            ja = self._joint_share_times_pub(ctx, ct, csr_at, owner="A")
            jb = self._joint_share_times_pub(ctx, ct, csr_bt, owner="B")
        else:
            na = csr_at.shape[1]                 # csr_at is X_A^T: (d, na)
            ct_a = AShare(ct.s0[:, :na], ct.s1[:, :na])
            ct_b = AShare(ct.s0[:, na:], ct.s1[:, na:])
            ja = self._joint_share_times_pub(ctx, ct_a, csr_at, owner="A")
            jb = self._joint_share_times_pub(ctx, ct_b, csr_bt, owner="B")
        return [t for h in (ja, jb) for t in (h.s0, h.s1)]

    # ------------------------------------------------------------------ #
    def _converged(self, ctx, mu_old: AShare, mu_new: AShare, tol: float) -> bool:
        """F_CSC: reveal only CMP(ESD(mu_t, mu_t+1), eps)."""
        diff = P.sub(mu_new, mu_old)
        sq = P.smul(ctx, diff, diff)                           # scale 2f
        tot = AShare(sq.s0.sum(), sq.s1.sum())
        eps = ring.encode(tol, 2 * self.cfg.f, device=tot.s0.device).reshape(())
        bit = P.cmp_lt(ctx, tot, AShare(eps, torch.zeros_like(eps)))
        ctx.log.send(8, tag="CSC", phase="online")             # reveal stop bit
        return bool(rec(bit).item() == 1)


# ---------------------------------------------------------------------------
# Plaintext oracle (same init, same ESD criterion)
# ---------------------------------------------------------------------------

def plaintext_kmeans(x: np.ndarray, k: int, iters: int, seed: int = 0,
                     tol: float | None = None):
    """Float Lloyd with the same joint-random-row init as SecureKMeans."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], k, replace=False)
    mu = x[idx].copy()
    labels = np.zeros(x.shape[0], np.int64)
    for _ in range(iters):
        d = (mu ** 2).sum(1)[None, :] - 2 * x @ mu.T           # same D'
        labels = d.argmin(1)
        mu_old = mu.copy()
        for j in range(k):
            m = labels == j
            if m.any():
                mu[j] = x[m].mean(0)
        if tol is not None and ((mu - mu_old) ** 2).sum() < tol:
            break
    return mu, labels


def _encode_np(x: np.ndarray, f: int) -> np.ndarray:
    return np.round(np.asarray(x, np.float64) * (1 << f)) \
        .astype(np.int64).astype(np.uint64)


def _share_cat(rng, mats, axis, device="cpu") -> AShare:
    parts = [share(m, rng, device) for m in mats]
    return AShare(torch.cat([p.s0 for p in parts], axis),
                  torch.cat([p.s1 for p in parts], axis))


def _naive_extra_rounds(ctx, n_interactions: int) -> None:
    """Pre-vectorization accounting: the same payload would be shipped in
    `n_interactions` round-trips instead of 1 (paper Sec 4.2). Bytes are
    already logged by the vectorized op; only rounds differ."""
    ctx.log.send(0, tag=ctx.tag, phase="online", rounds=int(n_interactions) - 1)
