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

`batch_size` runs minibatch Lloyd (`_fit_minibatch`): each iteration is
one pass over the data in batches, each batch an S1 and an S3-partial
program whose sums accumulate in secret-shared running accumulators, then
one finalize program divides. A `SlotDealer` serves each (iteration,
batch, stage) slot, and with `pipeline` batch t+1's host exchange and
tranche pin run while batch t's S1 is on the device (launch/pipeline.py).

`predict` / `score` assign new batches to the fitted clusters against the
secret-shared model (the S1 body alone: distances and tournament argmin,
plus each row's squared distance to its centroid for `score`), eagerly or
as one `predict_program` call split into prepare, launch and collect, the
phases the scoring service pipelines. `fit(dealer=...)` runs a fit on an
external provider, a provisioned `TripleBank`'s view (`plan_fit`).

`fit(checkpoint=, resume=, resume_step=)` publishes resumable `FitState`s
(checkpoint/fit.py) and finishes a killed fit with the uninterrupted one's
shares, dealer counters and CommLog; `wire=` (and `predict`/`score`'s)
ships every online CommLog event to the peer process as real frames
(core/channel.py). Entry points run on the GPU unless the config asks for
the CPU (`backend="torch", device="cpu"`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from repro_torch.checkpoint.fit import FitState
from repro_torch.checkpoint.store import config_fingerprint
from repro_torch.core import faultpoints as _fp
from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.channel import CommLog, NetModel
from repro_torch.core.he import OU_COST_S, SimulatedPHE
from repro_torch.core.sharing import AShare, rec, rec_real, share
from repro_torch.core.sparse import CSRMatrix, secure_sparse_matmul
from repro_torch.core.triples import (BankSlotDealer, PlanningDealer,
                                      PooledDealer, SlotDealer,
                                      StreamingPooledDealer, TriplePlan,
                                      TrustedDealer, serve_seed)
from repro_torch.launch import kmeans_step as KS
from repro_torch.launch.pipeline import StageTask, run_pipeline
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def _h_iter_seconds():
    return _metrics.get_registry().histogram(
        "repro_fit_iteration_seconds",
        buckets=_metrics.log_buckets(1e-3, 100.0))


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
    # Minibatch Lloyd: each iteration is still one full pass over the data,
    # as ceil(n / batch_size)-row batches whose S3 partial sums accumulate
    # in secret-shared running sums — peak pool residency O(batch) when
    # streamed. None = full batch. batch_size >= n is word for word the
    # full-batch pooled fit. Needs offline="pooled" or "streamed",
    # vectorized=True and f=ring.F.
    batch_size: int | None = None
    # With batch_size set: run batch t+1's Protocol-2 exchange and tranche
    # pin on the host while batch t's S1 is on the device (launch/
    # pipeline.py). pipeline=False runs the batches strictly in sequence —
    # the same shares, CommLog and dealer words.
    pipeline: bool = True

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
        if self.batch_size is not None and self.batch_size < 1:
            raise ValueError(
                f"KMeansConfig.batch_size must be None (full batch) or "
                f">= 1, got {self.batch_size}")
        if self.partition not in ("vertical", "horizontal"):
            raise ValueError(
                f"KMeansConfig.partition must be 'vertical' or "
                f"'horizontal', got {self.partition!r}")
        if self.backend == "cuda" and torch.device(self.device).type != "cuda":
            raise ValueError(
                f"backend='cuda' runs on device='cuda', got "
                f"device={self.device!r}; use backend='torch' for the CPU")
        if self.backend == "numpy" and torch.device(self.device).type != "cpu":
            raise ValueError(
                f"backend='numpy' is host-only and runs on device='cpu', got "
                f"device={self.device!r}; use backend='cuda' for the GPU")


@dataclasses.dataclass
class KMeansResult:
    centroids: AShare                 # (k, d) shares, scale f
    assignment: AShare                # (n, k) one-hot shares, scale 1
    iters_run: int
    log: CommLog
    dealer: "TrustedDealer | PooledDealer | StreamingPooledDealer | SlotDealer"
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


@dataclasses.dataclass
class PredictResult:
    """One secure-scoring batch against a fitted model. Only the shares are
    held; the final Rec happens in `labels_plain` / `scores_plain`, the
    protocol's single reveal point (centroids are never reconstructed)."""

    assignment: AShare                # (m, k) one-hot shares, scale 1
    scores: AShare | None             # (m,) ||x - mu_c||^2 shares, scale f
    log: CommLog
    seconds: float
    f: int = ring.F

    def labels_plain(self) -> np.ndarray:
        return rec(self.assignment).cpu().numpy().argmax(1)

    def scores_plain(self) -> np.ndarray:
        if self.scores is None:
            raise ValueError("assignments-only predict holds no scores; "
                             "use SecureKMeans.score")
        return ring.decode(rec(self.scores), self.f).cpu().numpy()


@dataclasses.dataclass
class PreparedPredict:
    """Host phase of one scoring-program call (`predict_prepare`):
    everything `predict_launch` needs to dispatch and `predict_collect`
    needs to finish. The pipelined scoring service prepares request t+1
    while request t's kernels run."""

    prog: object                      # launch.kmeans_step.PredictProgram
    args: tuple                       # program inputs, on the device
    log: CommLog                      # the request's live log
    comm: CommLog                     # the traced call's traffic to replay
    with_scores: bool
    x_a: np.ndarray                   # plaintext slices (for ||x||^2)
    x_b: np.ndarray
    t0: float


# (shapes, cfg-key) -> (one-iteration TriplePlan, one-iteration CommLog).
# The schedule is data-independent, so identical-shape fits share it; see
# SecureKMeans._plan_offline_iter. The minibatch stage and finalize plans
# live here too, under keys of their own ("mb", ...).
_PLAN_CACHE: dict[tuple, tuple] = {}

# (shapes, with_scores, cfg-key) -> (TriplePlan, CommLog) of ONE scoring
# call. The key is also the TripleBank lookup key: a bank provisioned under
# it serves any number of same-geometry requests across fits.
_PREDICT_PLAN_CACHE: dict[tuple, tuple] = {}


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _PREDICT_PLAN_CACHE.clear()


def _cached_plan(key: tuple, trace, cache: dict = _PLAN_CACHE) -> tuple:
    """(plan, comm) cached under `key`, made by `trace()` on a miss.
    Returns copies; cached state is never handed out mutable."""
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = trace()
    plan, comm = hit
    return TriplePlan(list(plan.requests)), comm.copy()


class SecureKMeans:
    """Two-party secure K-means. Party data stays plaintext at its owner;
    centroids/assignments are secret-shared end to end."""

    def __init__(self, cfg: KMeansConfig):
        self.cfg = cfg
        self.he = cfg.he_backend or SimulatedPHE()

    # ------------------------------------------------------------------ #
    def _runs_programs(self) -> bool:
        """Whether the config runs the S1/S3 and scoring programs: they
        hardcode f = ring.F, the unvectorized accounting is the eager
        loop's, and the host-only numpy backend runs no program."""
        return self.cfg.vectorized and self.cfg.f == ring.F \
            and self._traceable_backend()

    def _traceable_backend(self) -> bool:
        """The numpy ring backend runs on the host and cannot run in the
        programs; eager loops serve it (the same words either way)."""
        b = self.cfg.backend
        return getattr(b, "name", b) != "numpy"

    def _device(self) -> torch.device:
        """The config's device; a CUDA device with no GPU present raises
        rather than falling back to the CPU."""
        device = torch.device(self.cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"KMeansConfig(device={self.cfg.device!r}) needs a CUDA GPU "
                "and none is available; pass backend='torch', device='cpu' "
                "to run on the CPU")
        return device

    def fit(self, x_a: np.ndarray, x_b: np.ndarray, *, dealer=None,
            wire=None, checkpoint=None, resume: bool = False,
            resume_step: int | None = None) -> KMeansResult:
        """Jointly cluster the two parties' data. `dealer` (optional)
        supplies the fit's correlated randomness from an external provider:
        a `TripleBank.dealer(key)` view over a bank provisioned with
        `plan_fit`'s (key, plan) fits with no generation work. Under the
        fit's seed the bank serves the built-in dealers' words, so every
        share and CommLog tally is theirs.

        `wire` (optional `channel.WireSession`): every online CommLog event
        ships its byte count as frames to the peer process and pays its
        round trips before it is tallied; the fit's words are the unwired
        fit's.

        `checkpoint` (optional `checkpoint.fit.FitCheckpointer`): publish
        a resumable `FitState` at the configured iteration / batch cadence.
        `resume=True` restores the latest checkpoint (its fingerprint
        checked against this config and the data shapes) and continues to
        the uninterrupted fit's shares, dealer counters and CommLog.
        `resume_step` (the resume negotiation's agreed step) restores the
        largest published step at or before it instead; none means a fresh
        start."""
        with _trace.span("fit", rows=int(np.asarray(x_a).shape[0]),
                         k=self.cfg.k, iters=self.cfg.iters,
                         sparse=self.cfg.sparse,
                         wired=wire is not None):
            return self._fit(x_a, x_b, dealer=dealer, wire=wire,
                             checkpoint=checkpoint, resume=resume,
                             resume_step=resume_step)

    def _fit(self, x_a: np.ndarray, x_b: np.ndarray, *, dealer, wire,
             checkpoint, resume: bool,
             resume_step: int | None) -> KMeansResult:
        cfg = self.cfg
        device = self._device()
        if dealer is not None and torch.device(
                getattr(dealer, "device", device)).type != device.type:
            raise ValueError(
                f"fit(dealer=...) serves words on {dealer.device}, the "
                f"config runs on {device}")
        rng = np.random.default_rng(cfg.seed)
        ctx = P.make_ctx(cfg.seed, backend=cfg.backend, device=device,
                         wire=wire)
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
        st = self._load_fit_state(checkpoint, resume, resume_step,
                                  x_a.shape, x_b.shape)
        if st is not None:
            # the checkpointed shares and restored tallies replace init:
            # the init exchange happened (and was tallied) in the
            # interrupted run
            mu = AShare(_upload_u64(st.mu0, device),
                        _upload_u64(st.mu1, device))
            ctx.log.restore(st.comm)
        else:
            mu = self._init_centroids(ctx, rng, x_a, x_b)
        if cfg.batch_size is not None:
            return self._fit_minibatch(ctx, enc_a, enc_b, enc_a_np, enc_b_np,
                                       mu, n, ext_dealer=dealer,
                                       checkpoint=checkpoint, st=st)
        if st is not None and st.batch:
            raise ValueError(
                "a mid-iteration (batch > 0) checkpoint can only resume a "
                "minibatch fit; this config has batch_size=None")
        csr_a = CSRMatrix.from_dense(enc_a_np) if cfg.sparse else None
        csr_b = CSRMatrix.from_dense(enc_b_np) if cfg.sparse else None

        # pooled / streamed offline phase (or an external dealer): trace the
        # schedule (cached across same-shape fits), bulk-generate the pools,
        # upload them, and record the S1/S3 program pair that consumes them.
        # All of it is data-independent; the loop then runs with no dealer
        # work, the sparse combos' Protocol-2 exchanges on the host around
        # S1.
        it0 = st.iteration if st is not None else 0
        iter_counts = None
        if checkpoint is not None or it0:
            # the per-class requests one iteration consumes, from the plan:
            # a checkpoint stores the dealer positions only as a cross-check
            iter_counts = self._plan_offline_iter(
                x_a.shape, x_b.shape)[0].class_counts()
        if it0:
            adv = {k: c * it0 for k, c in iter_counts.items()}
            if st.advance and st.advance != adv:
                raise ValueError(
                    "checkpoint dealer-stream positions disagree with the "
                    "plan-derived positions — the checkpoint belongs to a "
                    "different offline schedule")
        else:
            adv = {}
        plan_s = 0.0
        fast = None
        if dealer is not None or cfg.offline in ("pooled", "streamed"):
            t0 = time.perf_counter()
            iter_plan, iter_comm = self._plan_offline_iter(x_a.shape,
                                                           x_b.shape)
            # other configs run the eager loop against the pooled dealer
            if self._runs_programs():
                progs = KS.fit_programs(cfg.partition, cfg.sparse,
                                        enc_a.shape, enc_b.shape, cfg.k,
                                        backend=ctx.backend, device=device)
                # the exchange on the assignment shares consumes the
                # pre-transposed CSRs
                csr_at = csr_a.transpose() if cfg.sparse else None
                csr_bt = csr_b.transpose() if cfg.sparse else None
                fast = (progs, iter_comm, csr_at, csr_bt)
            plan_s = time.perf_counter() - t0
            # resume: the restored tallies hold the WHOLE fit's offline
            # traffic (a dealer books its plan at construction), so a
            # resumed dealer books to a scratch log, its class streams
            # advanced past it0 iterations
            dlog = CommLog() if it0 else ctx.log
            if dealer is not None:
                # an external provider (a provisioned TripleBank's view):
                # its generation is on the bank's offline books; this fit
                # pays the (cached) plan and any stock-out stall
                if it0:
                    dealer.skip(iter_plan, it0)
                ctx.dealer = dealer
            elif cfg.offline == "pooled":
                ctx.dealer = PooledDealer(iter_plan.repeat(cfg.iters - it0),
                                          seed=cfg.seed, log=dlog,
                                          advance=adv, device=device)
            else:
                # group="auto": tiny k*d tranches share one worker wakeup
                ctx.dealer = StreamingPooledDealer(
                    iter_plan, cfg.iters - it0, seed=cfg.seed, log=dlog,
                    group="auto", advance=adv, device=device)
        elif it0:
            # on-demand resume: a fresh TrustedDealer on the live log (its
            # remaining offline tallies accrue on top of the restored ones,
            # as the original loop's would have), its streams advanced
            ctx.dealer = TrustedDealer(seed=cfg.seed, log=ctx.log,
                                       advance=adv, device=device)
        if st is not None:
            _restore_counters(ctx.dealer, st)

        _sync(device)
        t_start = time.perf_counter()
        dealer_s_pre = ctx.dealer.dealer_seconds
        h_iter = _h_iter_seconds()
        it = it0
        try:
            for it in range(it0 + 1, cfg.iters + 1):
                # host time, as in the JAX package: no wait for the device
                t_iter = time.perf_counter()
                mu_old = mu
                if fast is not None:
                    mu, c = self._fast_iteration(ctx, fast, enc_a, enc_b,
                                                 csr_a, csr_b, mu, it)
                else:
                    ctx.tag = "S1"
                    with _trace.span("fit.s1_distances", iter=it):
                        dist = self._distances(ctx, enc_a, enc_b, csr_a,
                                               csr_b, mu)
                    ctx.tag = "S2"
                    r_before = ctx.log.total_rounds("online")
                    with _trace.span("fit.s2_argmin", iter=it):
                        c = P.argmin_onehot(ctx, dist)    # (n, k) scale 1
                    if not cfg.vectorized:
                        # pre-vectorization: each of the n samples runs its
                        # own tournament (n interaction chains per round)
                        dr = ctx.log.total_rounds("online") - r_before
                        _naive_extra_rounds(ctx, (n - 1) * dr + 1)
                    ctx.tag = "S3"
                    with _trace.span("fit.s3_update", iter=it):
                        mu = self._update(ctx, enc_a, enc_b, csr_a, csr_b,
                                          c, mu_old, n)
                if cfg.tol is not None:
                    ctx.tag = "CSC"
                    if self._converged(ctx, mu_old, mu, cfg.tol):
                        break
                if checkpoint is not None \
                        and checkpoint.want_iter(it, cfg.iters):
                    # an iteration boundary: the live log holds iterations
                    # 1..it, nothing ahead
                    self._save_fit_ckpt(
                        checkpoint, ctx, it, 0, mu,
                        {k: c * it for k, c in iter_counts.items()})
                h_iter.observe(time.perf_counter() - t_iter)
            _sync(device)
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
                        mu: AShare, it: int) -> tuple:
        """One iteration as the S1 and S3 programs over the pool's tensors
        (ListDealer discipline). The sparse combos run Protocol 2 on the
        host on a forked ctx: exchange #1 needs only the centroid shares,
        exchange #2 the assignment shares S1 just produced; the results
        enter the programs as share inputs. Returns (mu', c)."""
        progs, iter_comm, csr_at, csr_bt = fast
        he1 = he3 = []
        hx = None
        _fp.probe("fit.exchange1")
        if self.cfg.sparse:
            # scratch log: the iteration's shape-determined traffic (the
            # exchanges' included) is replayed from iter_comm below; the
            # modelled HE time flows into ctx
            hx = ctx.fork(tag="S1")
            with _trace.span("fit.s1_exchange", iter=it):
                he1 = self._s1_he_inputs(hx, enc_a, enc_b, csr_a, csr_b,
                                         mu)
        with _trace.span("fit.s1_launch", iter=it):
            flat1 = KS.materialize_offline(progs.s1_requests, ctx.dealer)
            c0, c1 = progs.s1(enc_a, enc_b, mu.s0, mu.s1, *he1, *flat1)
        c = AShare(c0, c1)
        _fp.probe("fit.mid_s1")
        if self.cfg.sparse:
            hx.tag = "S3"
            with _trace.span("fit.s2_callback", iter=it):
                he3 = self._s3_he_inputs(hx, csr_at, csr_bt, c)
        _fp.probe("fit.s2_callback")
        with _trace.span("fit.s3_launch", iter=it):
            flat3 = KS.materialize_offline(progs.s3_requests, ctx.dealer)
            mu0, mu1 = progs.s3(enc_a, enc_b, mu.s0, mu.s1, c0, c1, *he3,
                                *flat3)
        _fp.probe("fit.s3_partial")
        # the traced iteration's online tallies (sends inside the programs
        # go to a scratch log)
        ctx.log.merge(iter_comm, phase="online")
        return AShare(mu0, mu1), c

    # ------------------------------------------------------------------ #
    # Minibatch Lloyd — batched S1/S3-partial programs, pipelined exchanges
    # ------------------------------------------------------------------ #
    def _fit_minibatch(self, ctx, enc_a, enc_b, enc_a_np, enc_b_np,
                       mu: AShare, n: int, ext_dealer=None, checkpoint=None,
                       st: FitState | None = None) -> KMeansResult:
        """Each iteration is one full pass over the data in
        ceil(n / batch_size)-row batches: per batch an S1 program (distances
        and argmin on the CURRENT centroids) and an S3-partial program whose
        (k, d) / (k,) sums accumulate in secret-shared running sums (share
        addition), then ONE finalize program divides. This is blocked
        full-batch Lloyd, not stochastic minibatching: word for word the
        full-batch pooled fit at batch_size >= n.

        With cfg.pipeline, batch t+1's Protocol-2 exchange and tranche pin
        run on the host while batch t's S1 is on the device
        (launch/pipeline.run_pipeline); the SlotDealer fixes each (iteration,
        batch, stage) slot's words at generation time, in canonical slot
        order, so pipeline=False is stream-identical.

        A checkpoint `st` with `batch > 0` restores the partial sums and the
        completed batches' assignment shares and runs on from its cursor;
        the dealer starts at the cut's slot."""
        cfg = self.cfg
        if cfg.offline not in ("pooled", "streamed"):
            raise ValueError(
                "batch_size (minibatch Lloyd) requires the planned offline "
                "phase: set offline='pooled' or 'streamed' "
                f"(got {cfg.offline!r})")
        if not self._runs_programs():
            raise ValueError(
                "minibatch Lloyd runs on the S1/S3 program fast path only: "
                f"it needs vectorized=True, f={ring.F} and a device "
                "backend (numpy is host-only)")
        ckpt = checkpoint
        if ckpt is not None and ckpt.batch_every is not None and cfg.pipeline:
            raise ValueError(
                "batch-granular checkpoints (batch_every) require "
                "pipeline=False: the pipelined executor merges batch t+1's "
                "traffic before batch t accumulates, so mid-iteration the "
                "live CommLog is not the canonical prefix a resume restores "
                "(iteration-boundary checkpoints work on both executors)")
        device = ctx.device
        t0 = time.perf_counter()
        bounds, stage_plans, (fin_plan, fin_comm) = \
            self._minibatch_slot_plans(enc_a.shape, enc_b.shape)
        batches = []
        for ((alo, ahi), (blo, bhi)), plans in zip(bounds, stage_plans):
            # contiguous row slices of the uploaded data: views, no copy
            dev_a, dev_b = enc_a[alo:ahi], enc_b[blo:bhi]
            ca = CSRMatrix.from_dense(enc_a_np[alo:ahi]) if cfg.sparse \
                else None
            cb = CSRMatrix.from_dense(enc_b_np[blo:bhi]) if cfg.sparse \
                else None
            s1_plan, s1_comm, s3_plan, s3_comm = plans
            batches.append({
                "dev_a": dev_a, "dev_b": dev_b,
                "csr_a": ca, "csr_b": cb,
                "csr_at": ca.transpose() if cfg.sparse else None,
                "csr_bt": cb.transpose() if cfg.sparse else None,
                "progs": KS.fit_batch_programs(cfg.partition, cfg.sparse,
                                               dev_a.shape, dev_b.shape,
                                               cfg.k, backend=ctx.backend,
                                               device=device),
                "s1_plan": s1_plan, "s1_comm": s1_comm,
                "s3_plan": s3_plan, "s3_comm": s3_comm,
                "a_rows": ahi - alo,
            })
        d = mu.shape[1]
        fin_prog = KS.finalize_program(cfg.k, d, n, backend=ctx.backend,
                                       device=device)
        iter_slots = []
        for b in batches:
            iter_slots += [b["s1_plan"], b["s3_plan"]]
        iter_slots.append(fin_plan)
        spi = len(iter_slots)                    # slots per iteration
        # (the JAX package's plan time also spans the dealer's construction,
        # which its offline_dealer_seconds then counts twice)
        plan_s = time.perf_counter() - t0
        it0 = st.iteration if st is not None else 0
        b0 = st.batch if st is not None else 0
        start_slot = it0 * spi + 2 * b0
        slot_counts = [p.class_counts() for p in iter_slots]

        def slots_advance(n_slots: int) -> dict:
            adv: dict = {}
            for si in range(n_slots):
                for ck, c in slot_counts[si % spi].items():
                    adv[ck] = adv.get(ck, 0) + c
            return adv

        if st is not None and st.advance \
                and st.advance != slots_advance(start_slot):
            raise ValueError(
                "checkpoint dealer-stream positions disagree with the "
                "plan-derived slot positions — the checkpoint belongs to a "
                "different offline schedule")
        # resume: the restored tallies hold the whole schedule's offline
        # traffic, booked at the original dealer's construction; a resumed
        # dealer books its remaining slots to a scratch log
        dlog = CommLog() if start_slot else ctx.log
        if ext_dealer is not None:
            bank = getattr(ext_dealer, "bank", None)
            if bank is None:
                raise ValueError(
                    "minibatch fit(dealer=...) takes a TripleBank dealer "
                    "view (bank.dealer(key) over a plan_fit provisioning); "
                    f"got {type(ext_dealer).__name__}")
            dealer = BankSlotDealer(bank, ext_dealer.key,
                                    iter_slots * cfg.iters, log=dlog,
                                    start_slot=start_slot)
        else:
            dealer = SlotDealer(iter_slots * cfg.iters, seed=cfg.seed,
                                log=dlog,
                                stream=(cfg.offline == "streamed"),
                                start_slot=start_slot, device=device)
        ctx.dealer = dealer
        if st is not None:
            _restore_counters(dealer, st)

        def zeros(shape):
            return torch.zeros(shape, dtype=ring.DTYPE, device=device)

        _sync(device)
        t_start = time.perf_counter()
        h_iter = _h_iter_seconds()
        it = it0
        c_parts = [None] * len(batches)
        try:
            for it in range(it0 + 1, cfg.iters + 1):
                t_iter = time.perf_counter()
                mu_old = mu
                base = (it - 1) * spi
                start_b = b0 if it == it0 + 1 else 0
                if start_b:
                    # mid-iteration resume: the restored partial sums and
                    # completed batches' assignment shares; the remaining
                    # batches run from the checkpointed cursor
                    acc = [_upload_u64(a, device) for a in st.acc]
                    for t in range(start_b):
                        c_parts[t] = AShare(
                            _upload_u64(st.c0_parts[t], device),
                            _upload_u64(st.c1_parts[t], device))
                else:
                    acc = [zeros((cfg.k, d)), zeros((cfg.k, d)),
                           zeros((cfg.k,)), zeros((cfg.k,))]

                def on_done(t_done: int, _it=it, _acc=acc, _mu=mu):
                    b_done = t_done + 1
                    if ckpt is None \
                            or not ckpt.want_batch(b_done, len(batches)):
                        return
                    # sequential executor only (enforced above): after
                    # batch t's post the live log holds exactly batches
                    # 0..t, the canonical prefix
                    self._save_fit_ckpt(
                        ckpt, ctx, _it - 1, b_done, _mu,
                        slots_advance((_it - 1) * spi + 2 * b_done),
                        acc=_acc, c_parts=c_parts[:b_done])

                tasks = [self._batch_task(ctx, dealer, b, mu, base + 2 * t,
                                          acc, c_parts, t, on_done=on_done)
                         for t, b in enumerate(batches) if t >= start_b]
                run_pipeline(tasks, pipeline=cfg.pipeline)
                _fp.probe("fit.finalize")
                fin_view = dealer.acquire(base + 2 * len(batches))
                flat_f = KS.materialize_offline(fin_prog.requests, fin_view)
                mu0, mu1 = fin_prog.fn(mu.s0, mu.s1, *acc, *flat_f)
                mu = AShare(mu0, mu1)
                ctx.log.merge(fin_comm, phase="online")
                if cfg.tol is not None:
                    # the CSC triples sit at the tail of the finalize slot
                    cctx = P.Ctx(dealer=fin_view, log=ctx.log, tag="CSC",
                                 backend=ctx.backend)
                    if self._converged(cctx, mu_old, mu, cfg.tol):
                        break
                if ckpt is not None and ckpt.want_iter(it, cfg.iters):
                    # an iteration boundary: the pipeline drained at
                    # finalize, so this cut is canonical on both executors
                    self._save_fit_ckpt(ckpt, ctx, it, 0, mu,
                                        slots_advance(it * spi))
                h_iter.observe(time.perf_counter() - t_iter)
            _sync(device)
            wall = time.perf_counter() - t_start
        finally:
            # an early stop, or an exception unwinding the loop, leaves
            # generated slots and the worker thread alive
            dealer.close()

        c = _assemble_assignment(cfg.partition, c_parts, batches)
        self.result_ = KMeansResult(
            centroids=mu, assignment=c, iters_run=it, log=ctx.log,
            dealer=dealer,
            # acquire() stalls (wait_seconds) stay in the online clock, and
            # the worker's overlapped generation (gen_seconds) stays out of
            # the offline column, as in the streamed full-batch fit
            online_seconds=wall,
            offline_dealer_seconds=dealer.dealer_seconds + plan_s,
            offline_modelled_ot_seconds=dealer.modelled_ot_seconds,
            he_seconds=ctx.he_seconds,
            loop_seconds=wall,
            offline_plan_seconds=plan_s,
        )
        return self.result_

    def _batch_task(self, ctx, dealer, b: dict, mu: AShare, slot0: int,
                    acc: list, c_parts: list, t: int,
                    on_done=None) -> StageTask:
        """One minibatch as a 4-phase pipeline step (launch/pipeline.py):
        pre = exchange #1 (centroid shares only) + S1 tranche pin; launch =
        S1; mid = exchange #2 on the assignment shares + S3 tranche pin;
        post = S3-partial + accumulator adds. Each exchange runs on a fresh
        ctx whose modelled HE time is added to the fit's when the exchange
        ends, in the JAX package's order (so he_seconds agrees to the last
        bit). `on_done(t)` runs after the adds: the checkpoint seam."""
        cfg = self.cfg
        progs = b["progs"]

        def hx_ctx(view, tag):
            return P.Ctx(dealer=view, log=CommLog(), tag=tag,
                         backend=ctx.backend)

        def pre():
            _fp.probe("fit.exchange1")
            view = dealer.acquire(slot0)
            he1 = []
            if cfg.sparse:
                hx = hx_ctx(view, "S1")
                he1 = self._s1_he_inputs(hx, b["dev_a"], b["dev_b"],
                                         b["csr_a"], b["csr_b"], mu)
                ctx.add_he_seconds(hx.he_seconds)
            flat1 = KS.materialize_offline(progs.s1_requests, view)
            ctx.log.merge(b["s1_comm"], phase="online")
            return he1, flat1

        def launch(prep):
            he1, flat1 = prep
            c0, c1 = progs.s1(b["dev_a"], b["dev_b"], mu.s0, mu.s1,
                              *he1, *flat1)
            _fp.probe("fit.mid_s1")
            return AShare(c0, c1)

        def mid(prep, c):
            _fp.probe("fit.s2_callback")
            view = dealer.acquire(slot0 + 1)
            he3 = []
            if cfg.sparse:
                hx = hx_ctx(view, "S3")
                he3 = self._s3_he_inputs(hx, b["csr_at"], b["csr_bt"], c)
                ctx.add_he_seconds(hx.he_seconds)
            flat3 = KS.materialize_offline(progs.s3p_requests, view)
            ctx.log.merge(b["s3_comm"], phase="online")
            return he3, flat3

        def post(prep, c, m):
            _fp.probe("fit.s3_partial")
            he3, flat3 = m
            n0, n1, d0, d1 = progs.s3p(b["dev_a"], b["dev_b"], c.s0, c.s1,
                                       *he3, *flat3)
            acc[0] = acc[0] + n0
            acc[1] = acc[1] + n1
            acc[2] = acc[2] + d0
            acc[3] = acc[3] + d1
            c_parts[t] = c
            if on_done is not None:
                on_done(t)

        return StageTask(pre, launch, mid, post)

    def _plan_batch_stage(self, shape_a, shape_b, stage: str):
        """(plan, comm) of ONE minibatch stage — 's1' (distances + argmin)
        or 's3p' (C^T X partial sums) — cached like the full-iteration
        plans, under keys of their own ("mb", ...), so a batch geometry
        equal to the full-batch one never hands back the other's plan.
        Concatenated per iteration (batch stages + finalize) the slot plans
        equal the full-batch iteration plan when batch_size >= n."""
        return _cached_plan(
            ("mb", stage) + self._plan_cache_key(shape_a, shape_b),
            lambda: self._trace_batch_stage(shape_a, shape_b, stage))

    def _trace_batch_stage(self, shape_a, shape_b, stage: str):
        """Dry-run trace of one minibatch stage on zero-filled batch
        slices with a PlanningDealer on the config's device (the per-stage
        analogue of `_trace_iteration`)."""
        cfg = self.cfg
        ctx, z, enc_a, enc_b, csr_a, csr_b = self._zero_trace(shape_a,
                                                               shape_b)
        if stage == "s1":
            d = enc_a.shape[1] + enc_b.shape[1] \
                if cfg.partition == "vertical" else enc_a.shape[1]
            mu = AShare(z((cfg.k, d)), z((cfg.k, d)))
            ctx.tag = "S1"
            dist = self._distances(ctx, enc_a, enc_b, csr_a, csr_b, mu)
            ctx.tag = "S2"
            P.argmin_onehot(ctx, dist)
        else:
            rows = enc_a.shape[0] if cfg.partition == "vertical" \
                else enc_a.shape[0] + enc_b.shape[0]
            c = AShare(z((rows, cfg.k)), z((rows, cfg.k)))
            ctx.tag = "S3"
            self._ct_x(ctx, enc_a, enc_b, csr_a, csr_b, c)
        comm = CommLog()
        comm.merge(ctx.log, phase="online")
        return ctx.dealer.plan(), comm

    def _plan_finalize(self, d: int, n: int):
        """(plan, comm) of the per-iteration finalize program (+ CSC when
        tol is set); keyed by the division constants, not the batch
        layout."""
        cfg = self.cfg
        return _cached_plan(("mb", "fin", cfg.k, int(d), int(n), cfg.f,
                             cfg.vectorized, cfg.tol is not None),
                            lambda: self._trace_finalize(d, n))

    def _trace_finalize(self, d: int, n: int):
        cfg = self.cfg
        ctx, z = self._planning_ctx()
        mu = AShare(z((cfg.k, d)), z((cfg.k, d)))
        ctx.tag = "S3"
        mu_new = KS._s3_final_body(ctx, cfg.k, n, mu,
                                   AShare(z((cfg.k, d)), z((cfg.k, d))),
                                   AShare(z((cfg.k,)), z((cfg.k,))), f=cfg.f)
        comm = CommLog()
        comm.merge(ctx.log, phase="online")
        if cfg.tol is not None:
            ctx.tag = "CSC"
            self._converged(ctx, mu, mu_new, cfg.tol)
        return ctx.dealer.plan(), comm

    def _minibatch_slot_plans(self, shape_a, shape_b):
        """The minibatch offline layout for party-input shapes. Returns
        (bounds, per-batch [(s1_plan, s1_comm, s3_plan, s3_comm)],
        (fin_plan, fin_comm)): per iteration the slots run
        [s1(b0), s3p(b0), s1(b1), ..., finalize]."""
        cfg = self.cfg
        na, nb = int(shape_a[0]), int(shape_b[0])
        if cfg.partition == "vertical":
            n, d = na, int(shape_a[1]) + int(shape_b[1])
        else:
            n, d = na + nb, int(shape_a[1])
        bounds = _minibatch_bounds(cfg.partition, na, nb, cfg.batch_size)
        stage_plans = []
        for (alo, ahi), (blo, bhi) in bounds:
            sa = (ahi - alo, int(shape_a[1]))
            sb = (bhi - blo, int(shape_b[1]))
            stage_plans.append(self._plan_batch_stage(sa, sb, "s1")
                               + self._plan_batch_stage(sa, sb, "s3p"))
        return bounds, stage_plans, self._plan_finalize(d, n)

    # ------------------------------------------------------------------ #
    # Secure scoring: batched predict/score against the secret-shared model
    # ------------------------------------------------------------------ #
    def predict(self, x_a: np.ndarray, x_b: np.ndarray,
                result: KMeansResult | None = None, *, dealer=None,
                compiled: bool | None = None, wire=None) -> PredictResult:
        """Assign a NEW batch to the fitted clusters without revealing the
        model: batched secure distances and tournament argmin against the
        secret-shared centroids; only the (m, k) assignment shares come
        back (Rec happens in `labels_plain`). Vertical: the parties hold
        the batch rows' column slices (equal row counts); horizontal: each
        party owns whole arrival rows, outputs ordered [A rows; B rows].

        `dealer` supplies the correlated randomness — by default an
        on-demand `TrustedDealer(serve_seed(cfg.seed))`; pass a
        `TripleBank.dealer(...)` view to serve from a provisioned pool
        (`plan_predict` gives the bank key and plan). `compiled=None` runs
        the `predict_program` path when the config allows it (vectorized,
        f = ring.F) and the eager protocol otherwise; both give the same
        words for any same-seeded per-class dealer."""
        return self._predict(x_a, x_b, result, dealer=dealer,
                             compiled=compiled, with_scores=False, wire=wire)

    def score(self, x_a: np.ndarray, x_b: np.ndarray,
              result: KMeansResult | None = None, *, dealer=None,
              compiled: bool | None = None, wire=None) -> PredictResult:
        """`predict` plus the (m,) shares of each row's squared distance to
        its assigned centroid: the tournament's winning D' value (carried
        for free) plus each party's local ||x||^2 contribution. The
        fraud-scoring primitive: outlier flags follow from revealing ONLY
        these scores, never centroids or per-cluster structure."""
        return self._predict(x_a, x_b, result, dealer=dealer,
                             compiled=compiled, with_scores=True, wire=wire)

    def _check_predict_args(self, x_a, x_b, result):
        cfg = self.cfg
        if result is None:
            result = getattr(self, "result_", None)
        if result is None:
            raise ValueError("predict/score needs a fitted model: call "
                             "fit() first or pass result=")
        x_a = np.asarray(x_a, np.float64)
        x_b = np.asarray(x_b, np.float64)
        d = result.centroids.shape[1]
        if cfg.partition == "vertical":
            if x_a.shape[0] != x_b.shape[0]:
                raise ValueError("vertical predict needs equal batch rows")
            if x_a.shape[1] + x_b.shape[1] != d:
                raise ValueError("predict feature split disagrees with the "
                                 f"fitted model: {x_a.shape[1]}+{x_b.shape[1]}"
                                 f" != {d}")
        else:
            if x_a.shape[1] != d or x_b.shape[1] != d:
                raise ValueError("horizontal predict rows must carry all "
                                 f"{d} model features")
        return x_a, x_b, result

    def _predict(self, x_a, x_b, result, *, dealer, compiled,
                 with_scores: bool, wire=None) -> PredictResult:
        cfg = self.cfg
        x_a, x_b, result = self._check_predict_args(x_a, x_b, result)
        if compiled:
            # an explicit request for the program path must not truncate
            # at the wrong scale, nor run a host backend where it cannot
            if cfg.f != ring.F:
                raise ValueError(
                    f"compiled predict hardcodes f = {ring.F}; cfg.f = "
                    f"{cfg.f} must use the eager path (compiled=False)")
            if not self._traceable_backend():
                raise ValueError(
                    "the host-only numpy backend cannot lower into the "
                    "compiled predict program; use compiled=False")
        use_fast = compiled if compiled is not None \
            else self._runs_programs()
        if use_fast:
            prep = self.predict_prepare(x_a, x_b, result, dealer=dealer,
                                        with_scores=with_scores, wire=wire)
            return self.predict_collect(prep, self.predict_launch(prep))
        with _trace.span("predict.eager", rows=int(x_a.shape[0]),
                         scores=with_scores):
            return self._predict_eager(x_a, x_b, result, dealer=dealer,
                                       with_scores=with_scores, wire=wire)

    def _encode_batch(self, x_a, x_b, device) -> tuple:
        """(enc_a, enc_b, csr_a, csr_b): the parties' encoded batch on
        `device`, uploaded without waiting for the device (`ring.upload`),
        and, when sparse, its host CSR matrices."""
        cfg = self.cfg
        enc_a_np, enc_b_np = _encode_np(x_a, cfg.f), _encode_np(x_b, cfg.f)
        enc_a, enc_b = (ring.upload(torch.from_numpy(e.view(np.int64)),
                                    device) for e in (enc_a_np, enc_b_np))
        if not cfg.sparse:
            return enc_a, enc_b, None, None
        return (enc_a, enc_b, CSRMatrix.from_dense(enc_a_np),
                CSRMatrix.from_dense(enc_b_np))

    def _predict_ctx(self, dealer, log: CommLog, device):
        # the default dealer is domain-separated from the fit's streams:
        # reusing cfg.seed would replay the fit's Beaver masks on
        # overlapping shape-classes (mask reuse on two secrets leaks their
        # difference)
        if dealer is None:
            dealer = TrustedDealer(seed=serve_seed(self.cfg.seed), log=log,
                                   device=device)
        return P.Ctx(dealer=dealer, log=log, tag="predict",
                     backend=self.cfg.backend)

    def _predict_eager(self, x_a, x_b, result, *, dealer,
                       with_scores: bool, wire=None) -> PredictResult:
        t0 = time.perf_counter()
        device = self._device()
        enc_a, enc_b, csr_a, csr_b = self._encode_batch(x_a, x_b, device)
        log = CommLog()
        log.wire = wire
        ctx = self._predict_ctx(dealer, log, device)
        dist = self._distances(ctx, enc_a, enc_b, csr_a, csr_b,
                               result.centroids)
        scores = None
        if with_scores:
            c, vmin = P.argmin_onehot(ctx, dist, return_min=True)
            # ||x - mu_c||^2 = ||x||^2 + (||mu_c||^2 - 2 x.mu_c): the first
            # term is party-local plaintext (each owner encodes its slice's
            # contribution into its share), the second the tournament's
            # winning D' value
            scores = P.add(vmin, self._norm_shares(x_a, x_b, device))
        else:
            c = P.argmin_onehot(ctx, dist)
        _sync_stream(device)
        return PredictResult(assignment=c, scores=scores, log=log,
                             seconds=time.perf_counter() - t0, f=self.cfg.f)

    # -- the program path, split into pipelineable phases ----------------- #
    def predict_prepare(self, x_a, x_b, result: KMeansResult | None = None,
                        *, dealer=None, with_scores: bool = False,
                        wire=None) -> PreparedPredict:
        """Host phase of ONE scoring-program call: validate, encode and
        upload, run the Protocol-2 exchange (computable from the centroid
        shares alone), draw the offline tensors and stage the program's
        arguments. `predict_launch` queues the kernels and `predict_collect`
        assembles the PredictResult; prepare -> launch -> collect in
        sequence IS the program path, and the scoring service overlaps
        request t+1's prepare with request t's kernels — the same calls in
        the same order per request, so the pipelined and sequential drains
        give the same words. Nothing here waits for the device. With a
        `wire`, the call's traffic ships when `predict_collect` replays it."""
        cfg = self.cfg
        x_a, x_b, result = self._check_predict_args(x_a, x_b, result)
        if not self._runs_programs():
            raise ValueError(
                "predict_prepare stages the scoring program only; non-"
                "default f / unvectorized / numpy-backend configs must score "
                "through predict/score (eager path)")
        with _trace.span("predict.prepare", rows=int(x_a.shape[0]),
                         scores=with_scores):
            t0 = time.perf_counter()
            device = self._device()
            enc_a, enc_b, csr_a, csr_b = self._encode_batch(x_a, x_b, device)
            log = CommLog()
            log.wire = wire
            ctx = self._predict_ctx(dealer, log, device)
            mu = result.centroids
            prog = KS.predict_program(cfg.partition, cfg.sparse, enc_a.shape,
                                      enc_b.shape, cfg.k,
                                      with_scores=with_scores,
                                      backend=ctx.backend, device=device)
            _, comm = self._plan_predict_cached(x_a.shape, x_b.shape,
                                                with_scores)
            he1 = []
            if cfg.sparse:
                # scratch log: the call's shape-determined traffic, the
                # exchange's included, is replayed from the plan at collect
                he1 = self._s1_he_inputs(ctx.fork(tag="predict"), enc_a,
                                         enc_b, csr_a, csr_b, mu)
            flat = KS.materialize_offline(prog.requests, ctx.dealer)
            return PreparedPredict(
                prog=prog, args=(enc_a, enc_b, mu.s0, mu.s1, *he1, *flat),
                log=log, comm=comm, with_scores=with_scores, x_a=x_a,
                x_b=x_b, t0=t0)

    def predict_launch(self, prep: PreparedPredict):
        """Run the staged scoring program: its kernels are queued on the
        current stream and the output tensors come back at once."""
        with _trace.span("predict.launch"):
            return prep.prog.fn(*prep.args)

    def predict_collect(self, prep: PreparedPredict, outs) -> PredictResult:
        """Assemble one call's outputs (waits for the device): assignment
        shares, optional score shares (winning D' plus the local ||x||^2
        encodings), replayed traffic."""
        with _trace.span("predict.collect"):
            c = AShare(outs[0], outs[1])
            scores = None
            if prep.with_scores:
                scores = P.add(AShare(outs[2], outs[3]),
                               self._norm_shares(prep.x_a, prep.x_b,
                                                 outs[0].device))
            prep.log.merge(prep.comm, phase="online")
            _sync_stream(outs[0].device)
            return PredictResult(assignment=c, scores=scores, log=prep.log,
                                 seconds=time.perf_counter() - prep.t0,
                                 f=self.cfg.f)

    def _norm_shares(self, x_a, x_b, device) -> AShare:
        """(m,) shares of ||x||^2 at scale f from party-local plaintext.
        Vertical: A's columns land in s0, B's in s1. Horizontal: the owner
        of each row holds its whole norm (A rows -> s0, B rows -> s1)."""
        cfg = self.cfg
        na = _encode_np((x_a ** 2).sum(1), cfg.f)
        nb = _encode_np((x_b ** 2).sum(1), cfg.f)
        if cfg.partition == "horizontal":
            na, nb = (np.concatenate([na, np.zeros_like(nb)]),
                      np.concatenate([np.zeros_like(na), nb]))
        return AShare(ring.from_u64_numpy(na, device),
                      ring.from_u64_numpy(nb, device))

    # ------------------------------------------------------------------ #
    def plan_predict(self, shape_a, shape_b,
                     with_scores: bool = False) -> tuple:
        """(bank_key, TriplePlan, CommLog) of ONE scoring call for
        party-input batch shapes — without seeing any data. The plan is the
        exact correlated-randomness schedule a `predict`/`score` call of
        these shapes consumes (Protocol-2 mask seeds included); the key is
        the predict-plan cache key, which `TripleBank.provision` takes as
        the pool lookup key. Cached: a service scoring thousands of batches
        traces each geometry once."""
        key = self._predict_plan_key(shape_a, shape_b, with_scores)
        plan, comm = self._plan_predict_cached(shape_a, shape_b, with_scores)
        return key, plan, comm

    def _predict_plan_key(self, shape_a, shape_b, with_scores) -> tuple:
        return ("predict", bool(with_scores)) \
            + self._plan_cache_key(shape_a, shape_b)

    def _plan_predict_cached(self, shape_a, shape_b, with_scores):
        return _cached_plan(
            self._predict_plan_key(shape_a, shape_b, with_scores),
            lambda: self._trace_predict(shape_a, shape_b, with_scores),
            _PREDICT_PLAN_CACHE)

    def _trace_predict(self, shape_a, shape_b, with_scores):
        """Dry-run trace of one scoring call (distances + argmin) with a
        PlanningDealer on zero-filled inputs on the config's device — the
        predict counterpart of `_trace_iteration`."""
        cfg = self.cfg
        ctx, z, enc_a, enc_b, csr_a, csr_b = self._zero_trace(shape_a,
                                                               shape_b)
        ctx.tag = "predict"
        d = enc_a.shape[1] + enc_b.shape[1] if cfg.partition == "vertical" \
            else enc_a.shape[1]
        mu = AShare(z((cfg.k, d)), z((cfg.k, d)))
        dist = self._distances(ctx, enc_a, enc_b, csr_a, csr_b, mu)
        P.argmin_onehot(ctx, dist, return_min=with_scores)
        comm = CommLog()
        comm.merge(ctx.log, phase="online")
        return ctx.dealer.plan(), comm

    def plan_fit(self, shape_a, shape_b) -> tuple:
        """(bank_key, TriplePlan, CommLog) of a WHOLE fit for party-input
        shapes — the fit-side counterpart of `plan_predict`. The plan is the
        exact schedule `fit` consumes (full batch: the iteration plan
        repeated `iters` times; minibatch: the slot plans in canonical
        order), Protocol-2 mask seeds included; the key is the fit-plan
        cache key extended with the loop geometry (iters, batch_size).
        Provision a bank under the fit's `cfg.seed`, then call
        `fit(..., dealer=bank.dealer(key))`: the fit does no generation
        work and gives the built-in dealers' words. The CommLog is ONE
        iteration's online traffic."""
        cfg = self.cfg
        key = self._fit_plan_key(shape_a, shape_b)
        if cfg.batch_size is None:
            iter_plan, iter_comm = self._plan_offline_iter(shape_a, shape_b)
            return key, iter_plan.repeat(cfg.iters), iter_comm
        _bounds, stage_plans, (fin_plan, fin_comm) = \
            self._minibatch_slot_plans(shape_a, shape_b)
        iter_reqs, iter_comm = [], CommLog()
        for s1, c1, s3, c3 in stage_plans:
            iter_reqs += list(s1.requests) + list(s3.requests)
            iter_comm.merge(c1, phase="online")
            iter_comm.merge(c3, phase="online")
        iter_reqs += list(fin_plan.requests)
        iter_comm.merge(fin_comm, phase="online")
        return key, TriplePlan(iter_reqs * cfg.iters), iter_comm

    def _fit_plan_key(self, shape_a, shape_b) -> tuple:
        return ("fit", self.cfg.iters, self.cfg.batch_size) \
            + self._plan_cache_key(shape_a, shape_b)

    # -- checkpoints ------------------------------------------------------ #
    def _fit_fingerprint(self, shape_a, shape_b) -> str:
        """Checkpoint identity: everything that shapes the fit's schedule,
        streams and init — a resumed run with any of these changed would
        not be the same fit. The key is the JAX package's, so a config
        gives the same fingerprint in both packages. `pipeline` is left
        out: the executors are stream-identical at checkpointable cuts."""
        cfg = self.cfg
        key = self._fit_plan_key(shape_a, shape_b) + (
            "fit-ckpt", cfg.seed, cfg.offline, cfg.init, cfg.tol)
        return config_fingerprint(key)

    def _load_fit_state(self, checkpoint, resume: bool, resume_step,
                        shape_a, shape_b) -> FitState | None:
        """Bind `checkpoint` to this (config, shapes) run, so a foreign
        checkpoint fails the fingerprint check at load, and return the
        state to resume from (None: a fresh start)."""
        if checkpoint is not None:
            checkpoint.fingerprint = checkpoint.fingerprint \
                or self._fit_fingerprint(shape_a, shape_b)
        if not resume and resume_step is None:
            return None
        if checkpoint is None:
            raise ValueError(
                "fit(resume=True) needs checkpoint=FitCheckpointer(...) to "
                "restore from")
        if resume_step is not None:
            s = checkpoint.step_at_or_before(int(resume_step))
            st = checkpoint.load(s) if s is not None else None
        else:
            st = checkpoint.latest()
        if st is not None and st.iteration >= self.cfg.iters:
            raise ValueError(
                f"checkpoint is at iteration {st.iteration} of a "
                f"{self.cfg.iters}-iteration fit: nothing left to resume")
        return st

    def _save_fit_ckpt(self, ckpt, ctx, it: int, batch: int, mu: AShare,
                       advance: dict, acc=None, c_parts=None) -> None:
        """Publish one cut. The device words are copied to the host on the
        current stream, after the iteration's (or batch's) last launch;
        the dealers' own streams are not waited on."""
        d = ctx.dealer
        ckpt.save(FitState(
            iteration=it, batch=batch,
            mu0=ring.to_u64_numpy(mu.s0), mu1=ring.to_u64_numpy(mu.s1),
            counters={"n_matmul": int(d.n_matmul), "n_mul": int(d.n_mul),
                      "n_bin": int(d.n_bin)},
            comm=ctx.log.state(), advance=advance,
            fingerprint=ckpt.fingerprint,
            acc=None if acc is None else [ring.to_u64_numpy(a) for a in acc],
            c0_parts=[ring.to_u64_numpy(p.s0) for p in (c_parts or [])],
            c1_parts=[ring.to_u64_numpy(p.s1) for p in (c_parts or [])]))

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
        return _cached_plan(self._plan_cache_key(shape_a, shape_b),
                            lambda: self._trace_iteration(shape_a, shape_b))

    def _planning_ctx(self) -> tuple:
        """(ctx over a PlanningDealer, zeros(shape)) on the config's device:
        what a dry-run trace runs on."""
        device = torch.device(self.cfg.device)
        ctx = P.Ctx(dealer=PlanningDealer(device), log=CommLog(),
                    backend=self.cfg.backend)

        def z(shape):
            return torch.zeros(tuple(shape), dtype=ring.DTYPE, device=device)

        return ctx, z

    def _zero_trace(self, shape_a, shape_b) -> tuple:
        """`_planning_ctx` plus zero party data of these shapes and, when
        sparse, their CSR matrices."""
        ctx, z = self._planning_ctx()
        csr_a, csr_b = ([CSRMatrix.from_dense(np.zeros(tuple(s), np.uint64))
                         for s in (shape_a, shape_b)]
                        if self.cfg.sparse else (None, None))
        return ctx, z, z(shape_a), z(shape_b), csr_a, csr_b

    def _trace_iteration(self, shape_a, shape_b):
        """Dry-run trace of one Lloyd iteration (+CSC when tol is set) with
        a PlanningDealer on zero-filled inputs on the config's device."""
        cfg = self.cfg
        ctx, z, enc_a, enc_b, csr_a, csr_b = self._zero_trace(shape_a,
                                                               shape_b)
        n = enc_a.shape[0] if cfg.partition == "vertical" \
            else enc_a.shape[0] + enc_b.shape[0]
        d = enc_a.shape[1] + enc_b.shape[1] if cfg.partition == "vertical" \
            else enc_a.shape[1]
        mu = AShare(z((cfg.k, d)), z((cfg.k, d)))
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


def _minibatch_bounds(partition: str, na: int, nb: int,
                      batch_size: int) -> list:
    """Per-batch row windows [((a_lo, a_hi), (b_lo, b_hi)), ...].

    Vertical: both parties hold column slices of the SAME rows, so batches
    are shared contiguous chunks of `batch_size` rows — at most two
    distinct shapes (full + remainder). Horizontal: each party's rows are
    split into the same NUMBER of contiguous near-equal chunks
    (B = ceil((na+nb)/batch_size), clamped so no chunk is empty); chunk
    sizes differ by at most one per party, so a fit records at most a
    handful of batch geometries whatever the batch count."""
    if partition == "vertical":
        bs = max(1, min(int(batch_size), na))
        return [((lo, min(lo + bs, na)),) * 2 for lo in range(0, na, bs)]
    n_batches = max(1, min(-(-(na + nb) // int(batch_size)), na, nb))
    return list(zip(_even_chunks(na, n_batches),
                    _even_chunks(nb, n_batches)))


def _even_chunks(n: int, parts: int) -> list:
    """Exactly `parts` contiguous windows over n rows, sizes q+1 x r then
    q x (parts - r) — never empty for parts <= n."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (1 if i < r else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _assemble_assignment(partition: str, c_parts: list,
                         batches: list) -> AShare:
    """Stitch the last iteration's per-batch assignment shares back into
    the full-fit (n, k) layout: vertical concatenates rows in batch order;
    horizontal restores the [all A rows; all B rows] order the full-batch
    path produces (each batch's rows come back [A chunk; B chunk])."""
    if partition == "vertical":
        return AShare(torch.cat([p.s0 for p in c_parts], 0),
                      torch.cat([p.s1 for p in c_parts], 0))
    a0 = [p.s0[:b["a_rows"]] for p, b in zip(c_parts, batches)]
    a1 = [p.s1[:b["a_rows"]] for p, b in zip(c_parts, batches)]
    b0 = [p.s0[b["a_rows"]:] for p, b in zip(c_parts, batches)]
    b1 = [p.s1[b["a_rows"]:] for p, b in zip(c_parts, batches)]
    return AShare(torch.cat(a0 + b0, 0), torch.cat(a1 + b1, 0))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync_stream(device: torch.device) -> None:
    """Wait for the current stream only: a scoring call's work is all
    queued there (bank entries wait on their upload events), while a
    `BankReplenisher` top-up may still be copying on the bank's stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _upload_u64(words: np.ndarray, device) -> torch.Tensor:
    """Checkpointed uint64 words -> an int64 ring tensor on `device`, the
    same 64 bits (`ring.upload`: the host does not wait for the device)."""
    host = np.array(words, np.uint64, order="C")     # writable, contiguous
    return ring.upload(torch.from_numpy(host.view(np.int64)), device)


def _restore_counters(dealer, st: FitState) -> None:
    for attr in ("n_matmul", "n_mul", "n_bin"):
        setattr(dealer, attr, st.counters[attr])


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
