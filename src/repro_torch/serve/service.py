"""Secure fraud-scoring service loop (paper Sec 5.6 deployed).

A fitted model must score a continuous stream of NEW transactions. Three
pieces make that a service rather than a per-request protocol run:

* **Batch ladder** — arrival batches are ragged; recording a
  `predict_program` and tracing a plan per exact batch size would put that
  work on the hot path. The service pads each coalesced group up to a
  small ladder of fixed geometries (`BatchLadder`), so steady state runs
  from the program and predict-plan caches. Pad rows are zeros; their
  outputs are sliced off before anything is revealed.
* **Request coalescing** — queued requests are merged FIFO until the next
  one would overflow the top rung, then scored in ONE program call; a
  single oversized request is chunked across calls. Per-request outputs
  are split back out of the group results.
* **TripleBank** — the correlated randomness of every ladder geometry is
  provisioned ONCE (offline) under the predict-plan key, on the model's
  device, and drained across requests; a stock-out replenishes (counted —
  size `provision_copies` so replenishment stays off the online path, or
  let a `BankReplenisher` daemon top the shelves up first).

The control plane: admission control (`max_queue`; past it a request is
SHED with a typed `QueueFull` response), per-request deadlines (checked at
dequeue and after collect; an expired request answers `DeadlineExceeded`),
bounded retries of a failing group (a poisoned request resolves as an
error response and cannot livelock the drain), and a background loop
(`start`/`stop`, `response(rid)`, `health`).

Durability: with a `ServeCheckpointer` (checkpoint/serve.py) the first
`warm` snapshots the provisioned bank, every drain journals its responses
plus the bank's consumed counts BEFORE exposing them, and a restarted
service replays the journal and realigns the bank (`discard`), so every
request is answered exactly once across a crash. `serve/wire.py` puts the
service on the wire.

The service reveals ONLY the per-transaction outputs (cluster label and/or
outlier score); centroids and per-cluster structure stay secret-shared.
`warm` exposes the service's stats, its bank and its replenisher through
the process-wide metrics registry (callback gauges, repro_torch/obs), and
admission, drains and each request's lifetime record trace spans, as the
JAX package's service does.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from repro_torch.core.kmeans import KMeansResult, SecureKMeans
from repro_torch.core.triples import BankReplenisher, TripleBank, serve_seed
from repro_torch.launch import kmeans_step as KS
from repro_torch.launch.pipeline import PipelineError, StageTask, run_pipeline
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# Stable error-string prefixes (the `ScoringResponse.error` type tags).
ERR_QUEUE_FULL = "QueueFull"
ERR_DEADLINE = "DeadlineExceeded"

# Latency samples kept for the p50/p99 window (drop-oldest beyond this).
LATENCY_WINDOW = 10_000

# The host phases of one program call, timed into `ServiceStats`.
HOST_PHASES = ("prepare", "launch", "collect")


class BatchLadder:
    """Sorted rung sizes; `rung_for(m)` is the smallest rung >= m (the pad
    target), falling back to the top rung for oversized groups (the caller
    chunks those). Rungs must come in strictly increasing positive order —
    an unsorted or duplicated ladder is rejected, not reordered."""

    def __init__(self, rungs=(32, 128, 512)):
        if not rungs:
            raise ValueError("BatchLadder needs at least one rung")
        self.rungs = tuple(int(r) for r in rungs)
        if self.rungs[0] < 1:
            raise ValueError(f"ladder rungs must be >= 1, got {self.rungs}")
        if any(a >= b for a, b in zip(self.rungs, self.rungs[1:])):
            raise ValueError("ladder rungs must be sorted strictly "
                             f"increasing, got {self.rungs}")

    @property
    def max_rung(self) -> int:
        return self.rungs[-1]

    def rung_for(self, m: int) -> int:
        for r in self.rungs:
            if m <= r:
                return r
        return self.rungs[-1]


@dataclasses.dataclass
class ScoringResponse:
    request_id: int
    labels: np.ndarray                # horizontal: [A rows; B rows] order
    scores: np.ndarray | None         # squared distance to assigned centroid
    rows: int
    error: str | None = None          # None iff scored; else a typed tag:
                                      # "QueueFull: ..." (shed at admission),
                                      # "DeadlineExceeded: ..." (expired),
                                      # "<ExcType>: ..." (group kept failing
                                      # through max_attempts)


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    rows: int = 0                     # real transaction rows scored
    padded_rows: int = 0              # call rows incl. ladder padding
    launches: int = 0
    online_seconds: float = 0.0       # drain wall-clock
    online_bytes: int = 0             # per-call protocol traffic
    triples_served: int = 0           # correlated-randomness requests drawn
    replenish_events: int = 0         # bank stock-outs hit on the hot path
    failed_requests: int = 0          # resolved with an error response
    retried_groups: int = 0           # group retry attempts after a failure
    shed_requests: int = 0            # rejected at admission (queue full)
    expired_requests: int = 0         # answered DeadlineExceeded
    queue_depth: int = 0              # gauge: pending right now
    max_queue_depth: int = 0          # high-water mark ever observed
    rung_calls: dict = dataclasses.field(
        default_factory=dict)         # rung -> program calls padded to it
    host_seconds: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(HOST_PHASES, 0.0))
                                      # phase -> host seconds of every call:
                                      # prepare (pad, upload, bank draw,
                                      # Protocol-2 exchange), launch (queue
                                      # the kernels), collect (waits for the
                                      # device, reveals). Neither dict is in
                                      # `as_dict`, whose keys are the JAX
                                      # service's (each a scalar gauge)
    latencies: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW),
        repr=False)                   # submit->publish seconds, per request
    queue_waits: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW),
        repr=False)                   # submit->dequeue seconds, per request
    inflights: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW),
        repr=False)                   # dequeue->publish seconds, per request
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    # the lock guards the sample windows: records land from the publishing
    # thread, quantile reads come from whoever reads the stats

    def record_latency(self, seconds: float, *,
                       queue_wait: float | None = None,
                       inflight: float | None = None) -> None:
        with self.lock:
            self.latencies.append(float(seconds))
            if queue_wait is not None:
                self.queue_waits.append(float(queue_wait))
            if inflight is not None:
                self.inflights.append(float(inflight))

    def _quantile(self, window, q: float) -> float:
        with self.lock:
            if not window:
                return 0.0
            arr = np.asarray(window, np.float64)
        return float(np.quantile(arr, q))

    def latency_quantile(self, q: float) -> float:
        """Submit-to-publish latency quantile (seconds) over the sample
        window; 0.0 before any response has been published."""
        return self._quantile(self.latencies, q)

    def queue_wait_quantile(self, q: float) -> float:
        """Submit-to-dequeue (admission queue wait) quantile, seconds."""
        return self._quantile(self.queue_waits, q)

    def inflight_quantile(self, q: float) -> float:
        """Dequeue-to-publish (call + collect) quantile, seconds."""
        return self._quantile(self.inflights, q)

    def as_dict(self) -> dict:
        s = max(self.online_seconds, 1e-9)
        return {
            "requests": self.requests, "rows": self.rows,
            "padded_rows": self.padded_rows, "launches": self.launches,
            "online_seconds": round(self.online_seconds, 4),
            "rows_per_s": round(self.rows / s, 1),
            "triples_per_request": round(
                self.triples_served / max(1, self.requests), 1),
            "bytes_per_request": int(
                self.online_bytes / max(1, self.requests)),
            "pad_overhead": round(
                self.padded_rows / max(1, self.rows), 3),
            "replenish_events": self.replenish_events,
            "failed_requests": self.failed_requests,
            "retried_groups": self.retried_groups,
            "shed_requests": self.shed_requests,
            "expired_requests": self.expired_requests,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "p50_ms": round(self.latency_quantile(0.50) * 1e3, 3),
            "p99_ms": round(self.latency_quantile(0.99) * 1e3, 3),
            "queue_wait_p50_ms": round(
                self.queue_wait_quantile(0.50) * 1e3, 3),
            "queue_wait_p99_ms": round(
                self.queue_wait_quantile(0.99) * 1e3, 3),
            "inflight_p50_ms": round(
                self.inflight_quantile(0.50) * 1e3, 3),
            "inflight_p99_ms": round(
                self.inflight_quantile(0.99) * 1e3, 3),
        }


@dataclasses.dataclass(eq=False)     # identity equality: ndarray payloads
class _Pending:
    """One queued request: payload plus its admission bookkeeping."""
    rid: int
    x_a: np.ndarray
    x_b: np.ndarray
    deadline: float | None            # time.monotonic() cutoff, or None
    t_submit: float                   # time.monotonic() at admission
    t_submit_us: int = 0              # epoch µs at admission (span clock)
    t_dequeue: float | None = None    # time.monotonic() when a drain took it
    trace: str | None = None          # ambient trace id at admission


class ScoringService:
    """Queue -> coalesce -> pad-to-ladder -> secure scoring program.

    `model` is a `SecureKMeans` whose config describes the deployment
    (partition, sparsity, backend, device); `result` the fitted model to
    serve (defaults to `model.result_`). Vertical partitions need the
    feature split (`d_a`, `d_b`) to pre-provision; horizontal infers `d`
    from the centroids. `warm()` — called lazily on first drain — records
    every rung's `predict_program` and provisions `provision_copies` calls'
    correlated randomness per rung into the bank (a `TripleBank` on the
    model's device by default); both are offline work.
    `provision_workers > 1` splits each provisioning across a thread pool
    by shape-class, with the serial provisioning's words.

    `rungs` configures the pad ladder (alias: `ladder`, which also accepts
    a built `BatchLadder`). `pipeline=True` overlaps request t+1's host
    work (padding, upload, the Protocol-2 exchange and the bank draw) with
    request t's kernels on the device — the same responses as
    `pipeline=False`, because the per-request prepare order is the same.

    Serving-plane knobs: `max_queue` (admission high-water mark; `submit`
    past it returns a shed `ScoringResponse`), `default_deadline_s`
    (applied to requests that carry none), `replenisher` (a
    `BankReplenisher` bound to this service's bank, or a kwargs dict to
    build one; started by `warm()`, stopped by `close()`), `checkpointer`
    (a `ServeCheckpointer`: a fresh service snapshots its bank after
    `warm()`, every drain journals responses and consumed counts before
    exposing them, and a restart replays the journal and realigns the
    bank — exactly-once responses across a crash).
    """

    def __init__(self, model: SecureKMeans,
                 result: KMeansResult | None = None, *,
                 bank: TripleBank | None = None, ladder=None, rungs=None,
                 with_scores: bool = True, provision_copies: int = 4,
                 provision_workers: int = 1,
                 d_a: int | None = None, d_b: int | None = None,
                 pipeline: bool = True, max_attempts: int = 3,
                 max_queue: int | None = None,
                 default_deadline_s: float | None = None,
                 checkpointer=None, replenisher=None):
        self.model = model
        self.result = result if result is not None \
            else getattr(model, "result_", None)
        if self.result is None:
            raise ValueError("ScoringService needs a fitted model")
        self.bank = bank if bank is not None \
            else TripleBank(seed=serve_seed(model.cfg.seed),
                            device=model.cfg.device)
        if rungs is not None and ladder is not None:
            raise ValueError("pass rungs= or ladder=, not both")
        ladder = rungs if rungs is not None \
            else (ladder if ladder is not None else (32, 128, 512))
        self.ladder = ladder if isinstance(ladder, BatchLadder) \
            else BatchLadder(ladder)
        self.with_scores = with_scores
        self.pipeline = bool(pipeline)
        self.max_attempts = max(1, int(max_attempts))
        self.provision_copies = int(provision_copies)
        self.provision_workers = int(provision_workers)
        d = int(self.result.centroids.shape[1])
        if model.cfg.partition == "vertical":
            if d_a is None or d_b is None:
                raise ValueError("vertical service needs the feature split "
                                 "(d_a, d_b) to size its geometries")
            if d_a + d_b != d:
                raise ValueError(f"d_a + d_b = {d_a + d_b} != model d = {d}")
            self.d_a, self.d_b = int(d_a), int(d_b)
        else:
            self.d_a = self.d_b = d
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.default_deadline_s = default_deadline_s
        self._queue: list[_Pending] = []
        self._next_id = 0
        self._warmed = False
        self.offline_seconds = 0.0    # warm(): recording + provisioning
        self.stats = ServiceStats()
        self._cond = threading.Condition()
        self._done: dict[int, ScoringResponse] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self._draining = False
        self._closed = False
        self.loop_errors = 0
        self.last_loop_error: BaseException | None = None
        self.checkpointer = checkpointer
        if checkpointer is not None and checkpointer.has_bank():
            # restart: reload the provision-time bank snapshot, replay the
            # response journal, and discard exactly the requests the dead
            # incarnation consumed, so every class stream resumes at the
            # right word (the argument is in checkpoint/serve.py)
            self.bank = checkpointer.load_bank(device=model.cfg.device)
            journal, consumed = checkpointer.load_journal()
            if consumed:
                self.bank.discard(consumed)
            self._done.update(journal)
            if journal:
                self._next_id = max(journal) + 1
        if replenisher is None:
            self.replenisher = None
        elif isinstance(replenisher, BankReplenisher):
            if replenisher.bank is not self.bank:
                raise ValueError("replenisher must be bound to this "
                                 "service's bank (after a checkpoint "
                                 "restart the bank is the reloaded one — "
                                 "pass a kwargs dict instead)")
            self.replenisher = replenisher
        else:
            self.replenisher = BankReplenisher(self.bank,
                                               **dict(replenisher))

    # -- geometry helpers -------------------------------------------------
    def _rung_shapes(self, r: int) -> tuple:
        # vertical: column split; horizontal: d_a == d_b == d, both parties'
        # row blocks padded to the same rung
        return (r, self.d_a), (r, self.d_b)

    def warm(self) -> None:
        """Offline: record every rung's program and provision its triples
        (idempotent; re-warming only provisions unprovisioned rungs). With
        a checkpointer, the FIRST warm also snapshots the provisioned bank —
        the restart baseline; a restarted service loads that snapshot
        instead of provisioning, so the snapshot is never rewritten.
        Starts the replenisher daemon if one is configured."""
        t0 = time.perf_counter()
        cfg = self.model.cfg
        for r in self.ladder.rungs:
            sa, sb = self._rung_shapes(r)
            key, plan, _ = self.model.plan_predict(sa, sb, self.with_scores)
            if key not in self.bank.keys():
                self.bank.provision(key, plan, copies=self.provision_copies,
                                    workers=self.provision_workers)
            if self.model._runs_programs():
                KS.predict_program(cfg.partition, cfg.sparse, sa, sb, cfg.k,
                                   with_scores=self.with_scores,
                                   backend=cfg.backend, device=cfg.device)
        if self.checkpointer is not None and not self.checkpointer.has_bank():
            self.checkpointer.save_bank(self.bank)
        if self.replenisher is not None and not self.replenisher.running:
            self.replenisher.start()
        # expose this service's live stats and bank through the process-
        # wide registry (callback gauges: no second tally to drift)
        _metrics.register_service(self)
        _metrics.register_bank(self.bank)
        if self.replenisher is not None:
            _metrics.register_replenisher(self.replenisher)
        self._warmed = True
        self.offline_seconds += time.perf_counter() - t0

    # -- request queue ----------------------------------------------------
    def submit(self, x_a: np.ndarray, x_b: np.ndarray, *,
               deadline_s: float | None = None, rid: int | None = None):
        """Enqueue one arrival batch; returns its request id. Vertical:
        equal row counts (the parties' column slices of the same
        transactions); horizontal: each party's own arrival rows.

        `deadline_s` (else `default_deadline_s`) bounds how long the
        request may wait and run before answering `DeadlineExceeded`.
        `rid` pins the request id for retry dedup: a rid already answered
        or already queued is NOT re-enqueued — the same id comes back and
        `response(rid)` returns the original response.

        If admission would push the queue past `max_queue`, the request is
        SHED: a `ScoringResponse` with error prefix `QueueFull` is returned
        instead of an id (not cached, so a retry of the rid can be admitted
        later)."""
        x_a = np.asarray(x_a, np.float64)
        x_b = np.asarray(x_b, np.float64)
        if self.model.cfg.partition == "vertical" \
                and x_a.shape[0] != x_b.shape[0]:
            raise ValueError("vertical request needs equal batch rows")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.monotonic()
        with self._cond:
            if rid is not None:
                rid = int(rid)
                if rid in self._done \
                        or any(p.rid == rid for p in self._queue):
                    return rid            # duplicate delivery: dedup
                self._next_id = max(self._next_id, rid + 1)
            if self.max_queue is not None \
                    and len(self._queue) >= self.max_queue:
                self.stats.shed_requests += 1
                _trace.instant("serve.shed", rid=-1 if rid is None else rid)
                return ScoringResponse(
                    rid if rid is not None else -1,
                    labels=np.zeros(0, np.int64), scores=None, rows=0,
                    error=f"{ERR_QUEUE_FULL}: queue depth "
                    f"{len(self._queue)} at high-water mark "
                    f"{self.max_queue}")
            if rid is None:
                rid = self._next_id
                self._next_id += 1
            deadline = None if deadline_s is None else now + float(deadline_s)
            self._queue.append(_Pending(
                rid, x_a, x_b, deadline, now,
                t_submit_us=time.time_ns() // 1_000,
                trace=_trace.current_trace()))
            self.stats.queue_depth = len(self._queue)
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             len(self._queue))
            self._cond.notify_all()
        _trace.instant("serve.admit", rid=rid)
        return rid

    def pending(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- the serving loop -------------------------------------------------
    def drain(self) -> list[ScoringResponse]:
        """Score everything queued: coalesce FIFO up to the top rung, pad,
        call, split per request. Returns responses in submit order.

        With `pipeline`, while chunk t's kernels run on the device, chunk
        t+1's host work (padding, upload, Protocol-2 exchange, bank draw)
        runs on the host (launch/pipeline.run_pipeline). Prepare order is
        monotonic either way, so the bank serves the same words and
        pipeline=False returns the same responses.

        Deadline policy: a request already expired at dequeue answers
        `DeadlineExceeded` WITHOUT drawing triples or occupying a rung; one
        that expires while its group is in flight answers
        `DeadlineExceeded` after collect.

        Failure policy: a group whose call raises is retried up to
        `max_attempts` times WITHIN this drain; exhausted, its requests
        resolve as error `ScoringResponse`s (counted in
        `stats.failed_requests`) instead of being requeued, so a poisoned
        request cannot livelock the drain. Non-`Exception` escapes
        (KeyboardInterrupt and friends) requeue everything and propagate."""
        if not self._warmed:
            self.warm()
        with _trace.span("serve.drain"):
            return self._drain_batch()

    def _drain_batch(self) -> list[ScoringResponse]:
        t0 = time.perf_counter()
        served0 = self.bank.served_requests
        repl0 = self.bank.replenish_events
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self.stats.queue_depth = 0
        if not pending:
            self.stats.online_seconds += time.perf_counter() - t0
            return []
        now = time.monotonic()
        for p in pending:
            p.t_dequeue = now
        order = {p.rid: i for i, p in enumerate(pending)}
        expired = [p for p in pending
                   if p.deadline is not None and now >= p.deadline]
        live = [p for p in pending if p not in expired]
        groups = []
        queue = list(live)
        while queue:
            group = [queue.pop(0)]
            while queue and self._fits(group, queue[0]):
                group.append(queue.pop(0))
            groups.append(group)
        results: dict[int, tuple] = {}    # gi -> (labels, scores)
        errors: dict[int, Exception] = {}  # gi -> last failure
        todo = list(range(len(groups)))
        try:
            for attempt in range(self.max_attempts):
                if not todo:
                    break
                if attempt:
                    self.stats.retried_groups += len(todo)
                units = []        # one entry per call: (group idx, chunk)
                failed: set[int] = set()
                for gi in todo:
                    group = groups[gi]
                    try:
                        xa = np.concatenate([p.x_a for p in group], 0)
                        xb = np.concatenate([p.x_b for p in group], 0)
                        units.extend((gi, ca, cb)
                                     for ca, cb in self._chunks(xa, xb))
                    except Exception as e:
                        # malformed geometry dies before it reaches a call —
                        # the same bounded-retry fate as a call error
                        failed.add(gi)
                        errors[gi] = e
                tasks = [StageTask(
                    pre=lambda ca=ca, cb=cb: self._timed(
                        "prepare", self._prepare_one, ca, cb),
                    launch=lambda prep: self._timed(
                        "launch", self._launch_prepared, prep),
                    post=lambda prep, outs, _m, ca=ca, cb=cb: self._timed(
                        "collect", self._collect_one, prep, outs, ca, cb))
                    for _gi, ca, cb in units]
                chunk_outs = run_pipeline(tasks, pipeline=self.pipeline,
                                          capture_errors=True)
                per_group: dict[int, list] = {}
                for (gi, _ca, _cb), out in zip(units, chunk_outs):
                    if isinstance(out, PipelineError):
                        failed.add(gi)
                        errors[gi] = out.exc
                    else:
                        per_group.setdefault(gi, []).append(out)
                for gi in todo:
                    if gi not in failed:
                        results[gi] = self._stitch(per_group[gi])
                todo = [gi for gi in todo if gi in failed]
        except BaseException:
            # an escape the retry loop does not own: no responses were
            # returned, so requeue EVERY request (submit order preserved)
            with self._cond:
                self._queue[:0] = pending
                self.stats.queue_depth = len(self._queue)
            raise
        responses = [self._deadline_response(p, "at dequeue")
                     for p in expired]
        for gi, group in enumerate(groups):
            if gi in results:
                responses.extend(self._split_group(group, *results[gi]))
            else:
                responses.extend(self._error_responses(group, errors[gi]))
        responses.sort(key=lambda r: order[r.request_id])
        self.stats.online_seconds += time.perf_counter() - t0
        self.stats.triples_served += self.bank.served_requests - served0
        self.stats.replenish_events += self.bank.replenish_events - repl0
        self._publish(responses, pending)
        return responses

    def _publish(self, responses: list[ScoringResponse],
                 pending: list[_Pending]) -> None:
        """Journal (with a checkpointer) then expose one drain's responses
        and record their latencies — in that order, so a crash between the
        two replays rather than re-scores (checkpoint/serve.py)."""
        if not responses:
            return
        if self.checkpointer is not None:
            self.checkpointer.record(responses, self.bank.consumed_counts())
        now = time.monotonic()
        by_rid = {p.rid: p for p in pending}
        with self._cond:
            for r in responses:
                self._done[r.request_id] = r
                p = by_rid.get(r.request_id)
                if p is not None:
                    self.stats.record_latency(
                        now - p.t_submit, queue_wait=p.t_dequeue - p.t_submit,
                        inflight=now - p.t_dequeue)
            self._cond.notify_all()
        tracer = _trace.get_tracer()
        if tracer.enabled:
            # one request span per rid: submit-level dedup queues (and
            # publishes) a rid once; retry waves replay the cached response
            # without entering a drain
            for r in responses:
                p = by_rid.get(r.request_id)
                if p is None:
                    continue
                args = {"rid": p.rid,
                        "rows": r.rows,
                        "queue_wait_ms": round(
                            (p.t_dequeue - p.t_submit) * 1e3, 3)
                        if p.t_dequeue is not None else None,
                        "error": r.error}
                if p.trace is not None:
                    args["trace"] = p.trace
                tracer.complete_span(
                    "serve.request", p.t_submit_us,
                    round((now - p.t_submit) * 1e6), **args)

    # -- background serving loop ------------------------------------------
    def start(self) -> None:
        """Warm (provision + record) then serve drains on a daemon thread
        until `stop()`. Exceptions escaping a drain are counted
        (`loop_errors`, `last_loop_error`) and the loop keeps serving."""
        if self._thread is not None and self._thread.is_alive():
            return
        if not self._warmed:
            self.warm()
        self._running = True
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="scoring-service", daemon=True)
        self._thread.start()

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(0.05)
                if not self._running and not self._queue:
                    return
            try:
                self.drain()
            except Exception as e:             # noqa: BLE001 — supervised
                self.loop_errors += 1
                self.last_loop_error = e
                time.sleep(0.01)               # don't spin on a hot failure

    def stop(self) -> None:
        """Graceful: the loop finishes draining whatever is queued, then
        exits. No-op if the loop isn't running."""
        if self._thread is None:
            return
        self._draining = True
        try:
            with self._cond:
                self._running = False
                self._cond.notify_all()
            self._thread.join(timeout=60.0)
            self._thread = None
        finally:
            self._draining = False

    # -- health ------------------------------------------------------------
    HEALTH_CODES = {"STARTING": 0, "READY": 1, "DEGRADED": 2, "DRAINING": 3}

    @property
    def health(self) -> str:
        """STARTING until `warm()` finished, DRAINING while `stop()` is
        flushing the queue (or after `close()`), DEGRADED when the serving
        loop or the replenisher daemon has swallowed errors or the
        replenisher died, READY otherwise."""
        if self._draining or self._closed:
            return "DRAINING"
        if not self._warmed:
            return "STARTING"
        if self.loop_errors > 0:
            return "DEGRADED"
        r = self.replenisher
        if r is not None and (r.errors > 0 or not r.running):
            return "DEGRADED"
        return "READY"

    def health_code(self) -> int:
        return self.HEALTH_CODES[self.health]

    def close(self) -> None:
        """Stop the serving loop and the replenisher daemon."""
        self.stop()
        if self.replenisher is not None:
            self.replenisher.stop()
        self._closed = True

    def response(self, rid: int,
                 timeout: float | None = None) -> ScoringResponse | None:
        """Block until `rid`'s response is published; None on timeout.
        (`self.result` is the fitted model — hence not `result()`.)"""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while rid not in self._done:
                if deadline is None:
                    self._cond.wait(0.5)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
            return self._done[rid]

    def lookup(self, rid: int) -> ScoringResponse | None:
        """Non-blocking: the published response for `rid`, else None."""
        with self._cond:
            return self._done.get(rid)

    # -- response assembly ------------------------------------------------
    def _deadline_response(self, p: _Pending, phase: str) -> ScoringResponse:
        self.stats.expired_requests += 1
        return ScoringResponse(
            p.rid, labels=np.zeros(0, np.int64), scores=None, rows=0,
            error=f"{ERR_DEADLINE}: request expired {phase}")

    def _error_responses(self, group, exc: Exception) -> list:
        out = []
        for p in group:
            out.append(ScoringResponse(
                p.rid, labels=np.zeros(0, np.int64), scores=None, rows=0,
                error=f"{type(exc).__name__}: {exc}"))
            self.stats.failed_requests += 1
        return out

    def _fits(self, group, nxt: _Pending) -> bool:
        top = self.ladder.max_rung
        if self.model.cfg.partition == "vertical":
            return sum(p.x_a.shape[0] for p in group) \
                + nxt.x_a.shape[0] <= top
        return (sum(p.x_a.shape[0] for p in group)
                + nxt.x_a.shape[0] <= top
                and sum(p.x_b.shape[0] for p in group)
                + nxt.x_b.shape[0] <= top)

    def _chunks(self, xa, xb) -> list:
        """Top-rung row windows of one coalesced group (an oversized group
        runs as several calls)."""
        top = self.ladder.max_rung
        if self.model.cfg.partition == "vertical":
            return [(xa[lo:lo + top], xb[lo:lo + top])
                    for lo in range(0, max(1, xa.shape[0]), top)]
        n_chunks = max(1, -(-max(xa.shape[0], xb.shape[0]) // top))
        return [(xa[i * top:(i + 1) * top], xb[i * top:(i + 1) * top])
                for i in range(n_chunks)]

    def _timed(self, phase: str, fn, *args):
        """fn(*args), its host seconds added to `stats.host_seconds`."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stats.host_seconds[phase] += time.perf_counter() - t0

    def _prepare_one(self, ca, cb):
        """Host phase of one chunk: pad to its rung, plan and bank lookup,
        bank draw, Protocol-2 exchange (model.predict_prepare). For configs
        the program path can't serve it returns an eager marker — the whole
        protocol then runs in the launch phase."""
        cfg = self.model.cfg
        if cfg.partition == "vertical":
            r = self.ladder.rung_for(ca.shape[0])
        else:
            r = self.ladder.rung_for(max(ca.shape[0], cb.shape[0]))
        pa = _pad_rows(ca, r)
        pb = _pad_rows(cb, r)
        key, plan, _ = self.model.plan_predict(pa.shape, pb.shape,
                                               self.with_scores)
        if key not in self.bank.keys():
            # a rung the warmup never saw (e.g. ladder edited live)
            self.bank.provision(key, plan, copies=self.provision_copies,
                                workers=self.provision_workers)
        dealer = self.bank.dealer(key)
        if self.model._runs_programs():
            prep = self.model.predict_prepare(pa, pb, self.result,
                                              dealer=dealer,
                                              with_scores=self.with_scores)
            return prep, r, None
        return None, r, (pa, pb, dealer)

    def _launch_prepared(self, prep_state):
        prep, _r, eager = prep_state
        if prep is not None:
            return self.model.predict_launch(prep)
        pa, pb, dealer = eager
        run = self.model.score if self.with_scores else self.model.predict
        return run(pa, pb, self.result, dealer=dealer)

    def _collect_one(self, prep_state, outs, ca, cb):
        """Finish one chunk (waits for the device): PredictResult assembly,
        stats, pad-row slicing. Returns (labels, scores, a_rows) with
        horizontal labels ordered [real A rows; real B rows]."""
        prep, r, _eager = prep_state
        cfg = self.model.cfg
        pr = self.model.predict_collect(prep, outs) if prep is not None \
            else outs
        self.stats.launches += 1
        self.stats.rung_calls[r] = self.stats.rung_calls.get(r, 0) + 1
        self.stats.padded_rows += 2 * r if cfg.partition == "horizontal" \
            else r
        self.stats.online_bytes += pr.log.total_bytes("online")
        labels = pr.labels_plain()
        scores = pr.scores_plain() if self.with_scores else None
        if cfg.partition == "vertical":
            m = ca.shape[0]
            return labels[:m], None if scores is None else scores[:m], m
        idx = np.r_[0:ca.shape[0], r:r + cb.shape[0]]
        return (labels[idx], None if scores is None else scores[idx],
                ca.shape[0])

    def _stitch(self, chunk_outs) -> tuple:
        """Recombine one group's chunk outputs: vertical concatenates rows;
        horizontal restores the [all A rows; all B rows] group order from
        each chunk's [A block; B block]."""
        if self.model.cfg.partition == "vertical":
            labels = np.concatenate([o[0] for o in chunk_outs])
            scores = None if chunk_outs[0][1] is None \
                else np.concatenate([o[1] for o in chunk_outs])
            return labels, scores
        labels = np.concatenate([o[0][:o[2]] for o in chunk_outs]
                                + [o[0][o[2]:] for o in chunk_outs])
        if chunk_outs[0][1] is None:
            return labels, None
        scores = np.concatenate([o[1][:o[2]] for o in chunk_outs]
                                + [o[1][o[2]:] for o in chunk_outs])
        return labels, scores

    def _split_group(self, group, labels, scores) -> list[ScoringResponse]:
        """Split one coalesced group's stacked outputs back per request. A
        request whose deadline lapsed while the group was in flight answers
        `DeadlineExceeded` (its rows were scored; the work is sunk)."""
        cfg = self.model.cfg
        now = time.monotonic()
        out = []
        a_off = b_off = 0
        na_tot = sum(p.x_a.shape[0] for p in group)
        for p in group:
            na, nb = p.x_a.shape[0], p.x_b.shape[0]
            if cfg.partition == "vertical":
                sel = slice(a_off, a_off + na)
                lab = labels[sel]
                sc = scores[sel] if scores is not None else None
            else:
                idx = np.r_[a_off:a_off + na,
                            na_tot + b_off:na_tot + b_off + nb]
                lab = labels[idx]
                sc = scores[idx] if scores is not None else None
                b_off += nb
            a_off += na
            if p.deadline is not None and now >= p.deadline:
                out.append(self._deadline_response(p, "in flight"))
                continue
            out.append(ScoringResponse(p.rid, lab, sc,
                                       rows=na + (0 if cfg.partition ==
                                                  "vertical" else nb)))
            self.stats.requests += 1
            self.stats.rows += out[-1].rows
        return out


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    if x.shape[0] == rows:
        return x
    pad = np.zeros((rows - x.shape[0], x.shape[1]), x.dtype)
    return np.concatenate([x, pad], 0)
