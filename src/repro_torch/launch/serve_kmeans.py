"""Secure fraud-scoring service launcher: fit jointly, then serve a stream.

    PYTHONPATH=src python -m repro_torch.launch.serve_kmeans \
        --n-train 2000 --requests 24 --mean-batch 32 --ladder 32,128

Runs on the GPU (`--device cuda`, the default); `--device cpu` runs the
same service on the CPU.

Synthesizes the paper's two-party fraud deployment (payment company holds
transaction features, merchant holds behavioural features), fits
`SecureKMeans` with the pooled offline phase, provisions a `TripleBank`
for the serving ladder, then drives a stream of ragged arrival batches
through `repro_torch.serve.ScoringService` — scoring every new transaction
against the SECRET-SHARED centroids and revealing only scores + outlier
flags. Reports per-phase latency, rows/s, triples and bytes per request.

`--bank-path` persists the provisioned bank to disk (np.savez) and reloads
it before serving — the cross-restart serving story. `--fit-from-bank`
provisions the FIT plan into the bank too (plan_fit) and fits from the
provisioned tranches, so the online fit does zero generation work;
`--provision-workers N` splits all provisioning across N threads
(bit-exact with serial — per-class streams).

`--serve-port` switches to WIRE-SERVER mode (DESIGN.md §14): fit
deterministically, warm, then listen for `ScoringClient` requests —
printing "SERVING <port>" once ready. With `--serve-checkpoint-dir` the
service journals every response (exactly-once across a kill/restart:
rerun the same command and it resumes from the journal);
`--die-after-responses N` crashes with os._exit right after the Nth
response journals (the chaos harness' kill switch). `--max-queue`,
`--deadline-s` and `--low-water`/`--high-water` configure admission,
deadlines and the background `BankReplenisher`.

`--supervised` (DESIGN.md §16) wraps wire-server mode in the restart
supervisor: the parent pins the serve/metrics ports, respawns the server
on crashes (bounded restarts, backoff, crash-loop detection), strips
crash-simulation flags after incarnation 0, and treats the `/health`
endpoint (or the "SERVING" line) as readiness. Combined with
`--serve-checkpoint-dir`, a crash-looping server still answers every
admitted request id exactly once. The supervising parent only spawns: it
never creates a CUDA context (it exits 5 if one appeared), and each
incarnation builds or loads the kernels before it fits.

The JAX package's launcher, option for option, plus `--device`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.core.fraud import FraudDataset, detect_outliers, jaccard
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.core.triples import TripleBank, serve_seed
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.serve import ScoringService


def _on_device(device: str) -> dict:
    """KMeansConfig keywords that run on `device`; on a GPU the kernels
    are built (or the cached build loaded) first."""
    import torch
    if torch.device(device).type != "cuda":
        return {"backend": "torch", "device": device}
    from repro_torch.kernels import _build
    _build.load()
    return {"backend": "cuda", "device": device}


def _finish_trace(trace_out: str | None, verbose: bool = True) -> None:
    """Export the global tracer's Chrome trace + text flame summary."""
    if not trace_out:
        return
    t = _trace.get_tracer()
    t.export_chrome(trace_out)
    if verbose:
        print(f"trace: {len(t.events())} spans -> {trace_out} "
              "(load in chrome://tracing or ui.perfetto.dev)")
        print(t.flame_summary())


def serve(*, n_train: int = 2000, d_a: int = 18, d_b: int = 24, k: int = 5,
          iters: int = 5, sparse: bool = False, rungs=(32, 128),
          requests: int = 24, mean_batch: int = 32, frac: float = 0.02,
          provision_copies: int | None = None, bank_path: str | None = None,
          pipeline: bool = True, fit_batch_size: int | None = None,
          fit_from_bank: bool = False, provision_workers: int = 1,
          checkpoint_dir: str | None = None, resume: bool = False,
          checkpoint_every: int = 1, seed: int = 0,
          trace_out: str | None = None,
          trace_rotate: int | None = None, trace_sample: float = 1.0,
          metrics_port: int | None = None,
          stats_interval: float = 0.0, verbose: bool = True,
          device: str = "cuda") -> dict:
    if trace_out:
        _trace.configure(enabled=True, process="serve_kmeans",
                         rotate_spans=trace_rotate,
                         sample_rate=trace_sample)
    ds = FraudDataset.synthesize(n=n_train, d_a=d_a, d_b=d_b,
                                 n_clusters=k, seed=seed)
    km = SecureKMeans(KMeansConfig(k=k, iters=iters, seed=seed,
                                   sparse=sparse, offline="pooled",
                                   batch_size=fit_batch_size,
                                   pipeline=pipeline, **_on_device(device)))
    t_provision_fit = 0.0
    fit_dealer = None
    if fit_from_bank:
        # offline: bulk-generate the whole fit's correlated randomness into
        # a bank keyed by the fit plan; the fit itself then does zero
        # generation work (bit-exact with the on-the-fly dealers)
        fit_bank = TripleBank(seed=seed, device=device)
        fkey, fplan, _ = km.plan_fit(ds.x_a.shape, ds.x_b.shape)
        t0 = time.perf_counter()
        fit_bank.provision(fkey, fplan, workers=provision_workers)
        t_provision_fit = time.perf_counter() - t0
        fit_dealer = fit_bank.dealer(fkey)
    ckpt = None
    if checkpoint_dir:
        from repro_torch.checkpoint.fit import FitCheckpointer
        ckpt = FitCheckpointer(checkpoint_dir, every=checkpoint_every)
    t0 = time.perf_counter()
    res = km.fit(ds.x_a, ds.x_b, dealer=fit_dealer, checkpoint=ckpt,
                 resume=resume)
    t_fit = time.perf_counter() - t0
    # callback gauges READ the live CommLog: the registry's answer for
    # online bytes is total_bytes("online") itself, not a second tally
    _metrics.register_commlog(res.log)
    mserver = None
    if metrics_port is not None:
        mserver = _metrics.MetricsServer(port=metrics_port)
        mserver.start()
        if verbose:
            print(f"METRICS {mserver.port}", flush=True)

    bank = TripleBank(seed=serve_seed(seed), device=device)
    svc = ScoringService(km, res, bank=bank, rungs=rungs,
                         with_scores=True, d_a=d_a, d_b=d_b,
                         pipeline=pipeline,
                         provision_copies=provision_copies or requests,
                         provision_workers=provision_workers)
    t0 = time.perf_counter()
    svc.warm()
    if bank_path:
        # persist the provisioned bank and serve from the reloaded copy —
        # stream positions survive, so replenishment stays deterministic
        bank.save(bank_path)
        svc.bank = TripleBank.load(bank_path, device=device)
    t_warm = time.perf_counter() - t0

    rng = np.random.default_rng(seed + 1)
    sizes = np.maximum(1, rng.poisson(mean_batch, requests))
    arrivals = FraudDataset.synthesize(n=int(sizes.sum()), d_a=d_a, d_b=d_b,
                                       n_clusters=k, seed=seed + 2)
    slog = None
    if stats_interval > 0:
        slog = _metrics.StatsLineLogger(svc, bank=svc.bank,
                                        interval_s=stats_interval)
        slog.start()
    off = 0
    for m in sizes:
        svc.submit(arrivals.x_a[off:off + m], arrivals.x_b[off:off + m])
        off += m
    t0 = time.perf_counter()
    responses = svc.drain()
    t_drain = time.perf_counter() - t0
    if slog is not None:
        slog.stop()
        if verbose:
            print(slog.render())
    if mserver is not None:
        mserver.stop()

    scores = np.concatenate([r.scores for r in responses])
    flags = detect_outliers(scores, frac)
    j = jaccard(flags, arrivals.y_outlier)

    out = {"fit_s": round(t_fit, 3), "warm_s": round(t_warm, 3),
           "drain_s": round(t_drain, 3), "jaccard_stream": round(j, 3),
           "bank_loaded_from_disk": bool(bank_path),
           "fit_from_bank": bool(fit_from_bank),
           "provision_fit_s": round(t_provision_fit, 3),
           "provision_workers": int(provision_workers)}
    out.update(svc.stats.as_dict())
    if verbose:
        if fit_from_bank:
            print(f"fit bank provisioned in {t_provision_fit:.2f}s "
                  f"({provision_workers} worker"
                  f"{'s' if provision_workers != 1 else ''}) — offline")
        print(f"fit {t_fit:.2f}s ({iters} iters, n={n_train})  "
              f"warm {t_warm:.2f}s (compile + provision "
              f"{'-> ' + bank_path if bank_path else ''})")
        print(f"served {out['requests']} requests / {out['rows']} rows "
              f"in {t_drain:.2f}s  ->  {out['rows_per_s']} rows/s")
        print(f"  {out['triples_per_request']} triples/request, "
              f"{out['bytes_per_request']} B/request, "
              f"pad x{out['pad_overhead']}, "
              f"{out['replenish_events']} replenish events")
        print(f"stream outlier Jaccard vs planted fraud: {j:.3f} "
              "(only scores/flags revealed — the model stays shared)")
    _finish_trace(trace_out, verbose)
    return out


def serve_wire(*, port: int = 0, auth_key: str | None = None,
               checkpoint_dir: str | None = None,
               die_after_responses: int | None = None,
               max_queue: int | None = None,
               deadline_s: float | None = None,
               low_water: int | None = None, high_water: int | None = None,
               idle_timeout_s: float = 120.0,
               n_train: int = 400, d_a: int = 6, d_b: int = 6, k: int = 3,
               iters: int = 2, rungs=(16, 64), provision_copies: int = 8,
               provision_workers: int = 1, seed: int = 0,
               trace_out: str | None = None,
               trace_rotate: int | None = None, trace_sample: float = 1.0,
               metrics_port: int | None = None,
               stats_interval: float = 0.0, device: str = "cuda") -> None:
    """Wire-server mode: fit (deterministic — a restart refits the same
    model from the same seed), warm, listen, serve until BYE. The serving
    randomness is NOT refit-dependent: with a checkpoint dir the bank is
    snapshotted at first warm and every restart reloads + realigns it, so
    responses are bit-exact across kills."""
    from repro_torch.core.channel import (SocketTransport, WireTimeout,
                                          session_key)
    from repro_torch.serve import ScoringServer

    if trace_out:
        _trace.configure(enabled=True, process="server",
                         rotate_spans=trace_rotate,
                         sample_rate=trace_sample)
    ds = FraudDataset.synthesize(n=n_train, d_a=d_a, d_b=d_b,
                                 n_clusters=k, seed=seed)
    km = SecureKMeans(KMeansConfig(k=k, iters=iters, seed=seed,
                                   offline="pooled", **_on_device(device)))
    res = km.fit(ds.x_a, ds.x_b)
    _metrics.register_commlog(res.log)

    ckpt = None
    if checkpoint_dir:
        from repro_torch.checkpoint.serve import ServeCheckpointer
        after = None
        if die_after_responses is not None:

            def after(total, _path):
                if total >= die_after_responses:
                    print(f"DYING after {total} journaled responses",
                          flush=True)
                    os._exit(17)   # simulated crash: no cleanup, no BYE
        ckpt = ServeCheckpointer(checkpoint_dir, after_record=after)
    repl = None
    if low_water is not None:
        repl = {"low_water": low_water, "workers": provision_workers}
        if high_water is not None:
            repl["high_water"] = high_water
    svc = ScoringService(km, res, rungs=rungs, with_scores=True,
                         d_a=d_a, d_b=d_b,
                         provision_copies=provision_copies,
                         provision_workers=provision_workers,
                         max_queue=max_queue, default_deadline_s=deadline_s,
                         checkpointer=ckpt, replenisher=repl)
    # start the exposition BEFORE warm() so a supervisor probing /health
    # sees STARTING during bank load + journal replay, READY only after
    mserver = None
    if metrics_port is not None:
        mserver = _metrics.MetricsServer(port=metrics_port,
                                         health_cb=lambda: svc.health)
        mserver.start()
        print(f"METRICS {mserver.port}", flush=True)
    svc.warm()
    slog = None
    if stats_interval > 0:
        slog = _metrics.StatsLineLogger(svc, bank=svc.bank,
                                        interval_s=stats_interval)
        slog.start()
    t = SocketTransport("listen", port=port, io_timeout_s=idle_timeout_s)
    print(f"SERVING {t.port}", flush=True)
    server = ScoringServer(
        svc, t, idle_timeout_s=idle_timeout_s,
        auth_key=session_key(auth_key) if auth_key else None)
    try:
        responder = server.serve_forever()
        print(f"served {responder.served} wire requests "
              f"({responder.dedup_replays} dedup replays); "
              f"stats: {svc.stats.as_dict()}", flush=True)
    except WireTimeout as e:
        print(f"server idle timeout: {e}", flush=True)
    finally:
        if slog is not None:
            slog.stop()
            print(slog.render(), flush=True)
        if mserver is not None:
            mserver.stop()
        t.close()
        _finish_trace(trace_out)


_RUNBOOK = """\
ops runbook (self-healing serving, DESIGN.md §16)
-------------------------------------------------
health states on http://HOST:METRICS_PORT/health —
  STARTING  warm() in progress: bank loading, journal replaying,
            programs compiling. /health answers 503; wait.
  READY     serving. /health answers 200; the supervisor marks the
            incarnation ready and the MTTR clock stops.
  DEGRADED  still serving, but the drain loop or the BankReplenisher
            has swallowed errors (or the daemon died). Check
            repro_serve_* + repro_replenisher_* gauges, then restart
            at a quiet moment — the journal makes restarts safe.
  DRAINING  stop() is flushing the queue. New work should go elsewhere.

restart decision table —
  exit 0    clean (client sent BYE / idle timeout): do not restart.
  exit 4    ResumeMismatch: config/data fingerprint drifted between the
            parties. Restarting CANNOT help — fix the config, or move
            --serve-checkpoint-dir / --checkpoint-dir aside to accept a
            fresh run.
  exit 17   injected/simulated crash (chaos harness): restart; with
            --serve-checkpoint-dir the journal replays and every
            admitted request id is answered exactly once.
  other     crash: restart with the SAME command line. --supervised
            does this for you (bounded restarts, exponential backoff,
            crash-loop detection after 3 fast deaths).

what survives a crash —
  bank.npz              provision-time snapshot, never rewritten.
  journal/batch_*.npz   published responses + cumulative consumed
                        counts; replayed verbatim on restart.
  Anything not journaled is re-scored BIT-EXACT after bank realignment.
"""


def run_supervised(argv: list[str]) -> int:
    """Wrap wire-server mode in the restart supervisor: pin the ports so
    every incarnation listens at the same address, strip crash-simulation
    flags after incarnation 0, respawn per the RestartPolicy, and exit
    with the child's terminal returncode."""
    import torch

    from repro_torch.launch.supervisor import (RestartPolicy,
                                               SupervisedChild, child_env,
                                               free_port, python_argv)

    def _flag(name, default=None):
        return argv[argv.index(name) + 1] if name in argv else default

    def _pin(name, value):
        if name in argv:
            argv[argv.index(name) + 1] = str(value)
        else:
            argv.extend([name, str(value)])

    if _flag("--serve-port") in (None, "0"):
        _pin("--serve-port", free_port())
    if _flag("--metrics-port") == "0":
        _pin("--metrics-port", free_port())
    metrics_port = _flag("--metrics-port")
    health_url = (f"http://127.0.0.1:{metrics_port}/health"
                  if metrics_port else None)

    def argv_for(incarnation: int) -> list[str]:
        child = list(argv)
        if incarnation > 0 and "--die-after-responses" in child:
            i = child.index("--die-after-responses")
            del child[i:i + 2]      # the crash switch fires once, not forever
        return python_argv("repro_torch.launch.serve_kmeans", *child)

    child = SupervisedChild(
        "serve", argv_for, policy=RestartPolicy(),
        terminal_codes=(0, 4), env=child_env(),
        ready_pattern=r"^SERVING ", health_url=health_url,
        on_line=lambda line: print(line, flush=True))
    child.start()
    child.wait()
    print(f"SUPERVISOR terminal: {child.terminal_reason} "
          f"(rc={child.returncode}, restarts={child.restarts})", flush=True)
    # the parent only spawns: a CUDA context here would hold device memory
    # across every incarnation
    cuda = torch.cuda.is_initialized()
    print("SUPERVISOR_STATS " + json.dumps({
        "restarts": child.restarts,
        "restart_latencies": child.restart_latencies(),
        "events": [[e.kind, e.t, e.incarnation] for e in child.events],
        "cuda_initialized": cuda}), flush=True)
    if cuda:
        return 5
    return child.returncode if child.returncode is not None else 1


def main() -> None:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=_RUNBOOK)
    ap.add_argument("--device", default="cuda",
                    help="where the fit and the service run (cuda, or cpu)")
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--d-a", type=int, default=18)
    ap.add_argument("--d-b", type=int, default=24)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--rungs", "--ladder", dest="rungs", default="32,128",
                    help="comma-separated padded batch rungs (strictly "
                         "increasing positive ints)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--mean-batch", type=int, default=32)
    ap.add_argument("--frac", type=float, default=0.02)
    ap.add_argument("--provision-copies", type=int, default=None,
                    help="launches of correlated randomness provisioned "
                         "per rung (default: --requests; wire mode: 8)")
    ap.add_argument("--bank-path", default=None,
                    help="save + reload the provisioned TripleBank here")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="sequential escape hatch: disable the overlap of "
                         "request t+1's exchange/bank draw with request "
                         "t's launch (stream-identical outputs)")
    ap.add_argument("--fit-batch-size", type=int, default=None,
                    help="minibatch Lloyd batch rows for the fit "
                         "(default: full batch)")
    ap.add_argument("--fit-from-bank", action="store_true",
                    help="pre-provision the fit plan into a TripleBank "
                         "(offline) and fit from it — zero online "
                         "generation work")
    ap.add_argument("--provision-workers", type=int, default=1,
                    help="thread-pool width for bulk provisioning "
                         "(bit-exact with serial)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save a resumable FitCheckpoint here at iteration "
                         "boundaries (atomic keep-N store)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the fit from the latest checkpoint in "
                         "--checkpoint-dir (bit-exact with an "
                         "uninterrupted run)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="checkpoint every Nth iteration")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serve-port", type=int, default=None,
                    help="wire-server mode: listen here (0 = ephemeral, "
                         "printed as 'SERVING <port>') and answer "
                         "ScoringClient requests until BYE")
    ap.add_argument("--auth-key", default=None,
                    help="wire mode: shared session passphrase — frames "
                         "carry a keyed BLAKE2b MAC instead of a CRC")
    ap.add_argument("--serve-checkpoint-dir", default=None,
                    help="wire mode: journal responses + bank consumed "
                         "counts here (exactly-once restart)")
    ap.add_argument("--die-after-responses", type=int, default=None,
                    help="wire mode: os._exit right after this many "
                         "responses journal (crash simulation)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission high-water mark: shed past this depth")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline")
    ap.add_argument("--low-water", type=int, default=None,
                    help="start a BankReplenisher daemon topping up rungs "
                         "at this stock level")
    ap.add_argument("--high-water", type=int, default=None,
                    help="replenisher top-up target (default 2x low)")
    ap.add_argument("--idle-timeout", type=float, default=120.0,
                    help="wire mode: give up after this much client "
                         "silence")
    ap.add_argument("--supervised", action="store_true",
                    help="wire mode: run the server under the restart "
                         "supervisor (pin ports, respawn on crash, strip "
                         "--die-after-responses after incarnation 0)")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing and export a Chrome-trace / "
                         "Perfetto JSON timeline here on exit")
    ap.add_argument("--trace-rotate", type=int, default=None,
                    help="keep only the newest N spans per category "
                         "(bounded-memory tracing for long-lived servers)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="record ~this fraction of spans (deterministic "
                         "counter sampling; 1.0 = everything)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the Prometheus text exposition on this "
                         "port (0 = ephemeral, printed as "
                         "'METRICS <port>')")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="log a one-line stats summary (latency quantiles "
                         "+ bank_stock) every this many seconds")
    args = ap.parse_args()
    if args.supervised:
        import sys
        if args.serve_port is None:
            ap.error("--supervised requires wire mode (--serve-port)")
        argv = [a for a in sys.argv[1:] if a != "--supervised"]
        raise SystemExit(run_supervised(argv))
    if args.serve_port is not None:
        serve_wire(port=args.serve_port, auth_key=args.auth_key,
                   checkpoint_dir=args.serve_checkpoint_dir,
                   die_after_responses=args.die_after_responses,
                   max_queue=args.max_queue, deadline_s=args.deadline_s,
                   low_water=args.low_water, high_water=args.high_water,
                   idle_timeout_s=args.idle_timeout,
                   n_train=args.n_train, d_a=args.d_a, d_b=args.d_b,
                   k=args.k, iters=args.iters,
                   rungs=tuple(int(r) for r in args.rungs.split(",")),
                   provision_copies=args.provision_copies or 8,
                   provision_workers=args.provision_workers,
                   seed=args.seed, trace_out=args.trace_out,
                   trace_rotate=args.trace_rotate,
                   trace_sample=args.trace_sample,
                   metrics_port=args.metrics_port,
                   stats_interval=args.stats_interval, device=args.device)
        return
    serve(n_train=args.n_train, d_a=args.d_a, d_b=args.d_b, k=args.k,
          iters=args.iters, sparse=args.sparse,
          rungs=tuple(int(r) for r in args.rungs.split(",")),
          requests=args.requests, mean_batch=args.mean_batch,
          frac=args.frac, provision_copies=args.provision_copies,
          bank_path=args.bank_path,
          pipeline=not args.no_pipeline,
          fit_batch_size=args.fit_batch_size,
          fit_from_bank=args.fit_from_bank,
          provision_workers=args.provision_workers,
          checkpoint_dir=args.checkpoint_dir, resume=args.resume,
          checkpoint_every=args.checkpoint_every, seed=args.seed,
          trace_out=args.trace_out, trace_rotate=args.trace_rotate,
          trace_sample=args.trace_sample, metrics_port=args.metrics_port,
          stats_interval=args.stats_interval, device=args.device)


if __name__ == "__main__":
    main()
