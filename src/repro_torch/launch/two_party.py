"""Two-PROCESS secure k-means: the fit and predict protocols over a real
TCP socket.

    # party A (engine) — binds, prints "LISTENING <port>", runs the fit on
    # the GPU (--device cpu for the CPU)
    PYTHONPATH=src python -m repro_torch.launch.two_party --role A \
        --port 0 --out a.npz
    # party B (responder) — dials A and answers the wire until BYE
    PYTHONPATH=src python -m repro_torch.launch.two_party --role B \
        --port <port>

Deployment shape: the repo's engine simulates BOTH parties' protocol
state in one process (core/protocol.py), so party A hosts the joint
simulation while party B is a pure wire peer — it ships its data slice
on request (a real length-prefixed blob over TCP), then echoes the
online protocol's exchange frames (core/channel.serve_peer). Every byte
and round the CommLog tallies is carried by a real frame with sequence
number and CRC, so a socket fit's shares AND accounting are bit-exact
against the in-process fit. Party B never touches a tensor on the device
(it reports `torch.cuda.is_initialized()` and fails if it is set), and its
frames are the JAX package's, so either package's B serves either's A.

`--die-at-iter N` kills party A with os._exit right after the iteration-N
checkpoint publishes (requires --checkpoint-dir) — the crash half of the
checkpoint/resume acceptance test; rerunning with --resume (fresh B)
finishes bit-exact against an uninterrupted run.

Self-healing mode: `--auto-resume` makes party A
negotiate the resume step with B on every start — it announces a fresh
incarnation nonce (resetting B's dedup window so the new sequence space
isn't mistaken for stale duplicates), exchanges latest published
checkpoint step + config fingerprint, and resumes from `min(step)` with
no operator action; `--state-dir` gives B a durable progress marker so
the negotiation survives B's own crashes; `--peer-wait S` parks either
side through a supervised peer restart instead of dying. `--die-at
point[:nth]` arms the chaos kill-points (core/faultpoints.py) and
`--fault-*` inject deterministic wire faults. `--trace-out FILE` records
this role's spans and exports them as Chrome-trace JSON on exit (merge
both roles' files with `repro_torch.obs.merge_traces`).

Party A builds the CUDA kernels before the fit starts, so a kill-point
never lands mid-build (a build is published atomically either way).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import faultpoints, ring
from repro_torch.core.channel import (FaultyTransport, PeerProgress,
                                      ReliableChannel, ResumeMismatch,
                                      SocketTransport, WireSession,
                                      WireTimeout, serve_peer, session_key)
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.obs import trace as _trace


def _trace_setup(args) -> None:
    if args.trace_out:
        _trace.configure(enabled=True,
                         process=f"party_{args.role.lower()}")


def _trace_finish(args) -> None:
    if args.trace_out:
        t = _trace.get_tracer()
        t.export_chrome(args.trace_out)
        print(f"{args.role}: trace {len(t.events())} spans -> "
              f"{args.trace_out}", flush=True)


def make_data(n: int, d: int, k: int, seed: int,
              sparse_frac: float = 0.0) -> np.ndarray:
    """Deterministic gaussian blobs (optionally sparsified) — the shared
    generator both parties AND the in-process reference fit use, so the
    only thing the wire changes is where the bytes travel."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(k, d))
    x = centers[rng.integers(0, k, size=n)] + rng.normal(size=(n, d))
    if sparse_frac > 0:
        x = np.where(rng.random(x.shape) < sparse_frac, 0.0, x)
    return x


def split_data(x: np.ndarray, partition: str) -> tuple:
    n, d = x.shape
    if partition == "vertical":
        return x[:, :d // 2], x[:, d // 2:]
    return x[:n // 2], x[n // 2:]


def _auth(args) -> bytes | None:
    return session_key(args.auth_key) if args.auth_key else None


def _wrap_faults(t, args):
    """Apply the CLI's deterministic fault schedule to a transport.
    FaultyTransport delegates `.stats` to the inner transport, so the
    wire accounting below keeps reading the same counters."""
    sever = tuple(int(s) for s in
                  (args.fault_sever_at or "").split(",") if s.strip())
    if not (args.fault_drop or args.fault_dup or args.fault_corrupt
            or sever):
        return t
    return FaultyTransport(t, seed=args.fault_seed, drop=args.fault_drop,
                           dup=args.fault_dup, corrupt=args.fault_corrupt,
                           sever_at=sever)


def _wire_stats_line(role: str, t, extra: dict | None = None) -> None:
    """One machine-parsable line the chaos bench totals across
    incarnations (the DYING line carries the same dict for killed ones)."""
    d = {"role": role, "frames_sent": int(t.stats.frames_sent),
         "frames_recv": int(t.stats.frames_recv),
         "wire_bytes_sent": int(t.stats.wire_bytes_sent),
         "reconnects": int(t.stats.reconnects)}
    d.update(extra or {})
    print("WIRE_STATS " + json.dumps(d, sort_keys=True), flush=True)


def _launches() -> dict:
    """The kernel wrappers' launch counters (0 on the CPU)."""
    from repro_torch.kernels import ksadder, modmatmul, spmm
    return {"ring_matmul": modmatmul.LAUNCHES,
            "ks_carry_share": ksadder.LAUNCHES, "spmm_ell": spmm.LAUNCHES}


def _party_b(args) -> None:
    _trace_setup(args)
    if args.die_at:
        faultpoints.arm(args.die_at)
    t = SocketTransport("connect", host=args.host, port=args.port,
                        io_timeout_s=args.io_timeout)
    ft = _wrap_faults(t, args)
    faultpoints.set_reporter(lambda: {
        "role": "B", "frames_sent": int(t.stats.frames_sent),
        "frames_recv": int(t.stats.frames_recv),
        "wire_bytes_sent": int(t.stats.wire_bytes_sent)})

    progress = None
    if args.state_dir:
        os.makedirs(args.state_dir, exist_ok=True)
        progress = PeerProgress(os.path.join(args.state_dir,
                                             "peer_progress.json"))
        if progress.step >= 0:
            print(f"B: resuming with recorded step {progress.step}",
                  flush=True)

    def on_blob(meta, arrays):
        if meta.get("op") != "get_slice":
            raise ValueError(f"unknown blob op {meta!r}")
        x = make_data(int(meta["n"]), int(meta["d"]), int(meta["k"]),
                      int(meta["seed"]), float(meta["sparse_frac"]))
        _, x_b = split_data(x, meta["partition"])
        return {"op": "slice"}, {"x_b": x_b}

    # the idle budget doubles as the bounded reconnect-wait: while the
    # a supervisor restarts a crashed engine, B parks in its reconnect loop
    # and only gives up once TOTAL silence exceeds the budget
    park = args.peer_wait if args.peer_wait else args.io_timeout
    try:
        stats = serve_peer(ft, on_blob=on_blob,
                           idle_timeout_s=max(args.io_timeout, park),
                           auth_key=_auth(args), progress=progress)
    except WireTimeout as e:
        # engine crashed or unreachable past the idle budget: exit with a
        # clear diagnostic (its checkpoint-resume relaunches a fresh B)
        print(f"B: giving up — {e}", flush=True)
        ft.close()
        raise SystemExit(3)
    print(f"B: served {stats.served} requests, "
          f"{stats.dedup_replays} dedup replays", flush=True)
    cuda = torch.cuda.is_initialized()
    _wire_stats_line("B", t, {"served": int(stats.served),
                              "incarnation_resets":
                              int(stats.incarnation_resets),
                              "cuda_initialized": bool(cuda)})
    ft.close()
    _trace_finish(args)
    if cuda:
        print("B: a CUDA context was created; the wire peer must not touch "
              "the device", flush=True)
        raise SystemExit(5)


def _party_a(args) -> None:
    _trace_setup(args)
    device = torch.device(args.device)
    if device.type == "cuda":
        # build (or load) every kernel before a kill-point can fire
        from repro_torch.kernels import _build
        _build.load()
    if args.die_at:
        faultpoints.arm(args.die_at)
    t = SocketTransport("listen", host=args.host, port=args.port,
                        io_timeout_s=args.io_timeout)
    print(f"LISTENING {t.port}", flush=True)
    ft = _wrap_faults(t, args)
    chan = ReliableChannel(ft, deadline_s=args.io_timeout,
                           auth_key=_auth(args),
                           reconnect_wait_s=args.peer_wait)
    # the incarnation nonce distinguishes THIS process from any earlier
    # one on the same port: B resets its dedup window when it changes
    inc = f"{os.getpid()}-{time.time_ns()}"
    ws = WireSession(chan, incarnation=inc)
    faultpoints.set_reporter(lambda: {
        "role": "A", "frames_sent": int(t.stats.frames_sent),
        "frames_recv": int(t.stats.frames_recv),
        "wire_bytes_sent": int(t.stats.wire_bytes_sent),
        "retries": int(chan.retries), "reconnects": int(chan.reconnects)})

    if args.auto_resume:
        # announce the incarnation FIRST: a restarted engine's sequence
        # space restarts at 0, which B would stale-drop until the reset
        ws.negotiate_resume(step=-1, fingerprint=None)

    x = make_data(args.n, args.d, args.k, args.seed, args.sparse_frac)
    x_a, x_b_local = split_data(x, args.partition)
    # B's slice arrives over the wire — the engine never recomputes it
    meta, arrays = ws.send_arrays(
        {"op": "get_slice", "n": args.n, "d": args.d, "k": args.k,
         "seed": args.seed, "sparse_frac": args.sparse_frac,
         "partition": args.partition}, {})
    x_b = arrays["x_b"]
    assert x_b.shape == x_b_local.shape, "peer slice geometry mismatch"

    cfg = KMeansConfig(k=args.k, iters=args.iters, seed=args.seed,
                       partition=args.partition,
                       sparse=args.sparse_frac > 0,
                       batch_size=args.batch_size,
                       offline=args.offline,
                       pipeline=not args.no_pipeline,
                       backend="cuda" if device.type == "cuda" else "torch",
                       device=args.device)
    km = SecureKMeans(cfg)
    ckpt = None
    fp = None
    if args.checkpoint_dir:
        from repro_torch.checkpoint.fit import FitCheckpointer

        fp = km._fit_fingerprint(x_a.shape, x_b.shape)

        def after_save(state, _path):
            if args.auto_resume:
                # tell B the step is published BEFORE any scripted death:
                # notify-then-die and die-before-notify are both safe (B
                # lagging only makes the agreed step older), but notifying
                # eagerly keeps MTTR low — the restart resumes at min()
                ws.notify_publish(state.step, fp)
            if args.die_at_iter is not None \
                    and state.iteration >= args.die_at_iter \
                    and state.batch == 0:
                print(f"DYING at iteration {state.iteration} "
                      "(post-checkpoint)", flush=True)
                # simulated crash: no cleanup, no BYE
                os._exit(faultpoints.KILL_EXIT_CODE)

        ckpt = FitCheckpointer(args.checkpoint_dir,
                               every=args.checkpoint_every,
                               fingerprint=fp,
                               after_save=after_save)
    resume_step = None
    if args.auto_resume:
        if ckpt is None:
            raise SystemExit("--auto-resume requires --checkpoint-dir")
        my_step = max(ckpt.all_steps(), default=-1)
        resume_step = ws.negotiate_resume(step=my_step, fingerprint=fp)
        print(f"A: negotiated resume step {resume_step} "
              f"(ours {my_step})", flush=True)
    l0 = _launches()
    t0 = time.perf_counter()
    res = km.fit(x_a, x_b, wire=ws, checkpoint=ckpt, resume=args.resume,
                 resume_step=resume_step)
    fit_s = time.perf_counter() - t0
    l1 = _launches()
    fit_bytes, fit_rounds = ws.payload_bytes, ws.rounds

    # score a fresh arrival batch over the same session
    arr = make_data(args.predict_n, args.d, args.k, args.seed + 1,
                    args.sparse_frac)
    pa, pb = split_data(arr, args.partition)
    pred = km.predict(pa, pb, wire=ws)

    d = res.log.by_tag("online")
    meta = {
        "counters": {a: int(getattr(res.dealer, a))
                     for a in ("n_matmul", "n_mul", "n_bin")},
        "fit_online": {k_: [int(v[0]), int(v[1])] for k_, v in d.items()},
        "predict_online": {k_: [int(v[0]), int(v[1])]
                           for k_, v in pred.log.by_tag("online").items()},
        "wire_payload_bytes": int(ws.payload_bytes),
        "wire_rounds": int(ws.rounds),
        "frames_sent": int(t.stats.frames_sent),
        "wire_bytes_sent": int(t.stats.wire_bytes_sent),
        "fit_offline": {k_: [int(v[0]), int(v[1])]
                        for k_, v in res.log.by_tag("offline").items()},
        "fit_wire_payload_bytes": int(fit_bytes),
        "fit_wire_rounds": int(fit_rounds),
        "wire_bytes_recv": int(t.stats.wire_bytes_recv),
        "iters_run": int(res.iters_run),
        "fit_seconds": fit_s,
        "offline_dealer_seconds": res.offline_dealer_seconds,
        "offline_plan_seconds": res.offline_plan_seconds,
        "retries": int(chan.retries),
        "fit_launches": {n: l1[n] - l0[n] for n in l0},
    }
    if args.out:
        np.savez(args.out,
                 mu0=ring.to_u64_numpy(res.centroids.s0),
                 mu1=ring.to_u64_numpy(res.centroids.s1),
                 c0=ring.to_u64_numpy(res.assignment.s0),
                 c1=ring.to_u64_numpy(res.assignment.s1),
                 p0=ring.to_u64_numpy(pred.assignment.s0),
                 p1=ring.to_u64_numpy(pred.assignment.s1),
                 meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    print(f"A: fit+predict done, wire {ws.payload_bytes} payload bytes / "
          f"{ws.rounds} rounds over {t.stats.frames_sent} frames",
          flush=True)
    _wire_stats_line("A", t, {"retries": int(chan.retries),
                              "reconnects": int(chan.reconnects)})
    ws.bye()
    ft.close()
    _trace_finish(args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("A", "B"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="A: where the fit runs (cuda, or cpu); B never "
                         "touches a device")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="A: listen port (0 = ephemeral, printed); "
                         "B: A's port")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--predict-n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--partition", choices=("vertical", "horizontal"),
                    default="vertical")
    ap.add_argument("--sparse-frac", type=float, default=0.0)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--offline",
                    choices=("on_demand", "pooled", "streamed"),
                    default="on_demand")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--io-timeout", type=float, default=60.0)
    ap.add_argument("--auth-key", default=None,
                    help="shared session passphrase: frames carry a keyed "
                         "BLAKE2b MAC instead of a CRC (both roles must "
                         "agree; tampered/unkeyed frames are dropped)")
    ap.add_argument("--out", default=None,
                    help="A: write result shares + accounting npz here")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--die-at-iter", type=int, default=None,
                    help="A: os._exit right after this iteration's "
                         "checkpoint publishes (crash simulation)")
    ap.add_argument("--die-at", default=None,
                    help="arm chaos kill-points: comma-separated "
                         "point[:nth] (e.g. fit.mid_s1:4, wire.serve:20); "
                         "the process hard-exits at the Nth hit")
    ap.add_argument("--auto-resume", action="store_true",
                    help="A: negotiate the resume step with B on start "
                         "(incarnation announce + min(step) agreement); "
                         "requires --checkpoint-dir")
    ap.add_argument("--state-dir", default=None,
                    help="B: durable progress-marker directory for the "
                         "resume negotiation")
    ap.add_argument("--peer-wait", type=float, default=0.0,
                    help="park budget (s): survive a peer crash+restart "
                         "this long instead of dying (A: per-request "
                         "reconnect wait; B: extends the idle budget)")
    ap.add_argument("--fault-drop", type=float, default=0.0)
    ap.add_argument("--fault-dup", type=float, default=0.0)
    ap.add_argument("--fault-corrupt", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-sever-at", default=None,
                    help="comma-separated send indices at which to tear "
                         "the connection down (deterministic)")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing; export this role's "
                         "Chrome-trace JSON here on exit (merge A+B "
                         "files with repro_torch.obs.merge_traces)")
    args = ap.parse_args(argv)
    try:
        if args.role == "B":
            if args.port == 0:
                ap.error("role B needs A's --port")
            _party_b(args)
        else:
            _party_a(args)
    except ResumeMismatch as e:
        # terminal: a config mismatch can't be fixed by restarting, so
        # a supervisor must NOT respawn on this exit code
        print(f"{args.role}: RESUME MISMATCH — {e}", flush=True)
        raise SystemExit(4)


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:
        sys.exit(1)
