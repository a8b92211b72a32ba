"""The driver of the `lloyd` traffic: the secure Lloyd iteration of
repro_torch, chained, in one deployment.

Set-up: the data and the start from the seed on the device; the S1/S3
programs (`launch/kmeans_step.py:fit_programs`, recorded on zeros at the
cell's shapes, which launches every kernel at them); one iteration's
offline list from the port's TrustedDealer; warm-up iterations. The
window: S1 then S3, back to back with no synchronize, the centroid shares
chained from each iteration into the next, every iteration consuming the
same offline list, until the seconds are up; one synchronize ends it. The
online work is the same word for word whichever list it consumes; a fresh
list for each iteration does not fit on the card. The traced run then
profiles a slice of further iterations. Last, the reference runs Lloyd
from the same data and start for as many iterations, and judges the last
iteration's revealed assignment and centroids.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch

from bench import data, devtrace, reference, spy


def fit_programs(cfg: dict, device, backend: str):
    from repro_torch.launch import kmeans_step as KS
    return KS.fit_programs(cfg["partition"], False,
                           (cfg["n"], cfg["d_a"]),
                           (cfg["n"], cfg["d"] - cfg["d_a"]), cfg["k"],
                           backend=backend, device=device)


# what a configuration may state for the lloyd traffic: the driver runs
# the dense protocol on the vertical partition over Z_2^64 with f = 20
STATES = {"partition": "vertical", "protocol": "dense", "ring_bits": 64,
          "frac_bits": data.FRAC_BITS}


def check(cfg: dict) -> None:
    """Refuse a configuration that states another deployment than the one
    this driver runs and judges."""
    for key, want in STATES.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"the lloyd traffic runs {key} = {want!r}; "
                             f"the configuration states {cfg[key]!r}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device="cuda", backend="cuda", t0: float | None = None,
        make_programs=None) -> dict:
    """One run of a cell. Returns the record the metric readers read:
    setup_s, dealer_s, iters (in the window), window_s, peak_bytes,
    online_bytes, attempted, the judge's verdict and, traced, the slice's
    iterations, their S1 and S3 event times, the shapes the kernels were
    called with and the reduced device trace. `make_programs(xa, xb,
    seed)` puts another pair of programs in the port's place."""
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.launch import kmeans_step as KS
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    check(cfg)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    n, d, k, d_a = cfg["n"], cfg["d"], cfg["k"], cfg["d_a"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words, lab = data.blobs(gen, n, d, k, dict(
        traffic["data"], sparsity=cfg.get("sparsity", 0.0)), device)
    start = words[data.first_of_each(lab, k)].clone()
    xa, xb = words[:, :d_a].contiguous(), words[:, d_a:].contiguous()
    del words, lab
    mu0, mu1 = data.shares(gen, start)

    progs = (make_programs(xa, xb, seed) if make_programs is not None
             else fit_programs(cfg, device, backend))
    _sync(device)
    t_deal = time.perf_counter()
    dealer = TrustedDealer(seed=seed, device=device)
    flat1 = KS.materialize_offline(progs.s1_requests, dealer)
    flat3 = KS.materialize_offline(progs.s3_requests, dealer)
    _sync(device)
    dealer_s = time.perf_counter() - t_deal

    def s1(m0, m1):
        return progs.s1(xa, xb, m0, m1, *flat1)

    def s3(m0, m1, c0, c1):
        return progs.s3(xa, xb, m0, m1, c0, c1, *flat3)

    def step(m0, m1):
        c0, c1 = s1(m0, m1)
        return (c0, c1) + tuple(s3(m0, m1, c0, c1))

    tally: dict = {}
    with spy.count_online_bytes(tally):
        c0, c1, mu0, mu1 = step(mu0, mu1)
    done = 1
    for _ in range(int(traffic["warmup_iters"]) - 1):
        c0, c1, mu0, mu1 = step(mu0, mu1)
        done += 1
    _sync(device)
    rec = {"setup_s": time.perf_counter() - t0, "dealer_s": dealer_s,
           "online_bytes": tally.get("bytes", 0)}

    with spy.KernelSpy() if trace and cuda else nullcontext() as kspy:
        t_win = time.perf_counter()
        iters = 0
        while True:
            c0, c1, mu0, mu1 = step(mu0, mu1)
            iters += 1
            if time.perf_counter() - t_win >= seconds:
                break
        _sync(device)
        rec["window_s"] = time.perf_counter() - t_win
        rec["iters"] = iters
        done += iters
        if trace:
            c0, c1, mu0, mu1, sl = _traced_slice(
                s1, s3, (mu0, mu1), int(traffic["trace_iters"]), device,
                kspy)
            done += sl.pop("done")
            rec.update(sl)
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    labels = reference.reveal_labels(c0, c1)
    cents = reference.reveal_centroids(mu0, mu1)
    del c0, c1, mu0, mu1, flat1, flat3, progs, dealer
    KS.clear_program_cache()
    want_labels, want_cents = reference.lloyd(xa, xb, start, done)
    rec["attempted"] = done
    rec["verdict"] = reference.judge(labels, cents, want_labels, want_cents,
                                     limits)
    return rec


def _traced_slice(s1, s3, mu, iters: int, device, kspy) -> tuple:
    """`iters` iterations under torch.profiler, each timed at S1 and S3 by
    CUDA events, inside the `bench.window` range that a synchronize opens
    and closes; one iteration before it warms the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    mu0, mu1 = mu
    marks = []
    with profile(activities=acts) as prof:
        c0, c1 = s1(mu0, mu1)
        mu0, mu1 = s3(mu0, mu1, c0, c1)
        _sync(device)
        if kspy is not None:
            kspy.recording = True
        with record_function(devtrace.WINDOW):
            for _ in range(iters):
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(3)] if cuda else None
                if cuda:
                    ev[0].record()
                with record_function("bench.s1"):
                    c0, c1 = s1(mu0, mu1)
                if cuda:
                    ev[1].record()
                with record_function("bench.s3"):
                    mu0, mu1 = s3(mu0, mu1, c0, c1)
                if cuda:
                    ev[2].record()
                marks.append(ev)
            _sync(device)
        if kspy is not None:
            kspy.recording = False
    out = {"done": iters + 1, "trace_iters": iters}
    if cuda:
        out["s1_s"] = sum(e[0].elapsed_time(e[1]) for e in marks) / 1e3
        out["s3_s"] = sum(e[1].elapsed_time(e[2]) for e in marks) / 1e3
    out["trace"] = devtrace.reduce(devtrace.export(prof),
                                   tuple(spy.RANGES.values()))
    if kspy is not None:
        out["mm_shapes"], out["ks_numels"] = kspy.mm, kspy.ks
    return c0, c1, mu0, mu1, out
