"""The readers of the program's spans (bench/progspans.py and the metrics
enqueue_ms, tournament_ms, s3_finalize_ms, beaver_ms) on a tracer filled
by hand, and, marked `cuda` (it skips without a GPU), a program span's
device interval against CUDA events around the same call. On the card:
    PYTHONPATH=src python -m pytest -m cuda bench/test_bench_spans.py"""
import itertools

import pytest
import torch

from bench import harness, lloyd
from repro_torch.core.triples import TrustedDealer
from repro_torch.launch import kmeans_step as KS
from repro_torch.obs import trace

METRICS = ("enqueue_ms", "tournament_ms", "s3_finalize_ms", "beaver_ms")
IDS = itertools.count(1)


class Stamp:
    """A CUDA event as the tracer reads one: passed, at `ms`."""

    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.ms - self.ms


def fill(t, iters, scale, device=True):
    """`iters` iterations of one prog.s1 / prog.s3 pair, each with host
    durations (us) and device intervals (ms) times `scale`."""

    def rec(name, parent, dur_us, dev_ms=None, **args):
        i = next(IDS)
        dev = (Stamp(0.0), Stamp(dev_ms * scale)) \
            if device and dev_ms is not None else None
        t._record(name, i, dur_us * scale, args, i, parent, dev)
        return i

    for _ in range(iters):
        s1 = rec("prog.s1", None, 1000)
        d = rec("s1.distances", s1, 400, 2.0)
        rec("beaver.open", d, 10, 0.5, kind="matmul", triples=1)
        rec("beaver.combine", d, 10, 1.0, kind="matmul")
        tour = rec("s2.tournament", s1, 500, 3.0)
        lv = rec("s2.level", tour, 200, 1.5, level=1, pairs=8)
        rec("beaver.open", lv, 10, 0.25, kind="ks", triples=7)
        s3 = rec("prog.s3", None, 3000)
        fin = rec("s3.finalize", s3, 2500, 4.0)
        rec("beaver.combine", rec("s3.reciprocal", fin, 2000, 3.5), 5, 0.125,
            kind="mul")
        rec("prog.other", None, 7, 9.0)


@pytest.fixture
def tracer(monkeypatch):
    t = trace.Tracer()
    monkeypatch.setattr(trace, "get_tracer", lambda: t)
    return t


def read_all(rec):
    return {m: harness.reader(m)(rec) for m in METRICS}


def test_readers_take_the_last_iterations(tracer):
    fill(tracer, 1, 100.0)     # the profiler's warm-up iteration, far off
    fill(tracer, 2, 1.0)
    got = read_all({"trace_iters": 2})
    assert got == pytest.approx({"enqueue_ms": 4.0, "tournament_ms": 3.0,
                                 "s3_finalize_ms": 4.0,
                                 "beaver_ms": 1.875})


def test_readers_average_over_the_iterations(tracer):
    fill(tracer, 1, 1.0)
    fill(tracer, 1, 3.0)
    got = read_all({"trace_iters": 2})
    assert got == pytest.approx({"enqueue_ms": 8.0, "tournament_ms": 6.0,
                                 "s3_finalize_ms": 8.0, "beaver_ms": 3.75})


def test_readers_give_none_without_device_intervals(tracer):
    fill(tracer, 3, 1.0, device=False)
    assert set(read_all({"trace_iters": 3}).values()) == {None}


def test_readers_give_none_without_program_spans(tracer):
    with tracer.span("fit.s1_launch"):
        pass
    assert set(read_all({"trace_iters": 1}).values()) == {None}
    assert set(read_all({}).values()) == {None}
    fill(tracer, 1, 1.0)
    assert set(read_all({"trace_iters": 2}).values()) == {None}


@pytest.mark.cuda
def test_program_span_device_interval_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = {"n": 4096, "d": 64, "d_a": 32, "k": 5, "partition": "vertical"}
    progs = lloyd.fit_programs(cfg, "cuda", "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)

    def words(*shape):
        return torch.randint(-2 ** 21, 2 ** 21, shape, generator=g,
                             device="cuda")

    xa, xb = words(cfg["n"], 32), words(cfg["n"], 32)
    mu0, mu1 = words(5, 64), words(5, 64)
    flat = KS.materialize_offline(progs.s1_requests,
                                  TrustedDealer(seed=4, device="cuda"))
    for _ in range(3):
        progs.s1(xa, xb, mu0, mu1, *flat)
    sync = torch.cuda.synchronize
    sync()
    t = trace.get_tracer()
    t.reset()
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: syncs.append(a))
    trace.configure(programs=True)
    try:
        outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        outer[0].record()
        progs.s1(xa, xb, mu0, mu1, *flat)
        outer[1].record()
    finally:
        trace.configure(programs=False)
    assert syncs == []
    sync()
    (span,) = [e for e in t.events() if e["name"] == "prog.s1"]
    want = 1e3 * outer[0].elapsed_time(outer[1])
    assert abs(span["dev_us"] - want) <= 0.02 * want + 50.0, (span, want)
    t.reset()

