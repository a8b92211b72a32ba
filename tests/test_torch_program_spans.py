"""The program-span level of `obs/trace.py` inside the secure Lloyd
programs (`launch/kmeans_step.py`, `core/protocol.py`), on the CPU with
the pure-PyTorch backend: the span tree of one S1/S3 pair, the Beaver
openings against the offline schedule, outputs word for word with the
level off, configured on and under a profiler, the off path, and the
profiler trace's copy of the spans."""
import collections
import json
import math

import pytest
import torch

from repro_torch.core.triples import TrustedDealer
from repro_torch.launch import kmeans_step as KS
from repro_torch.obs import trace

N, D_A, D_B = 40, 3, 4


@pytest.fixture(autouse=True)
def tracer():
    """The global tracer empty, off, and with no program level, before and
    after each test."""
    t = trace.get_tracer()
    saved = (t.enabled, t.programs)
    t.reset()
    trace.configure(enabled=False, programs=False)
    yield t
    trace.configure(enabled=saved[0], programs=saved[1])
    t.reset()


def _pair(k, partition="vertical"):
    """(programs, one iteration -> its four output tensors)."""
    shape_b = (N, D_B) if partition == "vertical" else (N + 8, D_A)
    progs = KS.fit_programs(partition, False, (N, D_A), shape_b, k,
                            backend="torch", device="cpu")
    g = torch.Generator().manual_seed(k)
    xa = torch.randint(-2 ** 21, 2 ** 21, (N, D_A), generator=g)
    xb = torch.randint(-2 ** 21, 2 ** 21, shape_b, generator=g)
    mu0, mu1 = (torch.randint(-2 ** 62, 2 ** 62, (k, progs.geo.d),
                              generator=g) for _ in range(2))
    dealer = TrustedDealer(seed=k, device="cpu")
    flat1 = KS.materialize_offline(progs.s1_requests, dealer)
    flat3 = KS.materialize_offline(progs.s3_requests, dealer)

    def step():
        c0, c1 = progs.s1(xa, xb, mu0, mu1, *flat1)
        return (c0, c1) + tuple(progs.s3(xa, xb, mu0, mu1, c0, c1, *flat3))

    return progs, step


def _tree(evs):
    by_id = {e["id"]: e for e in evs}

    def parent(e):
        return by_id.get(e["parent"])

    def ancestors(e):
        out, p = [], parent(e)
        while p is not None:
            out.append(p["name"])
            p = parent(p)
        return out

    return parent, ancestors


@pytest.mark.parametrize("k", [16, 5])
def test_span_tree_and_opened_triples(k):
    progs, step = _pair(k)
    trace.configure(programs=True)
    for _ in range(2):
        step()
    evs = trace.get_tracer().events()
    parent, ancestors = _tree(evs)
    names = collections.Counter(e["name"] for e in evs)
    assert names["prog.s1"] == names["prog.s3"] == 2
    levels = math.ceil(math.log2(k))
    assert names["s2.level"] == 2 * levels
    want_parent = {"s1.distances": "prog.s1", "s1.mu_sq": "s1.distances",
                   "s2.tournament": "prog.s1", "s2.level": "s2.tournament",
                   "s3.sums": "prog.s3", "s3.finalize": "prog.s3",
                   "s3.guard": "s3.finalize", "s3.reciprocal": "s3.finalize",
                   "s3.update": "s3.finalize"}
    for e in evs:
        if e["name"] in want_parent:
            assert parent(e)["name"] == want_parent[e["name"]], e
        elif e["name"].startswith("prog."):
            assert parent(e) is None
        else:
            assert e["name"] in ("beaver.open", "beaver.combine"), e
            assert not any(a.startswith("beaver.") for a in ancestors(e))
            assert ancestors(e)[-1] in ("prog.s1", "prog.s3")
        assert "dev_us" not in e            # no device interval on the CPU
    lv = [e["args"] for e in evs if e["name"] == "s2.level"]
    assert sorted(a["level"] for a in lv) == sorted(2 * list(
        range(1, levels + 1)))
    assert sum(a["pairs"] for a in lv) == 2 * N * (k - 1)
    opened = sum(e["args"]["triples"] for e in evs
                 if e["name"] == "beaver.open")
    drawn = sum(kind != "rand" for kind, _ in
                progs.s1_requests + progs.s3_requests)
    assert opened == 2 * drawn
    assert {e["args"]["kind"] for e in evs if e["name"] == "beaver.open"} \
        == {"mul", "matmul", "ks"}


@pytest.mark.parametrize("k", [16, 5])
def test_outputs_equal_with_the_level_off_on_and_profiled(k):
    _, step = _pair(k)
    off = step()
    trace.configure(programs=True)
    on = step()
    trace.configure(programs=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = step()
    for a, b, c in zip(off, on, profiled):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_off_path_records_nothing_and_calls_no_range(monkeypatch):
    _, step = _pair(5)

    def refuse(*args, **kwargs):
        raise AssertionError("called on the off path")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    trace.configure(enabled=True)   # the reference-named spans: no level
    step()
    assert trace.get_tracer().events() == []
    trace.configure(enabled=False, programs=True)  # the level, no profiler
    step()
    assert trace.get_tracer().span_counts()["prog.s1"] == 1


def test_profiler_trace_holds_the_program_spans(tmp_path):
    _, step = _pair(5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = collections.Counter(
        e["name"] for e in json.loads(path.read_text())["traceEvents"]
        if e.get("cat") == "user_annotation")
    spans = trace.get_tracer().span_counts()
    assert spans["prog.s1"] == 1 and spans["beaver.open"] > 0
    assert ranges == spans


def test_every_program_names_its_call():
    k, n = 5, 24
    kw = dict(backend="torch", device="cpu")
    bp = KS.fit_batch_programs("vertical", False, (n, D_A), (n, D_B), k,
                               **kw)
    fp = KS.finalize_program(k, D_A + D_B, 2 * n, **kw)
    pp = KS.predict_program("vertical", False, (n, D_A), (n, D_B), k,
                            with_scores=True, **kw)
    dealer = TrustedDealer(seed=2, device="cpu")
    xa = torch.zeros((n, D_A), dtype=torch.int64)
    xb = torch.zeros((n, D_B), dtype=torch.int64)
    mu = torch.zeros((k, D_A + D_B), dtype=torch.int64)
    trace.configure(programs=True)
    c0, c1 = bp.s1(xa, xb, mu, mu, *KS.materialize_offline(bp.s1_requests,
                                                            dealer))
    n0, n1, d0, d1 = bp.s3p(xa, xb, c0, c1,
                            *KS.materialize_offline(bp.s3p_requests, dealer))
    fp.fn(mu, mu, n0, n1, d0, d1,
          *KS.materialize_offline(fp.requests, dealer))
    pp.fn(xa, xb, mu, mu, *KS.materialize_offline(pp.requests, dealer))
    evs = trace.get_tracer().events()
    parent, _ = _tree(evs)
    roots = [e["name"] for e in evs if parent(e) is None]
    assert sorted(roots) == ["prog.finalize", "prog.predict", "prog.s1",
                             "prog.s3p"]
    counts = trace.get_tracer().span_counts()
    assert counts["s3.sums"] == counts["s3.finalize"] == 1
    assert counts["s2.tournament"] == 2


def test_reference_spans_carry_ids_and_parents_into_the_export():
    t = trace.Tracer(enabled=True)
    with t.span("fit", rows=3):
        with t.span("fit.s1_launch", iter=0):
            t.instant("serve.admit", rid=1)
    evs = {e["name"]: e for e in t.events()}
    assert evs["fit"]["parent"] is None
    assert evs["fit.s1_launch"]["parent"] == evs["fit"]["id"]
    assert evs["serve.admit"]["parent"] == evs["fit.s1_launch"]["id"]
    assert evs["fit.s1_launch"]["args"] == {"iter": 0}
    out = {e["name"]: e["args"] for e in t.chrome_events() if e["ph"] != "M"}
    assert out["fit.s1_launch"] == {"iter": 0,
                                    "id": evs["fit.s1_launch"]["id"],
                                    "parent": evs["fit"]["id"]}
    assert "parent" not in out["fit"]


@pytest.mark.parametrize("k", [16, 5])
def test_reciprocal_span_names_its_impl_and_opens_once(k):
    """`s3.reciprocal` says which Newton loop ran ("plain" on the CPU) and
    for how many iterations; its one opening, with the loop's 2 * iters
    triples, stands in for the chain's per-product spans."""
    progs, step = _pair(k)
    trace.configure(programs=True)
    step()
    evs = trace.get_tracer().events()
    parent, ancestors = _tree(evs)
    [rcp] = [e for e in evs if e["name"] == "s3.reciprocal"]
    iters = math.ceil(math.log2(N)) + 6
    assert rcp["args"] == {"impl": "plain", "iters": iters}
    under = [e for e in evs if "s3.reciprocal" in ancestors(e)]
    assert [(e["name"], e["args"]) for e in under] == [
        ("beaver.open", {"kind": "mul", "triples": 2 * iters})]
    assert parent(under[0]) is rcp
