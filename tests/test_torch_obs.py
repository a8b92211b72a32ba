"""The port's telemetry plane (`repro_torch.obs`) against the JAX package's.

Two halves. First, every test of the reference's tests/test_obs.py, run
against `repro_torch.obs` and the port's wire, fit and service on the CPU:
a disabled tracer's span() is the shared no-op; enabled spans carry epoch
timestamps, durations, thread lanes and the ambient trace id and export as
loadable Chrome-trace JSON; traceless frames are byte-identical to the
pre-trace format; the registry's CommLog gauges are the CommLog; a
rid-pinned retry wave across a faulty wire yields exactly one server-side
request span and the client and server span files merge on the trace id;
the frame, wire and fit metrics land in the registry; /health follows the
service's state.

Second, parity: the same fits (dense on demand, dense pooled, sparse
pooled, minibatch with pipeline on and off) and the same service in both
packages, both global tracers on, record the same (name, phase, args
without timing) sequence on each thread lane; after the same fit, service
and wire exchange both registries hold the same series (names and
labels), counters, histogram counts and comm, bank and service gauges;
the port's `ServiceStats.as_dict()` keys are the reference's. The two
packages' process-wide tracers and registries are distinct objects, so
the tests compare one against the other and reset both.
"""
import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core import channel as JC
from repro.core import kmeans as JK
from repro.core.fraud import FraudDataset as JFraudDataset
from repro.obs import metrics as _jmetrics
from repro.obs import trace as _jtrace
from repro.serve import ScoringService as JScoringService
from repro.serve import ServiceStats as JServiceStats
from repro_torch.core.channel import (FaultyTransport, FrameCorrupt,
                                      FrameDecoder, LoopbackTransport,
                                      T_SCORE, decode_frame, encode_frame,
                                      session_key)
from repro_torch.core.fraud import FraudDataset
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.serve import (ScoringClient, ScoringServer, ScoringService,
                               ServiceStats)

D_A = D_B = 4
K = 3
CPU = dict(backend="torch", device="cpu")


@pytest.fixture(scope="module")
def fitted():
    ds = FraudDataset.synthesize(n=200, d_a=D_A, d_b=D_B, n_clusters=K,
                                 seed=0)
    km = SecureKMeans(KMeansConfig(k=K, iters=2, seed=0, offline="pooled",
                                   **CPU))
    res = km.fit(ds.x_a, ds.x_b)
    return km, res


@pytest.fixture()
def global_tracer():
    """The port's process-global tracer, returned enabled and restored
    after."""
    t = _trace.get_tracer()
    was = (t.enabled, t.process)
    t.reset()
    _trace.configure(enabled=True, process="server")
    yield t
    _trace.configure(enabled=was[0], process=was[1])
    t.reset()


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------

def test_disabled_span_is_shared_noop():
    t = _trace.Tracer(enabled=False)
    s1 = t.span("a", iter=1)
    s2 = t.span("b")
    assert s1 is s2                      # one module-level no-op object
    with s1:
        pass
    t.instant("c")
    t.complete_span("d", 0, 10)
    assert t.events() == []


def test_enabled_span_records_ts_dur_thread_args():
    t = _trace.Tracer(enabled=True)
    before = time.time_ns() // 1_000
    with t.span("fit.s1_launch", iter=3):
        time.sleep(0.002)
    (e,) = t.events()
    assert e["name"] == "fit.s1_launch" and e["ph"] == "X"
    assert e["args"]["iter"] == 3
    assert e["ts"] >= before
    assert e["dur"] >= 1_000             # slept 2ms, recorded in us
    assert e["tid"] == threading.get_ident()
    assert t.span_counts() == {"fit.s1_launch": 1}


def test_ambient_trace_id_tags_spans():
    t = _trace.Tracer(enabled=True)
    tid = _trace.new_trace_id()
    assert _trace.trace_id_from_bytes(_trace.trace_id_to_bytes(tid)) == tid
    _trace.set_current_trace(tid)
    try:
        with t.span("serve.resolve", rid=1):
            pass
        t.instant("serve.admit", rid=1)
    finally:
        _trace.set_current_trace(None)
    with t.span("untraced"):
        pass
    tagged = t.spans_for_trace(tid)
    assert {e["name"] for e in tagged} == {"serve.resolve", "serve.admit"}


def test_max_events_drops_newest_and_counts():
    t = _trace.Tracer(enabled=True, max_events=2)
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert len(t.events()) == 2 and t.dropped == 3
    assert "dropped" in t.flame_summary()


def test_export_chrome_loadable_with_lanes(tmp_path):
    t = _trace.Tracer(enabled=True, process="party_a")
    with t.span("pipeline.launch", iter=0):
        pass

    def other():
        with t.span("pipeline.pre", iter=1):
            pass

    th = threading.Thread(target=other, name="pipeline-worker")
    th.start()
    th.join()
    path = tmp_path / "trace.json"
    t.export_chrome(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs if e["ph"] == "M"}
    assert "process_name" in names and "thread_name" in names
    pmeta = [e for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"]
    assert pmeta[0]["args"]["name"] == "party_a"
    lanes = {e["tid"] for e in evs if e["ph"] == "X"}
    assert len(lanes) == 2               # two thread lanes visible
    cats = {e.get("cat") for e in evs if e["ph"] == "X"}
    assert cats == {"pipeline"}


def test_merge_traces_two_files_distinct_pids(tmp_path):
    ta = _trace.Tracer(enabled=True, process="client")
    tb = _trace.Tracer(enabled=True, process="server")
    with ta.span("client.score", rid=0):
        with tb.span("serve.resolve", rid=0):
            pass
    fa, fb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    ta.export_chrome(fa)
    tb.export_chrome(fb)
    doc = _trace.merge_traces([fa, fb], str(tmp_path / "m.json"))
    evs = doc["traceEvents"]
    assert {e["pid"] for e in evs} == {1, 2}
    pnames = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert pnames == {"client", "server"}
    reread = json.loads((tmp_path / "m.json").read_text())
    assert len(reread["traceEvents"]) == len(evs)


def test_merge_traces_across_packages(tmp_path):
    """A port trace file and a JAX one merge into one timeline in either
    package: the export format is the same."""
    tp = _trace.Tracer(enabled=True, process="port")
    tj = _jtrace.Tracer(enabled=True, process="reference")
    with tp.span("client.score", rid=0):
        with tj.span("serve.resolve", rid=0):
            pass
    fp, fj = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    tp.export_chrome(fp)
    tj.export_chrome(fj)
    ours = _trace.merge_traces([fp, fj])
    theirs = _jtrace.merge_traces([fp, fj])
    assert ours == theirs
    assert {e["pid"] for e in ours["traceEvents"]} == {1, 2}


# ---------------------------------------------------------------------------
# wire frame trace-id extension
# ---------------------------------------------------------------------------

def test_traceless_frames_byte_identical_to_pre_trace_format():
    # no trace id -> the emitted bytes are exactly the traceless format,
    # keyed and unkeyed alike
    key = session_key("compat")
    for k in (None, key):
        f = encode_frame(T_SCORE, 7, b"hello", key=k)
        assert decode_frame(f, key=k) == (T_SCORE, 7, b"hello")
        ft, seq, payload, tid = decode_frame(f, key=k, with_trace=True)
        assert (ft, seq, payload, tid) == (T_SCORE, 7, b"hello", None)
        assert f == JC.encode_frame(T_SCORE, 7, b"hello", key=k)


def test_traced_frame_roundtrip_and_mac_coverage():
    key = session_key("traced")
    raw = _trace.trace_id_to_bytes(_trace.new_trace_id())
    f = encode_frame(T_SCORE, 3, b"pay", key=key, trace_id=raw)
    ft, seq, payload, tid = decode_frame(f, key=key, with_trace=True)
    assert (ft, seq, payload, tid) == (T_SCORE, 3, b"pay", raw)
    # the id sits under the MAC: flipping one of its bits is tampering
    bad = bytearray(f)
    bad[21] ^= 1                          # first trace-id byte
    with pytest.raises(FrameCorrupt):
        decode_frame(bytes(bad), key=key, with_trace=True)
    with pytest.raises(ValueError):
        encode_frame(T_SCORE, 0, b"", trace_id=b"short")


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_counter_gauge_histogram_snapshot():
    reg = _metrics.MetricsRegistry()
    c = reg.counter("repro_frame_crc_errors_total")
    assert c is reg.counter("repro_frame_crc_errors_total")  # get-or-create
    c.inc()
    c.inc(2)
    reg.gauge("repro_bank_stock_copies", labels={"key": "r16"}).set(4)
    h = reg.histogram("repro_latency_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["repro_frame_crc_errors_total"] == 3
    assert snap['repro_bank_stock_copies{key="r16"}'] == 4
    hist = snap["repro_latency_ms"]
    assert hist["count"] == 4 and hist["sum"] == pytest.approx(555.5)
    text = reg.render_prometheus()
    assert "# TYPE repro_frame_crc_errors_total counter" in text
    assert 'repro_bank_stock_copies{key="r16"} 4' in text
    assert 'repro_latency_ms_bucket{le="10.0"} 2' in text
    assert "repro_latency_ms_count 4" in text


def test_callback_gauge_reads_live_and_survives_errors():
    reg = _metrics.MetricsRegistry()
    box = {"v": 1}
    reg.gauge("g", fn=lambda: box["v"])
    assert reg.snapshot()["g"] == 1
    box["v"] = 7
    assert reg.snapshot()["g"] == 7       # read at query time, no cache

    def boom():
        raise RuntimeError("down")

    reg.gauge("bad", fn=boom)
    assert np.isnan(reg.snapshot()["bad"])


def test_registry_commlog_equality_is_exact(fitted):
    """The registry's online-bytes answer EQUALS
    CommLog.total_bytes('online'): the same object, no drift."""
    _, res = fitted
    reg = _metrics.MetricsRegistry()
    _metrics.register_commlog(res.log, registry=reg)
    snap = reg.snapshot()
    assert snap['repro_comm_bytes_total{phase="online"}'] == \
        res.log.total_bytes("online")
    assert snap['repro_comm_rounds_total{phase="online"}'] == \
        res.log.total_rounds("online")
    assert res.log.total_bytes("online") > 0


def test_metrics_http_endpoint_serves_prometheus_text():
    reg = _metrics.MetricsRegistry()
    reg.counter("repro_requests_total").inc(5)
    srv = _metrics.MetricsServer(port=0, registry=reg)
    srv.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
    finally:
        srv.stop()
    assert b"repro_requests_total 5" in body


def test_frame_decoder_errors_route_to_registry():
    reg = _metrics.get_registry()

    def val(name):
        return reg.snapshot().get(name, 0)

    crc0 = val("repro_frame_crc_errors_total")
    auth0 = val("repro_frame_auth_errors_total")
    rs0 = val("repro_frame_resync_events_total")
    dec = FrameDecoder()
    good = encode_frame(T_SCORE, 0, b"x")
    bad = bytearray(good)
    bad[-1] ^= 1
    assert dec.feed(bytes(bad)) == []
    assert val("repro_frame_crc_errors_total") == crc0 + 1
    kdec = FrameDecoder(key=session_key("k"))
    assert kdec.feed(encode_frame(T_SCORE, 1, b"y")) == []    # unkeyed
    assert val("repro_frame_auth_errors_total") == auth0 + 1
    assert val("repro_frame_resync_events_total") == rs0


# ---------------------------------------------------------------------------
# distributed request trace across a faulty wire
# ---------------------------------------------------------------------------

def test_retry_wave_single_server_span_and_merged_timeline(
        fitted, global_tracer, tmp_path):
    """Drop/dup chaos on the client's send side: the rid-pinned request
    crosses the wire several times, yet the server records EXACTLY ONE
    serve.request span for the trace id, and the client + server span
    files merge into one timeline where the server work nests inside the
    client span."""
    km, res = fitted
    arr = FraudDataset.synthesize(n=8, d_a=D_A, d_b=D_B, n_clusters=K,
                                  seed=3)
    key = session_key("obs-trace")
    ta, tb = LoopbackTransport.pair()
    # seed 3 drops the first frame, so the request crosses at least twice
    # however fast the server answers
    ft = FaultyTransport(ta, seed=3, drop=0.25, dup=0.25)
    svc = ScoringService(km, res, d_a=D_A, d_b=D_B, with_scores=True,
                         rungs=(16,), provision_copies=4)
    server = ScoringServer(svc, tb, idle_timeout_s=30.0, auth_key=key)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    client_tracer = _trace.Tracer(enabled=True, process="client")
    client = ScoringClient(ft, auth_key=key, deadline_s=20.0,
                           tracer=client_tracer)
    r = client.score(arr.x_a, arr.x_b)
    client.bye()
    th.join(timeout=30)
    assert r.error is None
    assert ft.faults.dropped + ft.faults.duplicated > 0   # chaos happened

    cl = [e for e in client_tracer.events()
          if e["name"] == "client.score"]
    assert len(cl) == 1
    tid = cl[0]["args"]["trace"]
    sv = global_tracer.spans_for_trace(tid)
    reqs = [e for e in sv if e["name"] == "serve.request"]
    assert len(reqs) == 1                 # exactly once, chaos or not
    assert reqs[0]["args"]["rid"] == r.request_id
    # admission + resolve happened under the SAME propagated id
    assert {"serve.resolve", "serve.admit", "wire.handle"} <= \
        {e["name"] for e in sv}
    # server-side work nests inside the client span on the shared clock
    c0 = cl[0]["ts"]
    c1 = c0 + cl[0]["dur"]
    assert c0 <= reqs[0]["ts"] <= c1
    assert reqs[0]["ts"] + reqs[0]["dur"] <= c1 + 1_000   # 1ms slack

    fa, fb = str(tmp_path / "client.json"), str(tmp_path / "server.json")
    client_tracer.export_chrome(fa)
    global_tracer.export_chrome(fb)
    doc = _trace.merge_traces([fa, fb], str(tmp_path / "merged.json"))
    evs = doc["traceEvents"]
    joined = [e for e in evs if e.get("args", {}).get("trace") == tid]
    assert {e["pid"] for e in joined} == {1, 2}  # both endpoints, one id
    pnames = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"client", "server"} <= pnames


# ---------------------------------------------------------------------------
# ServiceStats: latency split under one lock
# ---------------------------------------------------------------------------

def test_stats_latency_split_and_quantiles():
    st = ServiceStats()
    for i in range(1, 101):
        st.record_latency(i / 1000, queue_wait=i / 4000, inflight=i / 2000)
    d = st.as_dict()
    assert d["p50_ms"] == pytest.approx(
        float(np.quantile(np.arange(1, 101) / 1000, 0.5)) * 1e3)
    assert d["queue_wait_p50_ms"] == pytest.approx(d["p50_ms"] / 4)
    assert d["inflight_p50_ms"] == pytest.approx(d["p50_ms"] / 2)
    assert d["queue_wait_p99_ms"] <= d["p99_ms"]
    assert len(st.latencies) == len(st.queue_waits) == len(st.inflights)


def test_stats_concurrent_recording_consistent():
    st = ServiceStats()

    def pump():
        for _ in range(500):
            st.record_latency(0.001, queue_wait=0.0005, inflight=0.0005)

    ts = [threading.Thread(target=pump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # windows are bounded deques, all fed under ONE lock: same length
    assert len(st.latencies) == len(st.queue_waits) == len(st.inflights)
    assert st.latency_quantile(0.5) == pytest.approx(0.001)


def test_stats_as_dict_keys_are_the_references():
    """Every as_dict key becomes a `repro_serve_<key>` gauge, so the key
    set is the reference's: no dict-valued key (it would render NaN)."""
    assert set(ServiceStats().as_dict()) == set(JServiceStats().as_dict())
    assert all(isinstance(v, (int, float))
               for v in ServiceStats().as_dict().values())


# ---------------------------------------------------------------------------
# bank gauges + stats line
# ---------------------------------------------------------------------------

def test_register_bank_and_stats_line(fitted):
    km, res = fitted
    svc = ScoringService(km, res, d_a=D_A, d_b=D_B, with_scores=True,
                         rungs=(16,), provision_copies=3)
    svc.warm()                            # registers service + bank gauges
    reg = _metrics.get_registry()
    snap = reg.snapshot()
    stocks = {k: v for k, v in snap.items()
              if k.startswith("repro_bank_stock_copies")}
    assert stocks and all(v >= 0 for v in stocks.values())
    line = _metrics.StatsLineLogger(svc, bank=svc.bank).render()
    assert "bank_stock" in line and "p99" in line
    arr = FraudDataset.synthesize(n=8, d_a=D_A, d_b=D_B, n_clusters=K,
                                  seed=5)
    svc.submit(arr.x_a, arr.x_b)
    svc.drain()
    snap2 = reg.snapshot()
    assert snap2["repro_serve_requests"] >= 1
    assert snap2["repro_bank_consumed_requests_total"] >= 1
    assert snap2["repro_serve_health"] == 1
    assert "NaN" not in reg.render_prometheus()


# ---------------------------------------------------------------------------
# bounded-memory tracing: rotation + sampling
# ---------------------------------------------------------------------------

def test_rotate_spans_keeps_newest_n_per_category():
    t = _trace.Tracer(enabled=True, rotate_spans=2)
    for i in range(5):
        with t.span("fit.iter", i=i):
            pass
    for i in range(3):
        with t.span("serve.request", i=i):
            pass
    evs = t.events()
    fit = [e["args"]["i"] for e in evs if e["name"] == "fit.iter"]
    srv = [e["args"]["i"] for e in evs if e["name"] == "serve.request"]
    assert fit == [3, 4]                 # newest 2, old fit spans evicted
    assert srv == [1, 2]                 # per-category: serve has its own 2
    assert t.rotated_out == 3 + 1
    assert t.span_counts() == {"fit.iter": 2, "serve.request": 2}
    assert "rotated out" in t.flame_summary()


def test_sample_rate_is_deterministic_counter_not_rng():
    a = _trace.Tracer(enabled=True, sample_rate=0.25)
    b = _trace.Tracer(enabled=True, sample_rate=0.25)
    for t in (a, b):
        for i in range(16):
            with t.span("wire.request", i=i):
                pass
    ia = [e["args"]["i"] for e in a.events()]
    ib = [e["args"]["i"] for e in b.events()]
    assert ia == ib == [0, 4, 8, 12]     # every 4th, from the first
    assert a.sampled_out == 12


def test_sampling_counters_are_per_category():
    t = _trace.Tracer(enabled=True, sample_rate=0.5)
    with t.span("fit.a"):
        pass
    with t.span("serve.b"):
        pass                             # different category: own counter
    assert t.span_counts() == {"fit.a": 1, "serve.b": 1}


def test_bounds_validation():
    with pytest.raises(ValueError):
        _trace.Tracer(rotate_spans=0)
    with pytest.raises(ValueError):
        _trace.Tracer(sample_rate=0.0)
    with pytest.raises(ValueError):
        _trace.Tracer(sample_rate=1.5)


def test_disabled_noop_path_unchanged_by_bounds():
    """Rotation/sampling must not touch the disabled fast path: span()
    still returns the ONE shared no-op object, and nothing is recorded or
    counted."""
    t = _trace.Tracer(enabled=False, rotate_spans=4, sample_rate=0.1)
    s1 = t.span("a")
    s2 = t.span("b", x=1)
    assert s1 is s2 is _trace._NOOP
    with s1:
        pass
    t.instant("c")
    assert t.events() == [] and t.sampled_out == 0 and t.rotated_out == 0


def test_configure_global_bounds_roundtrip(global_tracer):
    _trace.configure(rotate_spans=3, sample_rate=1.0)
    try:
        for i in range(7):
            with _trace.span("fit.x", i=i):
                pass
        assert [e["args"]["i"] for e in global_tracer.events()
                if e["name"] == "fit.x"] == [4, 5, 6]
    finally:
        global_tracer.configure_bounds()  # restore unbounded defaults


# ---------------------------------------------------------------------------
# latency histograms: fixed log-spaced buckets
# ---------------------------------------------------------------------------

def test_log_buckets_fixed_edges():
    edges = _metrics.log_buckets(1e-3, 10.0, per_decade=3)
    assert edges[0] == pytest.approx(1e-3)
    assert 10.0 in edges
    ratios = [edges[i + 1] / edges[i] for i in range(len(edges) - 1)]
    assert all(r == pytest.approx(10 ** (1 / 3), rel=1e-6) for r in ratios)
    assert _metrics.log_buckets(1e-3, 10.0, per_decade=3) == edges
    assert edges == _jmetrics.log_buckets(1e-3, 10.0, per_decade=3)
    with pytest.raises(ValueError):
        _metrics.log_buckets(0.0, 1.0)
    with pytest.raises(ValueError):
        _metrics.log_buckets(2.0, 1.0)


def _hist_count(snap, name):
    h = snap.get(name)
    return 0 if h is None else h["count"]


def test_wire_rtt_and_backoff_histograms_record():
    from repro_torch.core.channel import (ReliableChannel, WireSession,
                                          serve_peer)
    reg = _metrics.get_registry()
    before = reg.snapshot()
    ta, tb = LoopbackTransport.pair()
    th = threading.Thread(target=serve_peer, args=(tb,),
                          kwargs={"idle_timeout_s": 30.0}, daemon=True)
    th.start()
    ws = WireSession(ReliableChannel(ta, deadline_s=10.0))
    ws.exchange(64, 2)
    ws.bye()
    th.join(timeout=10)
    after = reg.snapshot()
    d_rtt = _hist_count(after, "repro_wire_request_seconds") - \
        _hist_count(before, "repro_wire_request_seconds")
    assert d_rtt >= 3                    # 2 exchange rounds + bye
    text = reg.render_prometheus()
    assert 'repro_wire_request_seconds_bucket{le="1e-05"}' in text or \
        'repro_wire_request_seconds_bucket{le="1.0"}' in text


@pytest.mark.parametrize("batch_size", [None, 48])
def test_fit_iteration_histogram_records_per_iteration(batch_size):
    reg = _metrics.get_registry()
    before = _hist_count(reg.snapshot(), "repro_fit_iteration_seconds")
    ds = FraudDataset.synthesize(n=96, d_a=D_A, d_b=D_B, n_clusters=K,
                                 seed=2)
    km = SecureKMeans(KMeansConfig(k=K, iters=3, seed=2, offline="pooled",
                                   batch_size=batch_size, **CPU))
    km.fit(ds.x_a, ds.x_b)
    after = _hist_count(reg.snapshot(), "repro_fit_iteration_seconds")
    assert after - before == 3


# ---------------------------------------------------------------------------
# /health endpoint
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_route_reflects_callback_state():
    state = {"v": "STARTING"}
    srv = _metrics.MetricsServer(port=0, registry=_metrics.MetricsRegistry(),
                                 health_cb=lambda: state["v"])
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, body = _get(base + "/health")
        assert code == 503 and "STARTING" in body
        state["v"] = "READY"
        code, body = _get(base + "/health")
        assert code == 200 and body.strip() == "READY"
        for s in ("DEGRADED", "DRAINING"):
            state["v"] = s
            code, body = _get(base + "/health")
            assert code == 503 and s in body
    finally:
        srv.stop()


def test_health_route_404_without_callback_and_cb_error_is_503():
    srv = _metrics.MetricsServer(port=0, registry=_metrics.MetricsRegistry())
    srv.start()
    try:
        code, _ = _get(f"http://127.0.0.1:{srv.port}/health")
        assert code == 404
    finally:
        srv.stop()

    def boom():
        raise RuntimeError("probe exploded")

    srv = _metrics.MetricsServer(port=0, registry=_metrics.MetricsRegistry(),
                                 health_cb=boom)
    srv.start()
    try:
        code, body = _get(f"http://127.0.0.1:{srv.port}/health")
        assert code == 503 and "DEGRADED" in body
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# parity with the JAX package: spans and metrics
# ---------------------------------------------------------------------------

# span args that are timing or random, not structure
_VOLATILE = {"queue_wait_ms", "trace"}


@contextlib.contextmanager
def _both_tracers():
    """Both packages' global tracers enabled and empty, then restored."""
    saved = []
    for mod in (_trace, _jtrace):
        t = mod.get_tracer()
        saved.append((mod, t.enabled, t.process))
        t.reset()
        mod.configure(enabled=True, process="parity")
    try:
        yield _trace.get_tracer(), _jtrace.get_tracer()
    finally:
        for mod, enabled, process in saved:
            mod.configure(enabled=enabled, process=process)
            mod.get_tracer().reset()


def _lanes(t) -> dict:
    """{thread name: [(span name, phase, args without timing)]}, in the
    order the spans were recorded (a span records when it closes)."""
    with t._lock:
        evs = [dict(e) for e in t._events]
        names = dict(t._threads)
    out = {}
    for e in evs:
        args = {k: v for k, v in e["args"].items() if k not in _VOLATILE}
        out.setdefault(names[e["tid"]], []).append(
            (e["name"], e["ph"], args))
    return out


def _data(sparse: bool, n: int = 96):
    rng = np.random.default_rng(5)
    centers = rng.uniform(-4, 4, (K, D_A + D_B))
    x = centers[rng.integers(0, K, n)] + rng.normal(0, 0.3, (n, D_A + D_B))
    if sparse:
        x = x * (rng.random(x.shape) >= 0.5)
    return x[:, :D_A], x[:, D_A:]


FITS = {
    "dense_on_demand": dict(offline="on_demand"),
    "dense_pooled": dict(offline="pooled"),
    "sparse_pooled": dict(offline="pooled", sparse=True),
    "minibatch_pipeline": dict(offline="pooled", batch_size=40,
                               pipeline=True),
    "minibatch_sequential": dict(offline="pooled", batch_size=40,
                                 pipeline=False),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_span_sequences_equal_reference(name):
    """The same fit in both packages records the same spans, in the same
    order, with the same arguments, on each thread lane."""
    kw = dict(k=K, iters=2, seed=3, **FITS[name])
    xa, xb = _data(kw.get("sparse", False))
    JK.clear_plan_cache()
    from repro_torch.core import kmeans as TK
    TK.clear_plan_cache()
    with _both_tracers() as (tt, jt):
        SecureKMeans(KMeansConfig(**CPU, **kw)).fit(xa, xb)
        JK.SecureKMeans(JK.KMeansConfig(backend="xla", **kw)).fit(xa, xb)
        got, want = _lanes(tt), _lanes(jt)
    assert got == want
    counts = {}
    for seq in want.values():
        for n_, _, _ in seq:
            counts[n_] = counts.get(n_, 0) + 1
    assert counts["fit"] == 1
    if "batch_size" in kw:
        assert counts["pipeline.launch"] == 2 * 3       # 2 iters x 3 batches
    elif kw["offline"] == "on_demand":
        assert counts["fit.s2_argmin"] == 2
    else:
        assert counts["fit.s1_launch"] == 2


def _service_pair(km_t, res_t, km_j, res_j):
    kw = dict(d_a=D_A, d_b=D_B, with_scores=True, rungs=(8, 16),
              provision_copies=2)
    return ScoringService(km_t, res_t, **kw), JScoringService(km_j, res_j,
                                                              **kw)


def _fitted_pair():
    xa, xb = _data(False)
    kw = dict(k=K, iters=2, seed=3, offline="pooled")
    km_t = SecureKMeans(KMeansConfig(**CPU, **kw))
    km_j = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **kw))
    return km_t, km_t.fit(xa, xb), km_j, km_j.fit(xa, xb)


def _requests():
    arr = JFraudDataset.synthesize(n=40, d_a=D_A, d_b=D_B, n_clusters=K,
                                   seed=7)
    sizes = [3, 9, 2, 20, 6]
    bounds = np.cumsum([0] + sizes)
    return [(arr.x_a[lo:hi], arr.x_b[lo:hi])
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def test_service_span_sequences_equal_reference():
    """A service's warm, admissions and drain record the same spans in
    both packages (bank provisioning, admits, the drain, its pipeline
    phases, the scoring program's prepare / launch / collect and one
    request span per rid)."""
    km_t, res_t, km_j, res_j = _fitted_pair()
    with _both_tracers() as (tt, jt):
        st, sj = _service_pair(km_t, res_t, km_j, res_j)
        for svc in (st, sj):
            svc.warm()
            for xa, xb in _requests():
                svc.submit(xa, xb)
            svc.drain()
        got, want = _lanes(tt), _lanes(jt)
    assert got == want
    names = [n for n, _, _ in want["MainThread"]]
    assert names.count("serve.request") == len(_requests())
    assert names.count("serve.admit") == len(_requests())
    assert {"serve.drain", "bank.provision", "predict.prepare",
            "predict.launch", "predict.collect"} <= set(names)


def _series(text: str) -> set:
    return {line.rsplit(" ", 1)[0] for line in text.splitlines()
            if line and not line.startswith("#")}


# gauges whose value is a time, a rate or a latency quantile
_TIMED = ("online_seconds", "rows_per_s", "_ms", "topup_seconds")


def test_registries_equal_reference_after_fit_service_and_wire():
    """After the same fit, service drain and wire exchange, both
    registries expose the same series (names and labels); counters,
    histogram counts and every comm, bank and service gauge that is not a
    time are equal."""
    from repro.core.channel import ReliableChannel as JReliableChannel
    from repro.core.channel import WireSession as JWireSession
    from repro.core.channel import serve_peer as jserve_peer
    from repro_torch.core.channel import (ReliableChannel, WireSession,
                                          serve_peer)
    _metrics.get_registry().reset()
    _jmetrics.get_registry().reset()
    km_t, res_t, km_j, res_j = _fitted_pair()
    _metrics.register_commlog(res_t.log)
    _jmetrics.register_commlog(res_j.log)
    st, sj = _service_pair(km_t, res_t, km_j, res_j)
    for svc in (st, sj):
        svc.warm()
        for xa, xb in _requests():
            svc.submit(xa, xb)
        svc.drain()
    for chan, ws_cls, peer, lb in (
            (ReliableChannel, WireSession, serve_peer, LoopbackTransport),
            (JReliableChannel, JWireSession, jserve_peer,
             JC.LoopbackTransport)):
        ta, tb = lb.pair()
        th = threading.Thread(target=peer, args=(tb,),
                              kwargs={"idle_timeout_s": 30.0}, daemon=True)
        th.start()
        ws = ws_cls(chan(ta, deadline_s=10.0))
        ws.exchange(4096, 3)
        ws.bye()
        th.join(timeout=10)
    rt, rj = _metrics.get_registry(), _jmetrics.get_registry()
    tt, tj = rt.render_prometheus(), rj.render_prometheus()
    assert "NaN" not in tt
    assert _series(tt) == _series(tj)
    snap_t, snap_j = rt.snapshot(), rj.snapshot()
    assert snap_t.keys() == snap_j.keys()
    compared = 0
    for key, want in snap_j.items():
        got = snap_t[key]
        if isinstance(want, dict):
            assert got["count"] == want["count"], key
            if not key.startswith(("repro_fit_", "repro_wire_")):
                assert got == want, key
        elif not any(t in key for t in _TIMED):
            assert got == want, key
        compared += 1
    assert compared > 30
    assert snap_t["repro_fit_iteration_seconds"]["count"] == 2
    assert snap_t['repro_comm_bytes_total{phase="online"}'] == \
        res_t.log.total_bytes("online")
