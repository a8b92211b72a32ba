"""The port's serving launcher (`repro_torch.launch.serve_kmeans`) and the
two-party launcher's `--trace-out`, against the JAX package's, on the CPU.

* In process: `serve(device="cpu")` and the reference's `serve()` on the
  same arguments give the same deterministic output fields (requests,
  rows, padded rows, launches, triples and bytes per request, pad
  overhead, replenish events, the stream's Jaccard), with the bank saved
  and reloaded or the fit fed from a bank, and the traced runs record the
  same span counts.
* `--supervised --device cpu`: the wire server dies after its 3rd
  journaled response, the supervisor restarts it once, and the client's
  six requests are each answered exactly once, equal to the JAX service
  that `serve_wire` builds; the surviving incarnation's trace tags every
  request span with a client trace id and replays the journaled rid; the
  supervising parent never initialized CUDA. `/health` answers 503
  STARTING while a wire server warms and 200 READY after.
* `two_party --trace-out`: both roles' span files count what the JAX
  launcher's count.
"""
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core.fraud import FraudDataset as JFraudDataset
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import SecureKMeans as JSecureKMeans
from repro.launch import serve_kmeans as JL
from repro.obs import trace as _jtrace
from repro.serve import ScoringService as JScoringService
from repro_torch.core.channel import SocketTransport
from repro_torch.launch import serve_kmeans as TL
from repro_torch.obs import trace as _trace
from repro_torch.serve import ScoringClient

D_A = D_B = 4
K = 3
SMALL = dict(n_train=200, d_a=D_A, d_b=D_B, k=K, iters=2, rungs=(8, 16),
             requests=6, mean_batch=8, provision_copies=4, verbose=False)
# every field of serve()'s output that is not a time or a rate
DETERMINISTIC = ("requests", "rows", "padded_rows", "launches",
                 "triples_per_request", "bytes_per_request", "pad_overhead",
                 "replenish_events", "failed_requests", "retried_groups",
                 "shed_requests", "expired_requests", "queue_depth",
                 "max_queue_depth", "jaccard_stream", "bank_loaded_from_disk",
                 "fit_from_bank", "provision_workers")


def _env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _restore_tracers():
    for mod in (_trace, _jtrace):
        mod.configure(enabled=False, process="repro", rotate_spans=None,
                      sample_rate=1.0)
        mod.get_tracer().reset()


@pytest.mark.parametrize("variant", ["plain", "bank", "traced"])
def test_serve_in_process_equals_reference(variant, tmp_path):
    kw = dict(SMALL)
    if variant == "bank":
        kw.update(fit_from_bank=True, provision_workers=2)
    try:
        outs, counts = [], []
        for label, launcher, extra in (
                ("port", TL, dict(device="cpu")), ("reference", JL, {})):
            if variant == "bank":
                extra["bank_path"] = str(tmp_path / f"{label}.npz")
            if variant == "traced":
                extra["trace_out"] = str(tmp_path / f"{label}.json")
                extra["stats_interval"] = 0.05
            outs.append(launcher.serve(**kw, **extra))
            if variant == "traced":
                doc = json.loads((tmp_path / f"{label}.json").read_text())
                c = {}
                for e in doc["traceEvents"]:
                    if e["ph"] != "M":
                        c[e["name"]] = c.get(e["name"], 0) + 1
                counts.append(c)
    finally:
        _restore_tracers()
    got, want = outs
    assert set(got) == set(want)
    for key in DETERMINISTIC:
        assert got[key] == want[key], key
    assert got["requests"] == kw["requests"]
    if variant == "bank":
        assert got["bank_loaded_from_disk"] and got["fit_from_bank"]
    if variant == "traced":
        assert counts[0] == counts[1]
        assert counts[0]["fit"] == 1
        assert counts[0]["serve.request"] == kw["requests"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None, ""


def _batches(n, rows=8, seed=3):
    arr = JFraudDataset.synthesize(n=rows * n, d_a=D_A, d_b=D_B,
                                   n_clusters=K, seed=seed)
    return [(arr.x_a[i * rows:(i + 1) * rows],
             arr.x_b[i * rows:(i + 1) * rows]) for i in range(n)]


def test_supervised_wire_server_restarts_and_answers_exactly_once(tmp_path):
    ck = str(tmp_path / "ck")
    trace = str(tmp_path / "server.json")
    args = ["--supervised", "--device", "cpu", "--serve-port", "0",
            "--metrics-port", "0", "--n-train", "200", "--d-a", str(D_A),
            "--d-b", str(D_B), "--k", str(K), "--iters", "2", "--rungs",
            "16", "--serve-checkpoint-dir", ck, "--provision-copies", "16",
            "--die-after-responses", "3", "--idle-timeout", "120",
            "--seed", "0", "--trace-out", trace]
    sup = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_kmeans"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    port = mport = None
    health = []
    lines = []

    def poll():
        while port is None and sup.poll() is None:
            if mport is not None:
                code, _ = _get(f"http://127.0.0.1:{mport}/health")
                if code is not None:
                    health.append(code)
            threading.Event().wait(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    try:
        for line in sup.stdout:
            lines.append(line)
            m = re.search(r"METRICS (\d+)", line)
            if m and mport is None:
                mport = int(m.group(1))
                poller.start()
            m = re.search(r"SERVING (\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port is not None, "".join(lines)
        poller.join(timeout=10)
        assert _get(f"http://127.0.0.1:{mport}/health")[0] == 200
        b = _batches(6)
        t = SocketTransport("connect", port=port, io_timeout_s=5.0)
        client = ScoringClient(t, deadline_s=15.0, try_timeout_s=0.5,
                               waves=20, retry_wait_s=2.0,
                               tracer=_trace.Tracer())
        got = {i: client.score(xa, xb, rid=i)
               for i, (xa, xb) in enumerate(b)}
        client.bye()
        t.close()
        rest = sup.communicate(timeout=180)[0]
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.communicate()
    assert sup.returncode == 0, rest
    assert "restart 1 after rc=17" in rest
    assert "SUPERVISOR terminal: clean exit (rc=0, restarts=1)" in rest
    stats = json.loads(rest.split("SUPERVISOR_STATS ")[1].splitlines()[0])
    assert stats["cuda_initialized"] is False and stats["restarts"] == 1
    assert len(stats["restart_latencies"]) == 1
    # the warm window is milliseconds here: every probe answered, the
    # last READY (test_wire_server_health_is_starting_until_warm pins 503)
    assert health and set(health) <= {200, 503}
    # exactly once, equal to the JAX service serve_wire builds
    assert sorted(got) == list(range(6))
    ds = JFraudDataset.synthesize(n=200, d_a=D_A, d_b=D_B, n_clusters=K,
                                  seed=0)
    km = JSecureKMeans(JKMeansConfig(k=K, iters=2, seed=0, offline="pooled",
                                     backend="xla"))
    res = km.fit(ds.x_a, ds.x_b)
    svc = JScoringService(km, res, rungs=(16,), with_scores=True, d_a=D_A,
                          d_b=D_B, provision_copies=16)
    for i, (xa, xb) in enumerate(b):
        svc.submit(xa, xb)
        (r,) = svc.drain()
        assert got[i].error is None and r.error is None
        np.testing.assert_array_equal(got[i].labels, r.labels)
        np.testing.assert_array_equal(got[i].scores, r.scores)
    # the surviving incarnation's spans: the journaled third response is
    # replayed, the last three scored, each under the client's trace id
    evs = json.loads(open(trace).read())["traceEvents"]
    reqs = [e for e in evs if e["name"] == "serve.request"]
    assert sorted(e["args"]["rid"] for e in reqs) == [3, 4, 5]
    assert all(len(e["args"].get("trace", "")) == 16 for e in reqs)
    assert [e["args"]["rid"] for e in evs
            if e["name"] == "serve.replay"] == [2]


def test_wire_server_health_is_starting_until_warm(monkeypatch):
    """The exposition starts before `warm`: /health answers 503 STARTING
    while the service warms (bank provisioning, or its load and the
    journal's replay after a restart) and 200 READY once it serves."""
    from repro_torch.launch.supervisor import free_port
    release = threading.Event()

    class SlowWarm(TL.ScoringService):
        def warm(self):
            release.wait(30)
            super().warm()

    monkeypatch.setattr(TL, "ScoringService", SlowWarm)
    mport, sport = free_port(), free_port()
    th = threading.Thread(target=TL.serve_wire, daemon=True, kwargs=dict(
        port=sport, metrics_port=mport, n_train=200, d_a=D_A, d_b=D_B, k=K,
        iters=2, rungs=(16,), provision_copies=2, idle_timeout_s=30.0,
        device="cpu"))
    th.start()
    url = f"http://127.0.0.1:{mport}/health"
    code = None
    for _ in range(600):
        code, body = _get(url)
        if code is not None:
            break
        threading.Event().wait(0.05)
    assert (code, body.strip()) == (503, "STARTING")
    release.set()
    for _ in range(600):
        code, body = _get(url)
        if code == 200:
            break
        threading.Event().wait(0.05)
    assert (code, body.strip()) == (200, "READY")
    t = SocketTransport("connect", port=sport, io_timeout_s=5.0,
                        connect_retries=50)
    ScoringClient(t, deadline_s=15.0, tracer=_trace.Tracer()).bye()
    t.close()
    th.join(timeout=60)
    assert not th.is_alive()


def _two_party(module, extra, tmp_path, tag, device=True):
    cmd = [sys.executable, "-m", module]
    dev = ["--device", "cpu"] if device else []
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    fa, fb = str(tmp_path / f"{tag}_a.json"), str(tmp_path / f"{tag}_b.json")
    a = subprocess.Popen(cmd + ["--role", "A", "--port", "0", "--trace-out",
                                fa, *dev, *extra],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
    line = a.stdout.readline()
    assert line.startswith("LISTENING "), line
    b = subprocess.Popen(cmd + ["--role", "B", "--port", line.split()[1],
                                "--trace-out", fb],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
    a_out = a.communicate(timeout=300)[0]
    b_out = b.communicate(timeout=60)[0]
    assert a.returncode == 0, a_out
    assert b.returncode == 0, b_out
    counts = []
    for f in (fa, fb):
        c = {}
        for e in json.loads(open(f).read())["traceEvents"]:
            if e["ph"] != "M":
                c[e["name"]] = c.get(e["name"], 0) + 1
        counts.append(c)
    return counts


@pytest.mark.parametrize("offline", ["on_demand", "pooled"])
def test_two_party_trace_out_counts_equal_reference(offline, tmp_path):
    extra = ["--iters", "2", "--offline", offline]
    port = _two_party("repro_torch.launch.two_party", extra, tmp_path, "t")
    ref = _two_party("repro.launch.two_party", extra, tmp_path, "j",
                     device=False)
    assert port == ref
    a, b = port
    assert a["fit"] == 1 and a["wire.exchange"] > 0
    assert b["wire.handle"] == a["wire.request"]
