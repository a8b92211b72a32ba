"""Unified metrics registry for the secure k-means runtime (DESIGN.md §15).

One process-wide `MetricsRegistry` absorbs the stats that previous PRs
scattered across objects — CommLog byte tallies by phase, TripleBank
stock/consumed counts, replenisher occupancy, `ServiceStats` latency
quantiles, frame CRC/auth/retry/dedup counters — behind three primitive
kinds:

* **Counter** — monotonically increasing float/int (`inc`).
* **Gauge** — settable point-in-time value, or a *callback* gauge that
  reads a live object at snapshot time (how CommLog/bank/service state is
  exposed without double-bookkeeping: the registry never caches a copy
  that could drift from the source of truth).
* **Histogram** — fixed-bucket counts + sum, Prometheus semantics.

Names follow Prometheus conventions: `repro_<subsystem>_<what>_<unit>`
with labels for the varying dimension (phase, key, ftype). `snapshot()`
returns plain dicts for tests/JSON; `render_prometheus()` emits the text
exposition format served by ``serve_kmeans --metrics-port`` (stdlib
`http.server`, daemon thread). `StatsLineLogger` prints a periodic
one-line digest (including the `bank_stock` line) for log-only
deployments.

Callback gauges run on the exposition server's thread: none may touch a
device tensor or wait for a bank generation (`TripleBank.stock_copies`
takes only the queue lock).
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple:
    """Fixed log-spaced histogram bucket edges from `lo` to at least `hi`
    with `per_decade` buckets per decade. Deterministic (no data-dependent
    sizing) so two processes' histograms are mergeable bucket-by-bucket —
    what the wire-latency / backoff / launch-wall histograms use."""
    import math
    if not (lo > 0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    step = 10.0 ** (1.0 / per_decade)
    edges, v = [], float(lo)
    while v < hi * (1.0 + 1e-12):
        edges.append(round(v, 12))
        v *= step
    edges.append(round(v, 12))
    return tuple(edges)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-value gauge, or callback gauge when `fn` is given — the
    callback is invoked at read time so the exposed number is always the
    live one."""

    __slots__ = ("name", "labels", "_value", "_fn", "_lock")

    def __init__(self, name: str, labels: dict, fn=None):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram: cumulative bucket counts, total sum and
    count (Prometheus `_bucket`/`_sum`/`_count` semantics)."""

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, labels: dict, buckets=None):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            cum, out = 0, {}
            for b, c in zip(self.buckets, self._counts):
                cum += c
                out[b] = cum
            return {"buckets": out, "sum": self._sum,
                    "count": self._count}


class MetricsRegistry:
    """The process-wide metric namespace. `counter`/`gauge`/`histogram`
    get-or-create by (name, labels) — repeated registration returns the
    same instrument, so hot paths can call `registry.counter(...)` without
    caching handles (though caching is cheaper)."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter(name, dict(labels or {}))
            return m

    def gauge(self, name: str, labels: dict | None = None,
              fn=None) -> Gauge:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Gauge(name, dict(labels or {}),
                                               fn=fn)
            elif fn is not None:
                m._fn = fn
            return m

    def histogram(self, name: str, labels: dict | None = None,
                  buckets=None) -> Histogram:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Histogram(name,
                                                   dict(labels or {}),
                                                   buckets=buckets)
            return m

    def snapshot(self) -> dict:
        """{name{labels}: value} for counters/gauges, nested dict for
        histograms — a plain-data view for tests and JSON dumps."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            key = m.name + _fmt_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = m.snapshot()
            else:
                out[key] = m.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, list] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = ("counter" if isinstance(group[0], Counter) else
                    "histogram" if isinstance(group[0], Histogram) else
                    "gauge")
            lines.append(f"# TYPE {name} {kind}")
            for m in group:
                if isinstance(m, Histogram):
                    snap = m.snapshot()
                    for b, c in snap["buckets"].items():
                        lab = dict(m.labels, le=repr(b))
                        lines.append(f"{name}_bucket{_fmt_labels(lab)} {c}")
                    lab = dict(m.labels, le="+Inf")
                    lines.append(
                        f"{name}_bucket{_fmt_labels(lab)} {snap['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labels)} {snap['sum']}")
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labels)} "
                        f"{snap['count']}")
                else:
                    v = m.value
                    sv = repr(int(v)) if float(v).is_integer() else repr(v)
                    lines.append(f"{name}{_fmt_labels(m.labels)} {sv}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# -- live-object adapters ----------------------------------------------------
#
# Callback gauges reading the owning object directly: the registry's
# answer for e.g. repro_comm_bytes_total{phase="online"} is by
# construction CommLog.total_bytes("online") — there is no second tally
# to drift.

def register_commlog(log, registry: MetricsRegistry | None = None,
                     phases=("offline", "online", "setup")) -> None:
    reg = registry or _REGISTRY
    for phase in phases:
        reg.gauge("repro_comm_bytes_total", {"phase": phase},
                  fn=lambda p=phase: log.total_bytes(p))
        reg.gauge("repro_comm_rounds_total", {"phase": phase},
                  fn=lambda p=phase: log.total_rounds(p))


def register_bank(bank, registry: MetricsRegistry | None = None) -> None:
    """Expose TripleBank stock (complete plan copies per registered key),
    cumulative consumed-request totals, and replenish events. Per-key
    gauges cover the keys present at registration — call again after
    provisioning new plans if the key set grew."""
    reg = registry or _REGISTRY

    def _stock(k):
        return lambda: bank.stock_copies(k)

    for k in bank.keys():
        reg.gauge("repro_bank_stock_copies", {"key": str(k)},
                  fn=_stock(k))
    reg.gauge("repro_bank_consumed_requests_total",
              fn=lambda: sum(bank.consumed_counts().values()))
    reg.gauge("repro_bank_served_requests_total",
              fn=lambda: bank.served_requests)
    reg.gauge("repro_bank_replenish_events_total",
              fn=lambda: bank.replenish_events)


def register_replenisher(rep,
                         registry: MetricsRegistry | None = None) -> None:
    reg = registry or _REGISTRY
    reg.gauge("repro_bank_topups_total", fn=lambda: rep.topups)
    reg.gauge("repro_bank_topup_copies_total", fn=lambda: rep.topup_copies)
    reg.gauge("repro_bank_topup_seconds_total",
              fn=lambda: rep.topup_seconds)
    reg.gauge("repro_bank_replenisher_errors_total",
              fn=lambda: rep.errors)


def register_service(svc, registry: MetricsRegistry | None = None) -> None:
    """Expose every ServiceStats.as_dict key as a callback gauge
    (repro_serve_<key>), each reading the live stats object."""
    reg = registry or _REGISTRY
    keys = svc.stats.as_dict().keys()

    def _read(k):
        return lambda: svc.stats.as_dict()[k]

    for k in keys:
        reg.gauge(f"repro_serve_{k}", fn=_read(k))
    if hasattr(svc, "health_code"):
        reg.gauge("repro_serve_health", fn=svc.health_code)


# -- exposition server -------------------------------------------------------

class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = _REGISTRY
    health_cb = None        # () -> state string, e.g. "READY"

    def _serve(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib interface)
        if self.path == "/health":
            # readiness probe: 200 only when the service reports READY,
            # 503 otherwise (STARTING/DEGRADED/DRAINING) — what the
            # supervisor and load balancers gate on. Body is the state.
            if self.health_cb is None:
                self._serve(404, b"no health callback registered\n")
                return
            try:
                state = str(self.health_cb())
            except Exception as e:  # health must never take the server down
                self._serve(503, f"DEGRADED ({e})\n".encode())
                return
            self._serve(200 if state == "READY" else 503,
                        (state + "\n").encode())
            return
        if self.path not in ("/", "/metrics"):
            self.send_response(404)
            self.end_headers()
            return
        self._serve(200, self.registry.render_prometheus().encode())

    def log_message(self, *a):  # silence per-request stderr lines
        pass


class MetricsServer:
    """`GET /metrics` → Prometheus text, `GET /health` → readiness state
    (200 iff READY), on a daemon thread. Port 0 picks a free port (read
    `.port` after start)."""

    def __init__(self, port: int = 0,
                 registry: MetricsRegistry | None = None,
                 health_cb=None):
        handler = type("Handler", (_MetricsHandler,),
                       {"registry": registry or _REGISTRY,
                        "health_cb": staticmethod(health_cb)
                        if health_cb is not None else None})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# -- periodic stats line -----------------------------------------------------

class StatsLineLogger:
    """Emit a one-line digest every `interval_s` via `emit` (default
    print): serve counters, p50/p99, queue depth, and — when a bank is
    attached — the `bank_stock` line making stock-out visible BEFORE the
    first synchronous-replenish stall."""

    def __init__(self, svc=None, bank=None, interval_s: float = 10.0,
                 emit=print):
        self.svc = svc
        self.bank = bank
        self.interval_s = float(interval_s)
        self.emit = emit
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="stats-line", daemon=True)

    def render(self) -> str:
        parts = [f"stats t={time.strftime('%H:%M:%S')}"]
        if self.svc is not None:
            d = self.svc.stats.as_dict()
            parts.append(
                f"req={d['requests']} rows={d['rows']} "
                f"q={d['queue_depth']} shed={d['shed_requests']} "
                f"expired={d['expired_requests']} "
                f"p50={d['p50_ms']:.1f}ms p99={d['p99_ms']:.1f}ms")
        if self.bank is not None:
            stock = {str(k): self.bank.stock_copies(k)
                     for k in self.bank.keys()}
            inner = " ".join(f"{k}:{v}" for k, v in sorted(stock.items()))
            parts.append(f"bank_stock [{inner or 'empty'}]")
        return " | ".join(parts)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.emit(self.render())
            except Exception:
                pass

    def start(self) -> "StatsLineLogger":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
