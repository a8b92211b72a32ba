"""Span tracing for the secure k-means runtime (DESIGN.md §15).

One process-wide `Tracer` instruments the hot seams — fit iterations,
pipeline stages, HE exchanges, bank provisioning, serving drains, wire
retries — with `with tracer.span("s1_launch", iter=i):` context managers.
Disabled (the default) a span call is a single attribute check returning a
shared no-op context manager: no allocation, no clock read, no lock — the
online path pays nothing it could measure. Enabled, each span records
wall-clock epoch start (`time.time_ns`, so spans from DIFFERENT processes
land on one absolute timeline), a monotonic duration, and its thread lane,
and exports as Chrome-trace / Perfetto JSON (``chrome://tracing``,
https://ui.perfetto.dev) — thread-lane aware, so the pipelined executor's
pre(t+1)-under-launch(t) overlap is *visible* — plus an aggregated text
flame summary for terminals.

Distributed request traces ride a **trace id**: an 8-byte token minted by
the client (`new_trace_id`), carried inside wire frames (the
`channel.TRACE_BIT` header extension), and installed thread-locally on the
serving side (`set_current_trace`) so every span opened while handling the
request tags itself with it. `merge_traces` joins the per-process span
files into one timeline keyed by those ids.

The module-level `span`/`instant` helpers delegate to the GLOBAL tracer
(`get_tracer`); components that need per-endpoint span files (e.g. a
client and a server in one test process) accept an explicit `tracer=`.

Every recorded span carries an ``id`` and its ``parent``'s id (the span
open on the same thread when it opened, from a thread-local stack); the
Chrome export puts both in the event's ``args``.

Spans time the host, as the JAX package's do: a CUDA launch returns
before the card runs it, so a span around queued kernels measures their
enqueue. No span argument may read a device tensor (an `.item()` would
wait for the card on every call, tracing on or off); shapes are fine.

**Program spans** are a second level, apart from those reference-named
spans (`fit.*`, `serve.*`, ...), which do not change: the spans inside
the secure Lloyd programs (`launch/kmeans_step.py`, `core/protocol.py`:
``prog.*``, ``s1.*``, ``s2.*``, ``s3.*``, ``beaver.*``). A program call
asks `program_spans` once whether to record them: only while the tracer
is configured for them (``configure(programs=True)``) or while a
`torch.profiler` session records. Otherwise it gets None, and each of its
ops pays one attribute check: no `record_function`, no CUDA event, no
synchronize, no read of a device tensor. A recorded program span keeps
the host clocks of any span and, where the call's tensors are on a CUDA
device, a CUDA event pair on the current stream: the span's interval on
the device's stream (``dev_us``, from the card reaching its first
operation to finishing its last, waits for the host included). The pair
is resolved when the events are read or exported, once the card has
passed it (after the caller's own synchronize): never a synchronize
inside the program. While a profiler records, the span is also a
`record_function` range of its name, so it lands in the profiler's trace
on CUPTI's clock, on the host and, as ``gpu_user_annotation``, on the
device. Program spans fill the global tracer like any other (bounded by
`max_events`); `reset` frees them and their events.
"""
from __future__ import annotations

import itertools
import json
import secrets
import threading
import time
from collections import defaultdict, deque

TRACE_ID_BYTES = 8


def new_trace_id() -> str:
    """Mint a fresh request trace id: 16 hex chars (8 random bytes)."""
    return secrets.token_hex(TRACE_ID_BYTES)


def trace_id_to_bytes(tid: str) -> bytes:
    return bytes.fromhex(tid)


def trace_id_from_bytes(raw: bytes) -> str:
    return raw.hex()


# -- thread-local trace propagation -----------------------------------------

_TLS = threading.local()


def set_current_trace(tid: str | None) -> None:
    """Install `tid` as this thread's ambient trace id (None clears it).
    Spans opened while it is set tag themselves with ``trace=tid``."""
    _TLS.trace = tid


def current_trace() -> str | None:
    return getattr(_TLS, "trace", None)


_IDS = itertools.count(1)


def _stack() -> list:
    """This thread's stack of open span ids (the innermost last)."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _innermost() -> int | None:
    stack = _stack()
    return stack[-1] if stack else None


class _NoopSpan:
    """Shared do-nothing context manager — what a disabled tracer returns.
    One module-level instance, so the disabled fast path allocates
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()
NOOP = _NOOP  # what a program op enters when its call records no spans


class _Span:
    """One live span: records on `__exit__`. Cheap on purpose — two clock
    reads plus one locked list append per span."""

    __slots__ = ("tracer", "name", "args", "id", "parent", "t_epoch_us",
                 "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.t_epoch_us = time.time_ns() // 1_000
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_us = max(0, (time.perf_counter_ns() - self.t0) // 1_000)
        _stack().pop()
        self.tracer._record(self.name, self.t_epoch_us, dur_us, self.args,
                            self.id, self.parent)
        return False


class ProgramSpans:
    """The program-span level of ONE program call (see the module
    docstring): what `program_spans` hands a call that records them. On a
    CUDA device it times each span by an event pair on the stream that is
    current at the call's first span (looked up once: a lookup costs as
    much as the record); while a profiler records it opens a
    `record_function` range too."""

    __slots__ = ("tracer", "cuda", "stream", "range")

    def __init__(self, tracer: "Tracer", cuda: bool, profiling: bool):
        import torch
        self.tracer = tracer
        self.cuda = torch.cuda if cuda else None
        self.stream = None
        self.range = torch.profiler.record_function if profiling else None

    def span(self, name: str, **args) -> "_ProgramSpan":
        return _ProgramSpan(self, name, args)

    def record(self):
        """A timing event recorded on the call's stream."""
        if self.stream is None:
            self.stream = self.cuda.current_stream()
        ev = self.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev


class _ProgramSpan:
    """One live program span; records on `__exit__`, its CUDA event pair
    left pending until the tracer's events are read."""

    __slots__ = ("level", "name", "args", "id", "parent", "t_epoch_us", "t0",
                 "ev0", "rf")

    def __init__(self, level: ProgramSpans, name: str, args: dict):
        self.level = level
        self.name = name
        self.args = args

    def __enter__(self):
        level = self.level
        if level.range is not None:
            self.rf = level.range(self.name)
            self.rf.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        if level.cuda is not None:
            self.ev0 = level.record()
        self.t_epoch_us = time.time_ns() // 1_000
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_us = max(0, (time.perf_counter_ns() - self.t0) // 1_000)
        level = self.level
        dev = None if level.cuda is None else (self.ev0, level.record())
        _stack().pop()
        level.tracer._record(self.name, self.t_epoch_us, dur_us, self.args,
                             self.id, self.parent, dev)
        if level.range is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """Lock-protected span recorder with a no-op fast path.

    `enabled=False` (the default): `span()` returns the shared no-op
    context manager after a single attribute check — instrumentation left
    in the hot seams costs one branch. `enabled=True`: complete spans
    accumulate as Chrome-trace events (bounded by `max_events`,
    drop-newest beyond it, counted in `dropped`).

    `process` labels this tracer's pid lane in the exported JSON — set it
    to "client" / "server" / "party_a" so merged multi-process timelines
    stay readable. Spans inherit the thread's ambient trace id
    (`set_current_trace`) unless the call passes its own ``trace=``.

    Long-lived servers bound the tracer two ways (both leave the DISABLED
    fast path untouched — still one attribute check, no clock read):

    * `rotate_spans=N` keeps only the newest N events **per category**
      (the span name's first dot-component: ``serve.request`` and
      ``serve.drain`` share the "serve" ring) instead of the flat
      `max_events` drop-newest list — a week-old fit span can't starve
      today's serve spans out of the buffer. Evictions count in
      `rotated_out`.
    * `sample_rate=r` records ~every ``round(1/r)``-th event per category
      (deterministic counter sampling, not RNG — reruns trace the same
      spans). Skips count in `sampled_out`.

    `programs=True` (`configure`) records the program spans of every
    program call, profiler or not; `enabled` does not govern them."""

    def __init__(self, enabled: bool = False, process: str = "repro",
                 max_events: int = 1_000_000,
                 rotate_spans: int | None = None,
                 sample_rate: float = 1.0):
        self.enabled = bool(enabled)
        self.programs = False
        self.process = str(process)
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: list[dict] = []
        self._threads: dict[int, str] = {}
        self._lock = threading.Lock()
        self.configure_bounds(rotate_spans=rotate_spans,
                              sample_rate=sample_rate)

    def configure_bounds(self, rotate_spans: int | None = None,
                         sample_rate: float | None = None) -> None:
        """(Re)apply the bounded-memory knobs. Resets the rotation rings
        and sampling counters — call before tracing, not mid-flight."""
        if rotate_spans is not None and int(rotate_spans) < 1:
            raise ValueError("rotate_spans must be >= 1 (or None)")
        self.rotate_spans = None if rotate_spans is None \
            else int(rotate_spans)
        rate = 1.0 if sample_rate is None else float(sample_rate)
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got {rate}")
        self.sample_rate = rate
        self._sample_every = max(1, round(1.0 / rate))
        self._sample_n: dict[str, int] = {}
        self.sampled_out = 0
        self.rotated_out = 0
        self._rings: dict[str, deque] = {}

    @staticmethod
    def _category(name: str) -> str:
        return name.split(".", 1)[0]

    # -- recording --------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one named region. Keyword args land in
        the event's ``args`` (Chrome trace) — keep them small scalars."""
        if not self.enabled:
            return _NOOP
        tid = current_trace()
        if tid is not None and "trace" not in args:
            args["trace"] = tid
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (Chrome-trace instant event)."""
        if not self.enabled:
            return
        tid = current_trace()
        if tid is not None and "trace" not in args:
            args["trace"] = tid
        self._record(name, time.time_ns() // 1_000, None, args,
                     next(_IDS), _innermost())

    def complete_span(self, name: str, start_epoch_us: int, dur_us: int,
                      **args) -> None:
        """Record a span retroactively from explicit epoch-µs timestamps —
        for request lifetimes that cross threads (admitted on a responder
        thread, published from the drain thread), where no single
        with-block can cover the extent."""
        if not self.enabled:
            return
        tid = current_trace()
        if tid is not None and "trace" not in args:
            args["trace"] = tid
        self._record(name, int(start_epoch_us), max(0, int(dur_us)), args,
                     next(_IDS), _innermost())

    def _record(self, name: str, ts_us: int, dur_us: int | None,
                args: dict, span_id: int, parent: int | None,
                dev: tuple | None = None) -> None:
        th = threading.current_thread()
        ev = {"name": name, "ts": ts_us, "tid": th.ident,
              "args": args, "id": span_id, "parent": parent}
        if dev is not None:
            ev["_dev"] = dev
        if dur_us is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = dur_us
        cat = self._category(name)
        with self._lock:
            if self._sample_every > 1:
                n = self._sample_n.get(cat, 0)
                self._sample_n[cat] = n + 1
                if n % self._sample_every:
                    self.sampled_out += 1
                    return
            if self.rotate_spans is not None:
                ring = self._rings.get(cat)
                if ring is None:
                    ring = self._rings[cat] = deque(maxlen=self.rotate_spans)
                if len(ring) == self.rotate_spans:
                    self.rotated_out += 1
                ring.append(ev)
            else:
                if len(self._events) >= self.max_events:
                    self.dropped += 1
                    return
                self._events.append(ev)
            self._threads.setdefault(th.ident, th.name)

    def _all_events(self) -> list[dict]:
        """Every retained event (flat list + rotation rings), ts-ordered,
        each program span's CUDA event pair resolved to ``dev_us`` once the
        card has passed it. Caller must hold `_lock`."""
        evs = list(self._events)
        for ring in self._rings.values():
            evs.extend(ring)
        evs.sort(key=lambda e: e["ts"])
        for e in evs:
            if "_dev" in e and e["_dev"][1].query():
                start, end = e.pop("_dev")
                e["dev_us"] = 1e3 * start.elapsed_time(end)
        return evs

    @staticmethod
    def _public(e: dict) -> dict:
        """A copy of an event without a pair still pending on the card."""
        e = dict(e)
        e.pop("_dev", None)
        return e

    # -- queries ----------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return [self._public(e) for e in self._all_events()]

    def span_counts(self) -> dict:
        """{span name: count} over everything retained so far."""
        out: dict[str, int] = defaultdict(int)
        with self._lock:
            for e in self._all_events():
                out[e["name"]] += 1
        return dict(out)

    def spans_for_trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [self._public(e) for e in self._all_events()
                    if e["args"].get("trace") == trace_id]

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._threads.clear()
            self._rings.clear()
            self._sample_n.clear()
            self.dropped = 0
            self.rotated_out = 0
            self.sampled_out = 0

    # -- export -----------------------------------------------------------
    def chrome_events(self, pid: int = 1) -> list[dict]:
        """The Chrome-trace event list: metadata rows naming the process
        and thread lanes, then every recorded span."""
        with self._lock:
            events = [self._public(e) for e in self._all_events()]
            threads = dict(self._threads)
        out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": self.process}}]
        for tid, tname in sorted(threads.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for e in events:
            e["pid"] = pid
            e["cat"] = e["name"].split(".")[0].split("_")[0]
            args = dict(e["args"], id=e.pop("id"))
            parent = e.pop("parent")
            if parent is not None:
                args["parent"] = parent
            if "dev_us" in e:
                args["dev_us"] = e.pop("dev_us")
            e["args"] = args
            out.append(e)
        return out

    def export_chrome(self, path: str, pid: int = 1) -> str:
        """Write ``{"traceEvents": [...]}`` JSON loadable by
        chrome://tracing and ui.perfetto.dev. Returns `path`."""
        doc = {"traceEvents": self.chrome_events(pid=pid),
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def flame_summary(self, top: int = 24) -> str:
        """Aggregated per-span-name text table: count, total wall,
        mean — the terminal's flame graph."""
        agg: dict[str, list] = defaultdict(lambda: [0, 0])
        with self._lock:
            for e in self._all_events():
                a = agg[e["name"]]
                a[0] += 1
                a[1] += e.get("dur", 0)
        rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
        if not rows:
            return "(no spans recorded)"
        w = max(len(n) for n, _ in rows)
        lines = [f"{'span':<{w}}  {'count':>7}  {'total_ms':>10}  "
                 f"{'mean_us':>9}"]
        for name, (cnt, tot) in rows:
            lines.append(f"{name:<{w}}  {cnt:>7}  {tot / 1e3:>10.3f}  "
                         f"{tot / max(1, cnt):>9.1f}")
        if self.dropped:
            lines.append(f"(+{self.dropped} events dropped past "
                         f"max_events={self.max_events})")
        if self.rotated_out:
            lines.append(f"(+{self.rotated_out} events rotated out past "
                         f"rotate_spans={self.rotate_spans} per category)")
        if self.sampled_out:
            lines.append(f"(+{self.sampled_out} events skipped at "
                         f"sample_rate={self.sample_rate})")
        return "\n".join(lines)


# -- the global tracer -------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure(enabled: bool | None = None, process: str | None = None,
              max_events: int | None = None,
              rotate_spans: int | None = None,
              sample_rate: float | None = None,
              programs: bool | None = None) -> Tracer:
    """Adjust the global tracer in place (None = leave unchanged; passing
    either bounded-memory knob resets the rotation rings + sample
    counters). `programs` records the program spans of every program call
    (without it, only while a `torch.profiler` session records)."""
    if enabled is not None:
        _TRACER.enabled = bool(enabled)
    if programs is not None:
        _TRACER.programs = bool(programs)
    if process is not None:
        _TRACER.process = str(process)
    if max_events is not None:
        _TRACER.max_events = int(max_events)
    if rotate_spans is not None or sample_rate is not None:
        _TRACER.configure_bounds(
            rotate_spans=rotate_spans if rotate_spans is not None
            else _TRACER.rotate_spans,
            sample_rate=sample_rate if sample_rate is not None
            else _TRACER.sample_rate)
    return _TRACER


def span(name: str, **args):
    """Module-level shortcut: a span on the GLOBAL tracer. The disabled
    fast path is one attribute check + the shared no-op context manager."""
    if not _TRACER.enabled:
        return _NOOP
    return _TRACER.span(name, **args)


def instant(name: str, **args) -> None:
    if _TRACER.enabled:
        _TRACER.instant(name, **args)


def program_spans(cuda: bool, profiling: bool) -> ProgramSpans | None:
    """The program-span level of one program call on the global tracer, or
    None when the call records no program spans: the tracer is not
    configured for them and no profiler records (`profiling`, which the
    caller reads from torch). `cuda`: the call's tensors are on a CUDA
    device."""
    if not (_TRACER.programs or profiling):
        return None
    return ProgramSpans(_TRACER, cuda, profiling)


# -- multi-process timeline merge --------------------------------------------

def merge_traces(sources, out_path: str | None = None) -> dict:
    """Join several span files (or in-memory Tracers) into ONE Chrome
    trace: each source gets its own pid lane (its `process_name` metadata
    is preserved), span events keep their absolute epoch timestamps — the
    shared clock that lets a client request span line up under the server
    span carrying the same ``args.trace`` id. Returns the merged document
    (and writes it to `out_path` when given)."""
    events = []
    for pid, src in enumerate(sources, start=1):
        if isinstance(src, Tracer):
            evs = src.chrome_events(pid=pid)
        else:
            with open(src) as f:
                doc = json.load(f)
            evs = doc["traceEvents"] if isinstance(doc, dict) else doc
        for e in evs:
            e = dict(e)
            e["pid"] = pid
            events.append(e)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f)
    return doc
