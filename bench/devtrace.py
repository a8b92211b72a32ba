"""The device's side of a traced slice: `torch.profiler` (CUPTI) records
it, the trace is exported in the Chrome format and reduced here.

What the reduction reads:
- `bench.window`: a host range the harness opens after a synchronize and
  closes after another, so that every device operation inside it was
  launched inside it; its length is the traced window.
- device operations (kernels, memsets, copies), clipped to the window:
  their union is the busy time, their gaps the idle time.
- host ranges the harness and its spy open (`bench.*`): a device
  operation belongs to a range when its launch (the runtime call that
  shares its correlation id) lies inside the range on the host's clock,
  or, without a launch record, when it runs inside the range's device
  side (`gpu_user_annotation`).
- for each idle gap, the innermost host operation or range that covers
  the gap's middle on the window's thread: what the host was doing.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


def export(prof) -> list:
    """The profiler's events in the Chrome trace format, through a file in
    TMPDIR that is removed again."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(xs: list, w: dict, times: list) -> list:
    """For each of the ascending `times`, the name of the innermost host
    event on the window's thread that covers it (the events of one thread
    nest, so a sweep with a stack finds it)."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in xs if e.get("cat") in HOST_CATS
                   and e.get("tid") == w.get("tid")
                   and e.get("pid") == w.get("pid")),
                  key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] >= t]
        out.append(stack[-1][2] if stack else "host: between operations")
    return out


def reduce(events: list, ranges: tuple = ()) -> dict | None:
    """Reduce Chrome trace events (times in microseconds) to seconds:
    window_s, busy_s, device_ops (count), device_s (sum of durations),
    range_s {range: device seconds of its operations}, top_ops and
    idle_gaps ([[name, seconds], ...], at most TOP each). None when the
    trace holds no window or no device operation in it."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w = win[-1]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    ops = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
            if b > a:
                ops.append((a, b, e))
    if not ops:
        return None
    launch_at = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch_at[corr] = float(e["ts"])
    host_rng = defaultdict(list)
    dev_rng = defaultdict(list)
    for e in xs:
        if e.get("name") in ranges:
            iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            if e.get("cat") == "user_annotation":
                host_rng[e["name"]].append(iv)
            elif e.get("cat") == "gpu_user_annotation":
                dev_rng[e["name"]].append(iv)

    def inside(t, ivs):
        return any(a <= t <= b for a, b in ivs)

    range_s = {r: 0.0 for r in ranges}
    by_name = defaultdict(float)
    for a, b, e in ops:
        by_name[e["name"]] += (b - a) / 1e6
        at = launch_at.get(e.get("args", {}).get("correlation"))
        for r in ranges:
            hit = inside(at, host_rng[r]) if at is not None else \
                any(x <= a and b <= y for x, y in dev_rng[r])
            if hit:
                range_s[r] += (b - a) / 1e6
    busy = _union([(a, b) for a, b, _ in ops])
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    gap_by = defaultdict(float)
    for (a, b), name in zip(gaps, _host_at(
            xs, w, [(a + b) / 2 for a, b in gaps])):
        gap_by[name] += (b - a) / 1e6

    def top(d):
        return [[n[:120], s] for n, s in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": len(ops),
            "device_s": sum(b - a for a, b, _ in ops) / 1e6,
            "range_s": range_s,
            "top_ops": top(by_name),
            "idle_gaps": top(gap_by)}
