"""The program's own spans in the traced slice: the program-span level of
`repro_torch.obs.trace`, which the port records while a torch.profiler
session runs (so in the slice, with no edit here).

The slice's last `trace_iters` iterations are the last that many
`prog.s1` and `prog.s3` spans of the global tracer (the one before them
warms the profiler); a span belongs to an iteration when it descends
from one of its two by parent id. A span's ``dur`` is its host duration,
its ``dev_us`` its interval on the device's stream, from a CUDA event
pair: from the card reaching its first operation to finishing its last,
so a span the host paces reads its enqueue there too.

A program without those spans, or a run on the CPU, where no span has a
device interval, gives None.
"""
from __future__ import annotations

from collections import defaultdict

PROGRAMS = ("prog.s1", "prog.s3")


def iterations(rec) -> list | None:
    """[[s1 span, s3 span, *their descendants]] for each of the slice's
    last `trace_iters` iterations, or None (see the module docstring)."""
    iters = rec.get("trace_iters")
    if not iters:
        return None
    from repro_torch.obs import trace
    evs = trace.get_tracer().events()
    roots = [[e for e in evs if e["name"] == name][-iters:]
             for name in PROGRAMS]
    if any(len(r) < iters for r in roots):
        return None
    kids = defaultdict(list)
    for e in evs:
        if e.get("parent") is not None:
            kids[e["parent"]].append(e)
    out = []
    for pair in zip(*roots):
        spans, todo = list(pair), list(pair)
        while todo:
            more = kids.get(todo.pop().get("id"), [])
            spans += more
            todo += more
        out.append(spans)
    if not any("dev_us" in e for spans in out for e in spans):
        return None
    return out


def dev_ms(rec, names: tuple) -> float | None:
    """The device-stream intervals of the spans named `names`, summed over
    an iteration, in ms, averaged over the slice's iterations; None where
    no such span has one."""
    its = iterations(rec)
    if its is None:
        return None
    hits = [[e for e in spans if e["name"] in names] for spans in its]
    if not all(hits) or any("dev_us" not in e for h in hits for e in h):
        return None
    return sum(e["dev_us"] for h in hits for e in h) / 1e3 / len(its)
