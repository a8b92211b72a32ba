"""Named crash-injection points for the chaos harness (DESIGN.md §16).

A *kill-point* is a named seam in the protocol — a fit-phase boundary or
a responder serve step — where the chaos matrix may terminate the
process mid-flight. Production code calls `probe("fit.mid_s1")` at the
seam; the call is a no-op (one dict truthiness check) unless the point
was armed via `arm("fit.mid_s1:3")`, in which case the 3rd hit prints a
terminal diagnostic line (plus whatever the registered reporter returns
— wire counters, so a dying incarnation still reports its traffic) and
hard-exits with `KILL_EXIT_CODE`, modelling a kill -9 that no `finally`
block softens.

Arming is per-process and explicit (CLI flag / env, wired by
`launch/two_party.py`); an un-armed process pays nothing on the hot
path. `os._exit` is deliberate: the whole point is that NO cleanup runs
— buffered writes are lost, sockets die with RST — so recovery must
come from published checkpoints alone.
"""
from __future__ import annotations

import json
import os

# same code the scripted `--die-at-iter` kills already use, so a
# supervisor treats every injected death uniformly as "restartable crash"
KILL_EXIT_CODE = 17

_armed: dict[str, int] = {}     # point -> remaining hits before death
_reporter = None                # () -> dict of diagnostics for the DYING line


def arm(spec: str) -> None:
    """Arm kill-points from a spec string: comma-separated
    ``point[:nth]`` entries — ``fit.mid_s1:3`` dies on the 3rd hit,
    ``fit.publish`` on the 1st."""
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            point, nth = part.rsplit(":", 1)
            _armed[point] = max(1, int(nth))
        else:
            _armed[part] = 1


def disarm_all() -> None:
    _armed.clear()


def armed() -> dict[str, int]:
    return dict(_armed)


def set_reporter(fn) -> None:
    """Register a callable returning a JSON-able dict (wire counters,
    retries, …) to be printed on the DYING line, so the chaos bench can
    total traffic across incarnations that never reach a clean exit."""
    global _reporter
    _reporter = fn


def probe(point: str) -> None:
    """Hot-path seam: dies iff `point` is armed and this is the Nth hit."""
    if not _armed:
        return
    n = _armed.get(point)
    if n is None:
        return
    if n > 1:
        _armed[point] = n - 1
        return
    del _armed[point]
    info = {}
    if _reporter is not None:
        try:
            info = dict(_reporter())
        except Exception:
            info = {}
    # single machine-parsable line; flush before the hard exit
    print(f"DYING point={point} stats={json.dumps(info, sort_keys=True)}",
          flush=True)
    os._exit(KILL_EXIT_CODE)
