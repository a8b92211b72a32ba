"""Child-process supervisor for the self-healing two-party runtime
(DESIGN.md §16).

Each party's engine runs as a `SupervisedChild`: the supervisor spawns
it, captures its merged stdout/stderr (to a log file and an in-memory
ring for the chaos bench to parse), and on death applies a
`RestartPolicy` — bounded restarts with exponential backoff and seeded
jitter, crash-loop detection (N fast deaths in a row → terminal
diagnostic instead of a respawn storm), and a set of *terminal* exit
codes that must never be retried (0 = clean, and e.g. two_party's 4 =
`ResumeMismatch`, where restarting cannot help).

Recovery is the children's job, not the supervisor's: party A relaunches
with `--auto-resume` and renegotiates the resume step with B; a scoring
server relaunches into its `ServeCheckpointer` replay. The supervisor
only guarantees that *some* incarnation is running until one exits
terminally, and records the timeline (spawn / ready / exit events) from
which the chaos bench computes MTTR.

Readiness: `ready_pattern` (a regex matched against stdout lines, e.g.
``^LISTENING`` / ``^SERVING``) and/or `health_url` (polled until it
answers 200 — the `/health` endpoint on `--metrics-port`, which only
goes 200 once a `ScoringService` reports READY).

The JAX package's supervisor line for line. It imports neither torch nor
jax: a supervising parent only spawns, so it never creates a CUDA
context; each child builds (or loads) the kernels itself before it
reports ready.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np


def free_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port. The supervisor picks ports up front so
    every incarnation of a child listens on the SAME address and the
    surviving peer's redial loop finds the restarted process."""
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounded-restart policy. `max_restarts` counts respawns (not the
    first spawn); backoff grows `backoff_s * 2**n` capped at
    `backoff_max_s`, scaled by seeded jitter in [0.5, 1.5). A death
    within `crash_loop_window_s` of its spawn is a *fast* death;
    `crash_loop_threshold` consecutive fast deaths are declared a crash
    loop and the child goes terminal with a diagnostic."""

    max_restarts: int = 5
    backoff_s: float = 0.2
    backoff_max_s: float = 3.0
    jitter_seed: int = 23
    crash_loop_window_s: float = 3.0
    crash_loop_threshold: int = 3


@dataclasses.dataclass
class ChildEvent:
    kind: str           # spawn | ready | exit | terminal
    t: float            # monotonic timestamp
    incarnation: int
    detail: str = ""


class SupervisedChild:
    """One supervised OS process with restart policy.

    `argv_for` is either a plain argv list (same every incarnation) or a
    callable `incarnation -> argv` — the chaos bench uses the callable
    to arm kill-points on incarnation 0 only, so a restart doesn't
    re-kill itself at the same seam forever."""

    def __init__(self, name: str, argv_for, *,
                 policy: RestartPolicy | None = None,
                 terminal_codes: tuple = (0, 4),
                 env: dict | None = None, cwd: str | None = None,
                 log_path: str | None = None,
                 ready_pattern: str | None = None,
                 health_url: str | None = None,
                 on_line=None):
        self.name = name
        self._argv_for = argv_for if callable(argv_for) \
            else (lambda _i: list(argv_for))
        self.policy = policy or RestartPolicy()
        self.terminal_codes = set(terminal_codes)
        self.env = env
        self.cwd = cwd
        self.log_path = log_path
        self.ready_re = re.compile(ready_pattern) if ready_pattern else None
        self.health_url = health_url
        self.on_line = on_line
        self._jitter = np.random.default_rng(self.policy.jitter_seed)
        self.events: list[ChildEvent] = []
        self.lines: list[str] = []
        self.incarnation = -1
        self.restarts = 0
        self.returncode: int | None = None
        self.terminal_reason: str | None = None
        self._proc: subprocess.Popen | None = None
        self._stop = threading.Event()
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run,
                                        name=f"supervise-{name}",
                                        daemon=True)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SupervisedChild":
        self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """True once the child reached a terminal state."""
        return self._done.wait(timeout)

    def stop(self) -> None:
        """Tear the child down (terminate → kill) and end supervision."""
        self._stop.set()
        p = self._proc
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                p.kill()
        self._thread.join(timeout=10.0)

    @property
    def success(self) -> bool:
        return self.returncode == 0

    # -- events / metrics ------------------------------------------------
    def _event(self, kind: str, detail: str = "") -> None:
        with self._lock:
            self.events.append(ChildEvent(kind, time.monotonic(),
                                          self.incarnation, detail))

    def _emit(self, line: str) -> None:
        with self._lock:
            self.lines.append(line)
        if self.log_path:
            try:
                with open(self.log_path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            except OSError:
                pass
        if self.on_line is not None:
            try:
                self.on_line(line)
            except Exception:
                pass

    def restart_latencies(self) -> list[float]:
        """Seconds from each death to the NEXT incarnation's readiness
        (its ready event when readiness is tracked, else its spawn) —
        the per-restart recovery times MTTR averages."""
        with self._lock:
            evs = list(self.events)
        out, last_exit = [], None
        tracked = self.ready_re is not None or self.health_url is not None
        for e in evs:
            if e.kind == "exit":
                last_exit = e.t
            elif last_exit is not None and (
                    e.kind == "ready" if tracked else e.kind == "spawn"):
                out.append(e.t - last_exit)
                last_exit = None
        return out

    def tail(self, n: int = 20) -> str:
        with self._lock:
            return "\n".join(self.lines[-n:])

    # -- the supervision loop -------------------------------------------
    def _poll_health(self, incarnation: int) -> None:
        while not self._stop.is_set() and incarnation == self.incarnation:
            p = self._proc
            if p is None or p.poll() is not None:
                return
            try:
                with urllib.request.urlopen(self.health_url,
                                            timeout=1.0) as r:
                    if r.status == 200:
                        self._event("ready", "health=READY")
                        return
            except Exception:
                pass
            time.sleep(0.2)

    def _run(self) -> None:
        fast_deaths = 0
        while not self._stop.is_set():
            argv = self._argv_for(self.incarnation + 1)
            self.incarnation += 1
            spawned = time.monotonic()
            try:
                self._proc = subprocess.Popen(
                    argv, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                    env=self.env, cwd=self.cwd)
            except OSError as e:
                self.returncode = -1
                self.terminal_reason = f"spawn failed: {e}"
                self._event("terminal", self.terminal_reason)
                break
            self._event("spawn", " ".join(argv[:4]) + " ...")
            if self.health_url:
                threading.Thread(target=self._poll_health,
                                 args=(self.incarnation,),
                                 daemon=True).start()
            saw_ready = False
            for line in self._proc.stdout:
                line = line.rstrip("\n")
                self._emit(f"[{self.name}#{self.incarnation}] {line}")
                if not saw_ready and self.ready_re is not None \
                        and self.ready_re.search(line):
                    saw_ready = True
                    if not self.health_url:     # health poll owns 'ready'
                        self._event("ready", line[:80])
            rc = self._proc.wait()
            died = time.monotonic()
            self._event("exit", f"rc={rc}")
            if self._stop.is_set():
                self.returncode = rc
                self.terminal_reason = "stopped"
                break
            if rc in self.terminal_codes:
                self.returncode = rc
                self.terminal_reason = "clean exit" if rc == 0 \
                    else f"terminal exit code {rc}"
                self._event("terminal", self.terminal_reason)
                break
            if died - spawned < self.policy.crash_loop_window_s:
                fast_deaths += 1
            else:
                fast_deaths = 0
            if fast_deaths >= self.policy.crash_loop_threshold:
                self.returncode = rc
                self.terminal_reason = (
                    f"crash loop: {fast_deaths} consecutive deaths "
                    f"within {self.policy.crash_loop_window_s}s of spawn "
                    f"(last rc={rc}); last output:\n" + self.tail(10))
                self._event("terminal", "crash loop")
                break
            if self.restarts >= self.policy.max_restarts:
                self.returncode = rc
                self.terminal_reason = (
                    f"restart budget exhausted "
                    f"({self.policy.max_restarts}); last rc={rc}")
                self._event("terminal", self.terminal_reason)
                break
            self.restarts += 1
            base = min(self.policy.backoff_max_s,
                       self.policy.backoff_s * (2 ** (self.restarts - 1)))
            pause = base * (0.5 + float(self._jitter.random()))
            self._emit(f"[{self.name}] restart {self.restarts} after "
                       f"rc={rc}, backoff {pause:.2f}s")
            if self._stop.wait(pause):
                self.returncode = rc
                self.terminal_reason = "stopped"
                break
        self._done.set()


class Supervisor:
    """A set of supervised children sharing one lifetime: `start()` them
    all, `wait()` until every child is terminal (or a deadline), then
    read each child's outcome. `stop()` tears everything down."""

    def __init__(self):
        self.children: list[SupervisedChild] = []

    def add(self, child: SupervisedChild) -> SupervisedChild:
        self.children.append(child)
        return child

    def spawn(self, name: str, argv_for, **kw) -> SupervisedChild:
        return self.add(SupervisedChild(name, argv_for, **kw))

    def start(self) -> "Supervisor":
        for c in self.children:
            c.start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for c in self.children:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not c.wait(left):
                return False
        return True

    def stop(self) -> None:
        for c in self.children:
            c.stop()

    def summary(self) -> dict:
        return {c.name: {"returncode": c.returncode,
                         "restarts": c.restarts,
                         "incarnations": c.incarnation + 1,
                         "reason": c.terminal_reason,
                         "restart_latencies": c.restart_latencies()}
                for c in self.children}


def python_argv(module: str, *args: str) -> list[str]:
    """argv running `python -m module args...` with this interpreter."""
    return [sys.executable, "-m", module, *args]


def child_env(extra: dict | None = None) -> dict:
    """Current environment (incl. PYTHONPATH=src wiring) + overrides."""
    env = dict(os.environ)
    env.update(extra or {})
    return env
