"""The port's restart supervisor (`repro_torch.launch.supervisor`): every
test of the reference's tests/test_supervisor.py, with children that import
no torch, plus the parent's own footprint (it imports neither torch nor
jax, so a supervising process never creates a CUDA context).

Load-bearing properties:
* a crashing child is respawned with backoff and succeeds once its
  transient failure clears — and the recovery is visible as restart
  latencies (the MTTR inputs);
* terminal exit codes (0 = clean, 4 = ResumeMismatch) are NEVER retried;
* a crash loop (N consecutive fast deaths) goes terminal with a
  diagnostic carrying the child's last output instead of respawning
  forever, and the restart budget bounds slow-death loops the same way;
* `argv_for(incarnation)` lets the caller arm crash switches on
  incarnation 0 only;
* backoff jitter is seeded — two identically-configured supervisors
  pause identically (deterministic chaos runs).
"""
import sys

import pytest

from repro_torch.launch.supervisor import (ChildEvent, RestartPolicy,
                                           SupervisedChild, Supervisor,
                                           child_env, free_port, python_argv)

FAST = RestartPolicy(max_restarts=5, backoff_s=0.01, backoff_max_s=0.02,
                     crash_loop_window_s=0.0, crash_loop_threshold=3)


def _script_child(tmp_path, body, name="c", **kw):
    """A SupervisedChild running `python -c body` with a tmp marker dir
    available as MARK (scripts use it to behave differently per run)."""
    code = f"import os, sys; MARK = {str(tmp_path)!r}\n" + body
    return SupervisedChild(name, [sys.executable, "-c", code],
                           env=child_env(), **kw)


def test_crash_then_recover_counts_restart_and_latency(tmp_path):
    body = (
        "m = os.path.join(MARK, 'once')\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close(); print('boom', flush=True); sys.exit(9)\n"
        "print('READY now', flush=True)\n")
    c = _script_child(tmp_path, body,
                      policy=RestartPolicy(max_restarts=3, backoff_s=0.01,
                                           backoff_max_s=0.02,
                                           crash_loop_window_s=0.0),
                      ready_pattern=r"^READY ")
    c.start()
    assert c.wait(timeout=30.0)
    assert c.success and c.restarts == 1 and c.incarnation == 1
    assert c.terminal_reason == "clean exit"
    lats = c.restart_latencies()
    assert len(lats) == 1 and lats[0] > 0.0
    kinds = [e.kind for e in c.events]
    assert kinds == ["spawn", "exit", "spawn", "ready", "exit", "terminal"]


@pytest.mark.parametrize("rc", [0, 4])
def test_terminal_codes_never_respawn(tmp_path, rc):
    c = _script_child(tmp_path, f"sys.exit({rc})", policy=FAST,
                      terminal_codes=(0, 4))
    c.start()
    assert c.wait(timeout=30.0)
    assert c.returncode == rc and c.restarts == 0 and c.incarnation == 0
    if rc == 0:
        assert c.terminal_reason == "clean exit"
    else:
        assert "terminal exit code 4" in c.terminal_reason


def test_crash_loop_goes_terminal_with_diagnostic(tmp_path):
    # dies instantly every time; window 3s >> child lifetime
    c = _script_child(tmp_path, "print('dying fast', flush=True)\n"
                                "sys.exit(9)",
                      policy=RestartPolicy(max_restarts=50, backoff_s=0.01,
                                           backoff_max_s=0.02,
                                           crash_loop_window_s=30.0,
                                           crash_loop_threshold=3))
    c.start()
    assert c.wait(timeout=60.0)
    assert not c.success
    assert "crash loop" in c.terminal_reason
    assert "dying fast" in c.terminal_reason     # last output attached
    assert c.incarnation == 2                    # 3 deaths total, no 4th


def test_restart_budget_exhausted(tmp_path):
    c = _script_child(tmp_path, "sys.exit(9)",
                      policy=RestartPolicy(max_restarts=2, backoff_s=0.01,
                                           backoff_max_s=0.02,
                                           crash_loop_window_s=0.0))
    c.start()
    assert c.wait(timeout=30.0)
    assert "restart budget exhausted" in c.terminal_reason
    assert c.restarts == 2 and c.incarnation == 2


def test_argv_for_incarnation_strips_crash_switch(tmp_path):
    # the script crashes iff its argv carries --die; argv_for only passes
    # --die on incarnation 0 — exactly how the chaos bench arms kills
    body = ("print('run', sys.argv[1:], flush=True)\n"
            "sys.exit(9 if '--die' in sys.argv else 0)\n")
    code = f"import os, sys; MARK = {str(tmp_path)!r}\n" + body
    seen = []

    def argv_for(incarnation):
        seen.append(incarnation)
        extra = ["--die"] if incarnation == 0 else []
        return [sys.executable, "-c", code] + extra

    c = SupervisedChild("armed", argv_for, policy=FAST, env=child_env())
    c.start()
    assert c.wait(timeout=30.0)
    assert c.success and c.restarts == 1
    assert seen == [0, 1]


def test_stop_tears_down_running_child(tmp_path):
    c = _script_child(tmp_path,
                      "import time\nprint('READY', flush=True)\n"
                      "time.sleep(600)", policy=FAST,
                      ready_pattern=r"^READY")
    c.start()
    for _ in range(200):
        if any(e.kind == "ready" for e in c.events):
            break
        import time
        time.sleep(0.05)
    c.stop()
    assert c.wait(timeout=10.0)
    assert c.terminal_reason == "stopped"


def test_supervisor_groups_children_and_summarizes(tmp_path):
    sup = Supervisor()
    sup.spawn("ok", [sys.executable, "-c", "print('fine')"], policy=FAST)
    sup.spawn("bad", [sys.executable, "-c", "import sys; sys.exit(4)"],
              policy=FAST)
    sup.start()
    assert sup.wait(timeout=30.0)
    s = sup.summary()
    assert s["ok"]["returncode"] == 0 and s["bad"]["returncode"] == 4
    assert s["bad"]["restarts"] == 0
    sup.stop()


def test_backoff_jitter_is_seeded_deterministic():
    a = SupervisedChild("a", ["true"], policy=RestartPolicy(jitter_seed=23))
    b = SupervisedChild("b", ["true"], policy=RestartPolicy(jitter_seed=23))
    ja = [float(a._jitter.random()) for _ in range(8)]
    jb = [float(b._jitter.random()) for _ in range(8)]
    assert ja == jb


def test_free_port_is_bindable_and_helpers():
    import socket
    p = free_port()
    s = socket.socket()
    s.bind(("127.0.0.1", p))
    s.close()
    argv = python_argv("repro_torch.launch.two_party", "--role", "A")
    assert argv[0] == sys.executable \
        and argv[1:3] == ["-m", "repro_torch.launch.two_party"]
    env = child_env({"X_MARK": "1"})
    assert env["X_MARK"] == "1"


def test_restart_latencies_without_readiness_use_spawn():
    evs = [ChildEvent("spawn", 1.0, 0), ChildEvent("exit", 2.0, 0),
           ChildEvent("spawn", 2.5, 1), ChildEvent("exit", 4.0, 1)]
    c = SupervisedChild("x", ["true"])
    c.events = evs
    assert c.restart_latencies() == [0.5]


def test_supervisor_imports_neither_torch_nor_jax():
    import os
    import pathlib
    import subprocess
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.launch.supervisor\n"
            "print(sorted(m for m in ('torch', 'jax', 'repro')"
            " if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_backoff_jitter_equals_reference():
    """The same policy pauses as the JAX package's supervisor does."""
    from repro.launch.supervisor import SupervisedChild as JSupervisedChild
    a = SupervisedChild("a", ["true"], policy=RestartPolicy(jitter_seed=5))
    b = JSupervisedChild("b", ["true"], policy=RestartPolicy(jitter_seed=5))
    assert [float(a._jitter.random()) for _ in range(8)] == \
        [float(b._jitter.random()) for _ in range(8)]
