"""What the benchmark loads, each in a fresh interpreter: for both cells,
run.py and every module a run loads (driven at a tiny n on the CPU, traced
and untraced, with every metric's reader) hold no module whose top-level
name is jax, jaxlib, flax or repro (compared whole, so repro_torch
passes); the reference and the control hold nothing of repro_torch."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CELLS = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import bench.run
from bench import harness
spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in spec["workloads"]:
    cell = harness.Cell(w["name"], spec)
    cfg = dict(cell.config, n=256)
    for trace in (False, True):
        cell.driver().run(cfg, cell.traffic, cell.limits, 1, 0.01, trace,
                          device="cpu", backend="torch")
    for m in cell.metrics(False) + cell.metrics(True):
        harness.reader(m["name"])
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import bench.reference, bench.control
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runs_load_neither_jax_nor_the_jax_package():
    names = top_level_names(CELLS)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


def test_reference_and_control_load_nothing_of_the_program():
    names = top_level_names(REFERENCE)
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
        names
