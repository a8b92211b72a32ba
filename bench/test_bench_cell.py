"""A cell driven end to end on the CPU at a tiny size (backend "torch"):
the comparison passes on the port's output and fails on the control and
on each fault the cell can have, planted under the timed path. The look
for a GPU is skipped; bench/run.py's refusals are checked apart."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from bench import control, faults, harness, lloyd, reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = {"n": 2048, "d": 16, "d_a": 8, "k": 4, "partition": "vertical",
        "sparsity": 0.0}
SECONDS = 0.05


def cell_parts(name="kmeans-fraud.lloyd"):
    cell = harness.Cell(name, harness.load_json(ROOT / "BENCHMARK.json"))
    return cell, cell.traffic, cell.limits


def run(make_programs=None, seed=5, trace=False, cfg=TINY):
    cell, traffic, limits = cell_parts()
    return lloyd.run(cfg, traffic, limits, seed, SECONDS, trace,
                     device="cpu", backend="torch",
                     make_programs=make_programs)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_port_is_correct(seed):
    rec = run(seed=seed)
    assert rec["verdict"]["correct"], rec["verdict"]
    assert rec["attempted"] == rec["iters"] + 2
    assert rec["online_bytes"] == 4633792


def test_control_is_not_correct():
    rec = run(lambda xa, xb, seed: control.programs(xa, xb, seed), seed=3)
    assert not rec["verdict"]["correct"], rec["verdict"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_faults_are_not_correct(fault):
    rec = run(lambda xa, xb, seed: faults.Faulty(
        fault, lloyd.fit_programs(TINY, "cpu", "torch")), seed=9)
    assert not rec["verdict"]["correct"], (fault, rec["verdict"])


def test_half_batch_fails_the_scaled_residual():
    rec = run(lambda xa, xb, seed: faults.Faulty(
        "half_batch", lloyd.fit_programs(TINY, "cpu", "torch")), seed=9)
    resid = rec["verdict"]["numbers"]["centroid_resid"]
    assert resid["value"] > resid["limit"], rec["verdict"]


def test_judge_scaled_residual():
    want = torch.tensor([[1.0, -2.0, 0.0], [0.5, 0.25, 4.0]],
                        dtype=torch.float64)
    lab = torch.tensor([0, 1, 1])
    limits = {"mislabel_share": 0.0, "centroid_err": 1e-2,
              "centroid_resid": 1e-6}
    # a factor a cluster: centroid_err sees it, the residual does not
    got = want * torch.tensor([[1.004], [0.997]], dtype=torch.float64)
    v = reference.judge(lab, got, lab, want, limits)["numbers"]
    assert v["centroid_err"]["value"] == pytest.approx(0.012)
    assert v["centroid_resid"]["value"] < 1e-12
    # a shift off the centroid's direction: both see it
    got = want.clone()
    got[1, 0] += 3e-3
    v = reference.judge(lab, got, lab, want, limits)["numbers"]
    assert v["centroid_err"]["value"] == pytest.approx(3e-3)
    assert v["centroid_resid"]["value"] > 2e-3
    got[0, 1] = float("nan")
    v = reference.judge(lab, got, lab, want, limits)["numbers"]
    assert v["centroid_err"]["value"] == v["centroid_resid"]["value"] \
        == float("inf")


@pytest.mark.parametrize("key,value", [("partition", "horizontal"),
                                       ("protocol", "sparse"),
                                       ("ring_bits", 32), ("frac_bits", 16)])
def test_run_refuses_another_deployment(key, value):
    with pytest.raises(ValueError, match=key):
        run(cfg=dict(TINY, **{key: value}))


def test_result_line():
    cell, _, _ = cell_parts()
    rec = run(seed=4)
    rec.update(trace_iters=2, s1_s=0.004, s3_s=0.002, mm_shapes=[(16, 64,
                                                                  8)],
               ks_numels=[100],
               trace={"window_s": 0.01, "busy_s": 0.008, "device_ops": 40,
                      "device_s": 0.009,
                      "range_s": {"bench.ring_matmul": 0.001,
                                  "bench.ks_carry_share": 0.0005},
                      "top_ops": [["k", 0.005]],
                      "idle_gaps": [["aten::add", 0.002]]})
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    line = harness.result(cell, rec, True, dict(device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert set(line["metrics"]) == {m["name"] for m in cell.metrics(True)}
    assert line["metrics"]["device_idle"]["value"] == pytest.approx(20.0)
    assert line["metrics"]["protocol_dev_ms"]["value"] == pytest.approx(3.75)
    assert line["device"]["busy_s"] == 0.008
    rec["peak_bytes"] = 2e9
    line = harness.result(cell, rec, False, dict(device))
    assert set(line["metrics"]) == {"iter_ms", "peak_GB", "setup_s"}
    assert line["compared"] == rec["verdict"]["numbers"]
    json.dumps(line)


def bench_run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_refuses_without_a_gpu_and_without_the_program(tmp_path):
    args = ("--workload", "fraud-deploy.lloyd", "--seed", "1",
            "--seconds", "1", "--trace", "0")
    out = bench_run(ROOT, *args)
    assert out.returncode == 3 and out.stdout == "", out.stderr
    # a directory with BENCHMARK.json and bench/ alone: no result either
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    out = bench_run(tmp_path, *args)
    assert out.returncode == 4 and out.stdout == "", out.stderr
