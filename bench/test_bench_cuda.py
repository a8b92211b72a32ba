"""The cell's path on the card at a tiny size (backend "cuda"), traced:
correct, and the trace reads device time inside the kernels' ranges.
Marked `cuda`: it skips without a GPU. On the card:
    PYTHONPATH=src python -m pytest -m cuda bench/test_bench_cuda.py"""
import pathlib

import pytest
import torch

from bench import harness, lloyd

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = {"n": 4096, "d": 64, "d_a": 32, "k": 5, "partition": "vertical",
        "sparsity": 0.0}


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.Cell("fraud-deploy.lloyd",
                        harness.load_json(ROOT / "BENCHMARK.json"))
    rec = lloyd.run(TINY, cell.traffic, cell.limits, 12, 0.3, True,
                    device="cuda", backend="cuda")
    assert rec["verdict"]["correct"], rec["verdict"]
    t = rec["trace"]
    assert t["busy_s"] > 0 and t["device_ops"] > 0
    assert t["range_s"]["bench.ring_matmul"] > 0
    assert t["range_s"]["bench.ks_carry_share"] > 0
    assert len(rec["mm_shapes"]) == 20 * cell.traffic["trace_iters"]
