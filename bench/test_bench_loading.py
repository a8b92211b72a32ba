"""The harness finds a configuration, a traffic mix, a cell and a metric
by name, as new files in a copy of bench/, with no file that was there
edited."""
import hashlib
import json
import pathlib
import shutil

from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]


def digests(folder: pathlib.Path) -> dict:
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).digest()
            for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench)
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cfg = dict(harness.load_json(bench / "configs" / "fraud-deploy.json"),
               name="fraud-wide", d=84, d_a=36)
    (bench / "configs" / "fraud-wide.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_json(bench / "traffic" / "lloyd.json"),
                   warmup_iters=3)
    (bench / "traffic" / "lloyd-long-warmup.json").write_text(
        json.dumps(traffic))
    (bench / "workloads" / "fraud-wide.lloyd-long-warmup.json").write_text(
        json.dumps({"limits": {"mislabel_share": 0.5,
                               "centroid_err": 0.5}}))
    (bench / "metrics" / "iters_in_window.py").write_text(
        "def read(rec):\n    return float(rec['iters'])\n")
    name = "fraud-wide.lloyd-long-warmup"
    spec["workloads"].append({"name": name, "config": "fraud-wide",
                              "traffic": "lloyd-long-warmup", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "iters_in_window", "unit": "iters",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "iter_ms",
                              "workloads": [name]})
    cell = harness.Cell(name, spec, bench=bench)
    assert cell.config["d"] == 84 and cell.traffic["warmup_iters"] == 3
    assert cell.limits["centroid_err"] == 0.5
    assert cell.driver().__name__ == "bench.lloyd"
    assert "iters_in_window" in [m["name"] for m in cell.metrics(True)]
    other = harness.Cell("fraud-deploy.lloyd", spec, bench=bench)
    assert "iters_in_window" not in [m["name"] for m in other.metrics(True)]
    assert harness.reader("iters_in_window", bench)({"iters": 7}) == 7.0
    after = digests(bench)
    assert {p: after[p] for p in before} == before
