"""Readings that a cell's limits are set from, in one process on the GPU:
the program on each of `--seeds`, the control (bench/control.py, the
reference in the 32-bit ring put in the program's place) on each of
`--control-seeds`, and each of `--faults` (bench/faults.py, planted in
the port's programs) on each of `--fault-seeds`; every run a short window
at the cell's own size. Prints one JSON line a run. The benchmark's own
runs never run the control or a fault.

    python3 bench/calibrate.py --workload kmeans-fraud.lloyd \
        --seeds 1,2,3 --control-seeds 4,5,6 \
        --faults half_batch,unchanged_state --fault-seeds 7,8,9 --seconds 3
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import torch
    from bench import control, faults, harness, lloyd
    if not torch.cuda.is_available():
        print("calibrate: no CUDA GPU", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload,
                        harness.load_json(ROOT / "BENCHMARK.json"))

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def planted(fault):
        return lambda xa, xb, seed: faults.Faulty(
            fault, lloyd.fit_programs(cell.config, "cuda", "cuda"))

    runs = [("program", s, None) for s in seeds(args.seeds)] + \
        [("control", s, control.programs)
         for s in seeds(args.control_seeds)] + \
        [(f, s, planted(f)) for f in args.faults.split(",") if f
         for s in seeds(args.fault_seeds)]
    for side, seed, make in runs:
        t0 = time.perf_counter()
        rec = lloyd.run(cell.config, cell.traffic, cell.limits, seed,
                        args.seconds, False, make_programs=make, t0=t0)
        out = {"workload": cell.name, "seed": seed, "side": side,
               "iters": rec["attempted"],
               "iter_ms": 1e3 * rec["window_s"] / rec["iters"],
               "setup_s": rec["setup_s"], "dealer_s": rec["dealer_s"],
               "peak_GB": rec["peak_bytes"] / 1e9,
               "numbers": {k: v["value"]
                           for k, v in rec["verdict"]["numbers"].items()},
               "run_s": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
