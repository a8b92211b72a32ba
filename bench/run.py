"""Run one cell of the benchmark of repro_torch on this machine's GPUs.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as one JSON object, the
last line of standard output, and the numbers compared with their
limits as the last lines of standard error. Exits non-zero with no
result where the machine lacks the cell's GPUs, where the program is not
in the checkout, or where JAX or the JAX package got loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton_cache",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(SRC)] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    from bench import harness
    try:
        return run(args, harness)
    except harness.Refused as exc:
        print(f"bench: {exc}", file=sys.stderr, flush=True)
        return exc.code


def run(args, harness) -> int:
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(args.workload, spec)
    try:
        import repro_torch
    except ImportError as exc:
        raise harness.Refused(f"the program is not in the checkout: {exc}",
                              4) from exc
    if SRC not in pathlib.Path(repro_torch.__file__).resolve().parents:
        raise harness.Refused(f"repro_torch loaded from outside the "
                              f"checkout: {repro_torch.__file__}", 4)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        raise harness.Refused(
            f"{args.workload} needs {cell.chips} CUDA GPU(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found", 3)
    rec = cell.driver().run(cell.config, cell.traffic, cell.limits,
                            args.seed, args.seconds, bool(args.trace),
                            device="cuda", backend="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        raise harness.Refused(f"loaded what the port must not: {bad}", 5)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(rec["peak_bytes"])}
    line = harness.result(cell, rec, bool(args.trace), device)
    for text in harness.compared_lines(rec["verdict"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
