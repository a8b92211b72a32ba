# Roofline analysis (single-pod mesh) from the dry run's counts.
#
# The dry run (launch/dryrun.py) runs every step on the first device's
# DTensor shards under a dispatch mode that sees every executed aten op and
# collective. The LM cells are counted by probes (each layer loop at 1 and
# 2 repeats, one microbatch, totals extrapolated), as the JAX package's
# roofline corrects XLA's cost analysis; the kmeans-fraud iteration is
# counted whole.
#
# Per device: compute_s = FLOPs / PEAK_FLOPS (the kmeans-fraud cell's
# products are int64 ring matmuls with no tensor-core path: / RING_OPS),
# memory_s = bytes / HBM_BW, collective_s = link bytes / LINK_BW (an
# all-reduce's result counted twice); the dominant term is the largest.
# One link rate stands for every mesh axis, as the JAX package keeps one
# ICI constant: the multi-pod mesh's 'pod' axis would cross a slower
# network between pods, which neither package models. collective_s is null
# only where the DTensor step raised (the record's `collective_error`).
#
#   PYTHONPATH=src python -m repro_torch.launch.roofline --out roofline.json

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

# NVIDIA H100 SXM5 80GB hardware model: data-sheet figures, not
# measurements. Dense BF16 tensor-core rate (no sparsity), HBM3 bandwidth,
# and NVLink 4 at 900 GB/s total, 450 GB/s a direction.
PEAK_FLOPS = 989e12          # bf16 FLOP/s / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
LINK_BW = 450e9              # bytes/s / GPU, one direction
CHIPS = 256                  # single pod
# int64 multiply-add mod 2^64, the kmeans-fraud cell's only counted work
# (FlopCounterMode counts 2 operations per multiply-add): 132 SMs x 64
# 32-bit IMADs per clock x 1.98 GHz boost (CUDA C++ Programming Guide,
# compute capability 9.0), 3 IMADs per 64-bit multiply-add. Derived from
# data-sheet figures, not measured; the same rate bounds ring_matmul in
# chip_smoke.py.
RING_OPS = 2 * 132 * 64 * 1.98e9 / 3     # ops/s / GPU


def link_bytes_dev(rec: dict) -> float | None:
    """A dry-run record's per-device link bytes; None where its DTensor step
    raised (`collective_error`)."""
    if "collective_error" in rec:
        return None
    return float(rec["collectives"]["link_bytes"])


def corrected_totals(arch_id: str, shape_name: str, mesh,
                     cfg_base=None) -> dict:
    """Per-device (flops, bytes, link_bytes) of one step, from the dry
    run's probes (`dryrun.lower_cell`)."""
    sh = SHAPES[shape_name]
    micro = dryrun.MICROBATCHES.get((arch_id, shape_name), 1) \
        if sh.kind == "train" else 1
    rec = dryrun.lower_cell(arch_id, shape_name, mesh, cfg=cfg_base)
    return {"flops_dev": rec["flops_per_device"],
            "bytes_dev": rec["bytes_per_device"],
            "link_bytes_dev": link_bytes_dev(rec), "microbatches": micro,
            "collective_error": rec.get("collective_error")}


def model_flops(arch_id: str, shape_name: str, cfg_base=None) -> float:
    """Analytic 'useful' FLOPs: 6*N*D train / 2*N*D prefill / 2*N*B decode,
    N = matmul params (embed-gather excluded, head included; MoE routed
    params scaled by top_k/E). Attention itself excluded by convention —
    the ratio reads low on long-sequence cells by design."""
    from repro_torch.models.lm import init_params_shape_only, padded_experts
    from repro_torch.models.tree import flatten_with_path
    spec = all_archs()[arch_id]
    cfg = cfg_base or spec.config
    sh = SHAPES[shape_name]
    shapes = init_params_shape_only(cfg)
    n = 0
    for keys, leaf in flatten_with_path(shapes):
        if leaf.ndim < 2 or "embed" in keys:
            continue
        cnt = int(np.prod(leaf.shape))
        if "moe" in keys and any(w in keys for w in
                                 ("w_gate", "w_up", "w_down")) \
                and "shared" not in keys and cfg.n_experts:
            cnt = cnt * cfg.top_k / padded_experts(cfg)
        n += cnt
    if sh.kind == "train":
        return 6.0 * n * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * n * sh.global_batch * sh.seq_len
    return 2.0 * n * sh.global_batch          # decode: one token/seq


def terms(flops_dev: float, bytes_dev: float, link_dev: float | None,
          peak: float = PEAK_FLOPS) -> dict:
    """{compute, memory, collective} seconds of one step on one device;
    collective None without a link count."""
    return {"compute": flops_dev / peak, "memory": bytes_dev / HBM_BW,
            "collective": None if link_dev is None else link_dev / LINK_BW}


def dominant(t: dict) -> str:
    return max((k for k in t if t[k] is not None), key=t.get)


def step_s(t: dict) -> float:
    return max(v for v in t.values() if v is not None)


def analyze_cell(arch_id: str, shape_name: str, mesh) -> dict:
    t0 = time.perf_counter()
    tot = corrected_totals(arch_id, shape_name, mesh)
    t = terms(tot["flops_dev"], tot["bytes_dev"], tot["link_bytes_dev"])
    step = step_s(t)
    mf = model_flops(arch_id, shape_name)
    mf_dev = mf / CHIPS
    rec = {
        "arch": arch_id, "shape": shape_name,
        "compute_s": t["compute"], "memory_s": t["memory"],
        "collective_s": t["collective"], "dominant": dominant(t),
        "roofline_step_s": step,
        "model_flops_global": mf,
        "hlo_flops_global": tot["flops_dev"] * CHIPS,
        "useful_ratio": mf_dev / max(tot["flops_dev"], 1.0),
        "roofline_fraction": (mf_dev / PEAK_FLOPS) / max(step, 1e-12),
        "microbatches": tot["microbatches"],
        "analysis_s": round(time.perf_counter() - t0, 1),
    }
    if tot["collective_error"]:
        rec["collective_error"] = tot["collective_error"]
    return rec


def kmeans_model_flops(k_arch) -> float:
    """Plaintext Lloyd iteration: distances + argmin + update."""
    return 2.0 * k_arch.n * k_arch.d * k_arch.k + 4.0 * k_arch.n * k_arch.k \
        + 2.0 * k_arch.n * k_arch.d


def analyze_kmeans(mesh) -> dict:
    """The paper's own cell: one online iteration, counted op by op.
    MODEL_FLOPS = the plaintext Lloyd iteration. Its operations are ring
    words, so both go over RING_OPS."""
    from repro_torch.configs.kmeans_fraud import FULL as K
    rec = dryrun.lower_kmeans_cell(mesh)
    f = rec["flops_per_device"]
    b = rec["bytes_per_device"]
    t = terms(f, b, link_bytes_dev(rec), RING_OPS)
    mf = kmeans_model_flops(K)
    out = {"arch": "kmeans-fraud", "shape": f"n{K.n}_d{K.d}_k{K.k}",
           "compute_s": t["compute"], "memory_s": t["memory"],
           "collective_s": t["collective"], "dominant": dominant(t),
           "roofline_step_s": step_s(t),
           "model_flops_global": mf, "hlo_flops_global": f * CHIPS,
           "useful_ratio": (mf / CHIPS) / max(f, 1.0),
           "roofline_fraction": (mf / CHIPS / RING_OPS)
           / max(step_s(t), 1e-12),
           "microbatches": 1, "status": "ok"}
    if "collective_error" in rec:
        out["collective_error"] = rec["collective_error"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="roofline_results.json")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args()
    t_start = time.perf_counter()
    mesh = make_production_mesh(multi_pod=False)
    rows = []

    def write():
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)

    if args.arch in (None, "kmeans-fraud"):
        try:
            rec = analyze_kmeans(mesh)
            rows.append(rec)
            print(f"[ok] kmeans-fraud: dominant={rec['dominant']} "
                  f"step={rec['roofline_step_s']:.4g}s "
                  f"compute={rec['compute_s']:.4g}s "
                  f"memory={rec['memory_s']:.4g}s "
                  f"collective={rec['collective_s']}s "
                  f"useful={rec['useful_ratio']:.3f}", flush=True)
        except Exception as e:
            rows.append({"arch": "kmeans-fraud", "shape": "-",
                         "status": "error", "error": str(e)[:300]})
            print(f"[ERR] kmeans-fraud: {str(e)[:160]}", flush=True)
        write()
    for arch_id, spec in all_archs().items():
        if args.arch and arch_id != args.arch:
            continue
        for shape_name in SHAPES:
            if args.shape and shape_name != args.shape:
                continue
            if shape_name in spec.skip_shapes:
                rows.append({"arch": arch_id, "shape": shape_name,
                             "status": "skip"})
                continue
            try:
                rec = analyze_cell(arch_id, shape_name, mesh)
                rec["status"] = "ok"
                rows.append(rec)
                print(f"[ok] {arch_id}/{shape_name}: dominant="
                      f"{rec['dominant']} step={rec['roofline_step_s']:.4f}s "
                      f"collective={rec['collective_s']} "
                      f"useful={rec['useful_ratio']:.2f} "
                      f"roofline={rec['roofline_fraction']:.2%}", flush=True)
            except Exception as e:
                rows.append({"arch": arch_id, "shape": shape_name,
                             "status": "error",
                             "error": f"{type(e).__name__}: {e}"[:300]})
                print(f"[ERR] {arch_id}/{shape_name}: {str(e)[:160]}",
                      flush=True)
            write()
    write()                             # the trailing skip records too
    n_err = sum(r.get("status") == "error" for r in rows)
    cuda = torch.cuda.is_initialized()
    print(f"wrote {args.out}: {len(rows)} rows, {n_err} error in "
          f"{time.perf_counter() - t_start:.1f} s; cuda_initialized={cuda}")
    if cuda:
        return 5          # the analysis must never touch a device
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
