# §Perf hillclimb: baseline -> variant -> count, per EXPERIMENTS.md.
# Three cells (chosen from the roofline table): the paper's own
# kmeans-fraud iteration, the most collective-bound train cell, and the
# flagship decode cell. Each variant is an explicit hypothesis; the output
# JSON is the iteration log. The terms are the dry run's per-device counts
# (the step run on the first device's DTensor shards, collectives
# included) over the H100 data-sheet constants of launch/roofline.py, so a
# variant that changes only the sharding mode moves every term. Where the
# DTensor step raises, the counts fall back to global/chips, which the
# mode cannot move: such a variant's step terms are null, with the reason
# in `not_modelled`.
#
#   PYTHONPATH=src python -m repro_torch.launch.perf --cell kmeans --out perf.json

import argparse
import dataclasses
import json

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (CHIPS, PEAK_FLOPS, RING_OPS,
                                         dominant, kmeans_model_flops,
                                         link_bytes_dev, model_flops, step_s,
                                         terms)

MESH = None


def _terms(f, b, link, peak=PEAK_FLOPS):
    t = terms(f, b, link, peak)
    out = {f"{k}_s": v for k, v in t.items()}
    out["dominant"] = f"{dominant(t)}_s"
    out["step_s"] = step_s(t)
    return out


def measure_kmeans(sparse: bool, fuse: bool) -> dict:
    from repro_torch.configs.kmeans_fraud import FULL as K
    from repro_torch.core import protocol
    old = protocol.FUSE_BEAVER
    protocol.FUSE_BEAVER = fuse
    try:
        rec = dryrun.analyze(dryrun.kmeans_cost(MESH, sparse=sparse))
    finally:
        protocol.FUSE_BEAVER = old
    f = rec["flops_per_device"]
    b = rec["bytes_per_device"]
    link = link_bytes_dev(rec)
    out = _terms(f, b, link, RING_OPS)          # int64 ring products
    mf = kmeans_model_flops(K) / CHIPS
    out.update(flops_dev=f, bytes_dev=b, link_dev=link,
               argument_bytes_dev=rec["memory"]["argument_size_in_bytes"],
               useful_ratio=mf / max(f, 1.0),
               roofline_fraction=(mf / RING_OPS) / max(out["step_s"], 1e-12),
               variant=f"sparse={sparse},fuse={fuse}")
    return out


def measure_lm(arch: str, shape: str, *, sharding_mode="2d",
               micro=None, cfg_patch: dict | None = None) -> dict:
    from repro_torch.configs.base import all_archs
    cfg_base = None
    if cfg_patch:
        cfg_base = dataclasses.replace(all_archs()[arch].config, **cfg_patch)
    rec = dryrun.lower_cell(arch, shape, MESH, cfg=cfg_base, micro=micro,
                            sharding_mode=sharding_mode)
    f, b = rec["flops_per_device"], rec["bytes_per_device"]
    link = link_bytes_dev(rec)
    out = _terms(f, b, link)
    mf = model_flops(arch, shape, cfg_base=cfg_base) / CHIPS
    out.update(flops_dev=f, bytes_dev=b, link_dev=link,
               argument_bytes_dev=rec["memory"]["argument_size_in_bytes"],
               peak_bytes_dev=rec["memory"]["peak_memory_in_bytes"],
               useful_ratio=mf / max(f, 1.0),
               roofline_fraction=(mf / PEAK_FLOPS) / max(out["step_s"], 1e-12),
               variant=f"mode={sharding_mode},micro={micro},"
                       f"patch={cfg_patch}")
    if "collective_error" in rec:
        out["collective_error"] = rec["collective_error"]
        if sharding_mode != "2d" and micro is None and not cfg_patch:
            # a patched config or microbatch count still moves the
            # global/chips terms; the mode's own share of the variant does not
            out["not_modelled"] = (
                "the DTensor step raised, so the counts are global/chips, "
                "which the sharding mode does not move")
            for key in ("flops_dev", "bytes_dev", "useful_ratio",
                        "compute_s", "memory_s", "collective_s", "step_s",
                        "dominant", "roofline_fraction"):
                out[key] = None
    return out


def main():
    global MESH
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    choices=["kmeans", "train", "moe", "decode"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    MESH = make_production_mesh(multi_pod=False)

    results = []
    if args.cell == "kmeans":
        variants = [("baseline (paper-faithful dense SS)",
                     dict(sparse=False, fuse=False)),
                    ("fused Beaver recombination", dict(sparse=False,
                                                        fuse=True)),
                    ("sparsity-aware: joint matmuls -> host HE (Protocol 2)",
                     dict(sparse=True, fuse=True))]
        if args.variant:
            variants = [v for v in variants if args.variant in v[0]]
        for name, kw in variants:
            rec = measure_kmeans(**kw)
            rec["name"] = name
            results.append(rec)
            print(f"[{name}] dom={rec['dominant']} step={rec['step_s']:.4g}s "
                  f"flops/dev={rec['flops_dev']:.3e} "
                  f"bytes/dev={rec['bytes_dev']:.3e} "
                  f"link/dev={rec['link_dev']}")
    else:
        defaults = {"train": ("granite-34b", "train_4k"),
                    "moe": ("granite-moe-3b-a800m", "train_4k"),
                    "decode": ("llama3-405b", "decode_32k")}
        arch = args.arch or defaults[args.cell][0]
        shape = args.shape or defaults[args.cell][1]
        variants = [("baseline 2D (FSDP x TP)", dict(sharding_mode="2d")),
                    ("pure FSDP (no TP)", dict(sharding_mode="fsdp"))]
        if args.cell == "decode":
            variants = [
                ("baseline 2D, batch-sharded activations",
                 dict(sharding_mode="2d")),
                ("replicated activations (partial-sum MLPs)",
                 dict(sharding_mode="repl_act")),
            ]
        if args.cell == "moe":
            variants += [
                ("FSDP + unpadded experts (40, d-sharded)",
                 dict(sharding_mode="fsdp",
                      cfg_patch={"expert_pad_multiple": 1})),
                ("FSDP + unpadded + capacity 1.0",
                 dict(sharding_mode="fsdp",
                      cfg_patch={"expert_pad_multiple": 1,
                                 "capacity_factor": 1.0})),
                ("2D + per-example dispatch (local sorts)",
                 dict(cfg_patch={"moe_dispatch": "per_example"})),
            ]
        if args.cell == "train":
            variants.append(("FSDP + save-dots remat",
                             dict(sharding_mode="fsdp",
                                  cfg_patch={"remat_policy": "dots"})))
        if args.cell == "train" and arch == "llama3-405b":
            variants.append(("2D + microbatch=4", dict(micro=4)))
        if args.variant:
            variants = [v for v in variants if args.variant in v[0]]
        for name, kw in variants:
            try:
                rec = measure_lm(arch, shape, **kw)
                rec["name"] = f"{arch}/{shape}: {name}"
                results.append(rec)
                if rec["step_s"] is None:
                    print(f"[{name}] args/dev="
                          f"{rec['argument_bytes_dev']:.3e} B; step terms "
                          f"not modelled: {rec['collective_error'][:120]}")
                else:
                    print(f"[{name}] dom={rec['dominant']} "
                          f"step={rec['step_s']:.4f}s "
                          f"roofline={rec['roofline_fraction']:.2%}")
            except Exception as e:
                results.append({"name": name, "error": str(e)[:300]})
                print(f"[{name}] ERROR {str(e)[:160]}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
