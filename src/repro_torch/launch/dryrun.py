# Multi-pod dry run: lay out every (arch x input-shape) cell on the
# production meshes and count what one step does.
#
#   PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
#   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \
#       --shape train_4k --mesh multi
#
# Cells: 10 archs x 4 shapes (skips recorded with reasons, DESIGN.md §5)
# + the paper's own kmeans-fraud online iteration. Meshes: single pod
# (16 data x 16 model = 256 chips) and 2 pods (2 x 16 x 16 = 512), each a
# DeviceMesh over torch's fake process group (launch/mesh.py): this process
# is rank 0 and no collective moves data, so it needs no device.
#
# Per cell the parameter, optimizer, batch and cache trees are meta
# tensors, laid out by models/sharding.py's specs on the mesh
# (`distribute_tensor`: the argument bytes are the sum of the first
# device's shards). The step then runs once on the global meta tensors
# under a dispatch mode that counts every aten op: FLOPs by FlopCounterMode's
# formulas (matmuls, attention and convolutions; elementwise work counts
# none) and the bytes each op reads and writes (views excluded). Per-device
# counts are the totals divided by the mesh's chips: work a layout
# replicates (replicated activations, replicated small parameters) is
# counted once, not on every chip that repeats it, and the sharding mode
# moves none of them (only the argument bytes). Every loop (layers,
# microbatches, attention and CE chunks) runs, so nothing is extrapolated.
#
# What has no counterpart here: the per-device collective bytes, which the
# JAX package parses from the partitioned HLO, and XLA's temp, peak and
# generated-code sizes. Each record says so in `collective_note`.

import argparse
import dataclasses
import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.tree import leaves, tree_map

BF16 = torch.bfloat16
META = torch.device("meta")

# Per-cell training microbatch counts (activation-memory control; see
# EXPERIMENTS.md §Perf for the derivation).
MICROBATCHES = {("llama3-405b", "train_4k"): 8,
                ("deepseek-v2-236b", "train_4k"): 2,
                ("command-r-35b", "train_4k"): 2}
# >=100B params: bf16 Adam moments (DESIGN.md §6)
BF16_MOMENT_ARCHS = {"llama3-405b", "deepseek-v2-236b"}

COLLECTIVE_NOTE = (
    "no collective bytes: the step runs once on global meta tensors and "
    "its counts are divided over the chips, so replicated work is counted "
    "once and the sharding mode moves only the argument bytes; the "
    "collectives a partitioner would insert (the JAX package parses them "
    "from the partitioned HLO) and XLA's temp, peak and generated-code "
    "sizes have no counterpart here")

# shape and metadata queries, which move no data (FlopCounterMode's list)
_METADATA_OPS = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class CostMode(TorchDispatchMode):
    """Counts FLOPs the way `FlopCounterMode` does (its formulas, and its
    decomposition of ops it has no formula for) and the bytes every
    non-view aten op reads and writes, in one dispatch."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return NotImplemented
        if func not in self.registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        return out


def count_cost(fn, *args, **kwargs) -> dict:
    """fn(*args) once under `CostMode`: {flops, bytes}."""
    mode = CostMode()
    with mode:
        fn(*args, **kwargs)
    return {"flops": mode.flops, "bytes": mode.bytes}


def placed_bytes(tree, shardings) -> int:
    """Bytes of the first device's shards of every leaf of `tree`, laid out
    by the matching leaf of `shardings` (`Sharding.place`)."""
    total = 0
    for t, sh in zip(leaves(tree), leaves(shardings)):
        local = sh.place(t).to_local()
        total += local.numel() * local.element_size()
    return total


def _mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _chips(mesh) -> int:
    return int(mesh.size())


# ---------------------------------------------------------------------------
# input specs per (arch, shape)
# ---------------------------------------------------------------------------

def input_specs(arch_id: str, shape_name: str, *, cfg=None,
                global_batch: int | None = None) -> dict:
    """Meta-tensor stand-ins for every model input of the cell."""
    spec = all_archs()[arch_id]
    cfg = cfg or spec.config
    sh = SHAPES[shape_name]
    b, s = global_batch or sh.global_batch, sh.seq_len

    def ii(*sp):
        return torch.empty(sp, dtype=torch.int32, device=META)

    def bb(*sp):
        return torch.empty(sp, dtype=BF16, device=META)
    if sh.kind == "train":
        batch = {"tokens": ii(b, s), "labels": ii(b, s)}
        if cfg.enc_dec:
            batch["enc_inputs"] = bb(b, s, cfg.d_model)
        if cfg.frontend == "vlm":
            batch["patch_embeds"] = bb(b, cfg.n_patches, cfg.d_model)
        return batch
    if sh.kind == "prefill":
        batch = {"tokens": ii(b, s)}
        if cfg.enc_dec:
            batch["enc_inputs"] = bb(b, s, cfg.d_model)
        if cfg.frontend == "vlm":
            batch["patch_embeds"] = bb(b, cfg.n_patches, cfg.d_model)
        return batch
    return {"token": ii(b, 1), "pos": ii()}


def _opt_state_shardings(param_sh, mesh):
    from repro_torch.models.sharding import replicated
    return {"adam": {"m": param_sh, "v": param_sh, "step": replicated(mesh)}}


def _prefill_step(cfg):
    from repro_torch.models.lm import forward

    @torch.no_grad()
    def prefill(params, batch):
        hidden = forward(params, cfg, tokens=batch.get("tokens"),
                         enc_inputs=batch.get("enc_inputs"),
                         patch_embeds=batch.get("patch_embeds"))
        return (hidden[:, -1].to(BF16) @ params["head"]).to(torch.float32)
    return prefill


def params_shape_to_zeros(params_shape):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=s.device), params_shape)


# the step's counts per (arch, shape, config less act_axes, micro, batch):
# the step runs on global tensors, so the counts are the same on every mesh
# and in every sharding mode, and each is taken once per process
_STEP_COSTS: dict[tuple, dict] = {}


def lower_cell(arch_id: str, shape_name: str, mesh, *, cfg=None,
               micro: int | None = None,
               global_batch: int | None = None,
               sharding_mode: str = "2d") -> dict:
    """Lay out one cell on `mesh` and count its step; return the analysis
    record. cfg/micro/batch/sharding_mode overrides support the §Perf
    hillclimb variants (launch/perf.py)."""
    from repro_torch.models import sharding as S
    from repro_torch.models.lm import init_params_shape_only
    from repro_torch.serving.decode import init_cache, serve_step
    from repro_torch.training.adamw import AdamWConfig
    from repro_torch.training.train_step import init_state, make_train_step

    spec = all_archs()[arch_id]
    cfg = cfg or spec.config
    sh = SHAPES[shape_name]
    t0 = time.perf_counter()

    # pin activation batch axes inside layer loops (DESIGN.md §6)
    names = tuple(mesh.mesh_dim_names)
    act_axes = tuple(a for a in ("pod", "data") if a in names)
    if sharding_mode == "fsdp":
        act_axes = act_axes + ("model",)
    if sharding_mode == "repl_act" or sh.kind == "decode":
        # decode §Perf: tiny token batches — replicated activations let the
        # contraction partial-sum instead of all-gathering FSDP weights
        act_axes = ()
    gb_eff = global_batch or sh.global_batch
    n_batch_shards = 1
    for a in act_axes:
        n_batch_shards *= int(mesh.size(names.index(a)))
    if act_axes and gb_eff % n_batch_shards != 0:
        act_axes = ()                       # e.g. long_500k's global_batch=1
    cfg = dataclasses.replace(cfg, act_axes=act_axes)

    params_shape = init_params_shape_only(cfg)
    param_sh = S.param_shardings(mesh, params_shape, sharding_mode)
    batch = input_specs(arch_id, shape_name, cfg=cfg,
                        global_batch=global_batch)
    micro = (micro if micro is not None
             else MICROBATCHES.get((arch_id, shape_name), 1)) \
        if sh.kind == "train" else None
    key = (arch_id, shape_name, dataclasses.replace(cfg, act_axes=()),
           micro, gb_eff)

    if sh.kind == "train":
        opt_cfg = AdamWConfig(
            moment_dtype=BF16 if arch_id in BF16_MOMENT_ARCHS
            else torch.float32)
        state = init_state(params_shape_to_zeros(params_shape), opt_cfg)
        arg_bytes = placed_bytes(params_shape, param_sh) \
            + placed_bytes(state, _opt_state_shardings(param_sh, mesh)) \
            + placed_bytes(batch, S.batch_shardings(mesh, batch,
                                                    sharding_mode))
        if key not in _STEP_COSTS:
            step = make_train_step(cfg, opt_cfg, microbatches=micro)
            _STEP_COSTS[key] = count_cost(step, params_shape, state, batch)
    elif sh.kind == "prefill":
        arg_bytes = placed_bytes(params_shape, param_sh) \
            + placed_bytes(batch, S.batch_shardings(mesh, batch,
                                                    sharding_mode))
        if key not in _STEP_COSTS:
            _STEP_COSTS[key] = count_cost(_prefill_step(cfg), params_shape,
                                          batch)
    else:  # decode
        b = gb_eff
        cache = init_cache(cfg, b, sh.seq_len,
                           enc_len=sh.seq_len if cfg.enc_dec else 0,
                           device=META)
        arg_bytes = placed_bytes(params_shape, param_sh) \
            + placed_bytes(cache, S.cache_shardings(mesh, cache)) \
            + placed_bytes(batch["token"],
                           S.batch_shardings(mesh, batch["token"])) \
            + placed_bytes(batch["pos"], S.replicated(mesh))
        if key not in _STEP_COSTS:
            # the position's value changes no count: attention masks the
            # whole cache
            _STEP_COSTS[key] = count_cost(serve_step, params_shape, cfg,
                                          cache, batch["token"],
                                          sh.seq_len - 1)

    rec = analyze(_STEP_COSTS[key], arg_bytes, _chips(mesh))
    rec.update(arch=arch_id, shape=shape_name, mesh=_mesh_label(mesh),
               status="ok", compile_s=round(time.perf_counter() - t0, 1))
    return rec


def analyze(cost: dict, argument_bytes: int, chips: int) -> dict:
    """The record of one counted step on `chips` devices."""
    return {"flops_per_device": cost["flops"] / chips,
            "bytes_per_device": cost["bytes"] / chips,
            "memory": {"argument_size_in_bytes": int(argument_bytes)},
            "collective_note": COLLECTIVE_NOTE}


_KMEANS_COSTS: dict[tuple, dict] = {}


def lower_kmeans_cell(mesh) -> dict:
    """The paper's own config: one online Lloyd iteration on shares."""
    from repro_torch.configs.kmeans_fraud import FULL as KCFG
    from repro_torch.core import protocol
    from repro_torch.launch.kmeans_step import (arg_shardings,
                                                online_iteration_fn)
    t0 = time.perf_counter()
    fn, args = online_iteration_fn(KCFG.n, KCFG.d, KCFG.k, KCFG.d_a,
                                   device=META)
    shardings = arg_shardings(mesh, args, KCFG.n)
    arg_bytes = placed_bytes(list(args), list(shardings))
    key = (KCFG, protocol.FUSE_BEAVER)
    if key not in _KMEANS_COSTS:
        _KMEANS_COSTS[key] = count_cost(fn, *args)
    rec = analyze(_KMEANS_COSTS[key], arg_bytes, _chips(mesh))
    rec.update(arch="kmeans-fraud", shape=f"n{KCFG.n}_d{KCFG.d}_k{KCFG.k}",
               mesh=_mesh_label(mesh), status="ok",
               compile_s=round(time.perf_counter() - t0, 1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kmeans", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args()
    t_start = time.perf_counter()

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))

    cells = []
    if args.all or args.kmeans:
        cells.append(("kmeans-fraud", None))
    if args.all:
        for arch_id in all_archs():
            for shape_name in SHAPES:
                cells.append((arch_id, shape_name))
    elif args.arch and args.arch != "kmeans-fraud":
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells += [(args.arch, s) for s in shapes]
    elif args.arch == "kmeans-fraud" and not (args.all or args.kmeans):
        cells.append(("kmeans-fraud", None))

    results = []
    for arch_id, shape_name in cells:
        for mesh_name, mesh in meshes:
            label = f"{arch_id}/{shape_name}/{mesh_name}"
            if arch_id != "kmeans-fraud":
                spec = all_archs()[arch_id]
                if shape_name in spec.skip_shapes:
                    results.append({"arch": arch_id, "shape": shape_name,
                                    "mesh": mesh_name, "status": "skip",
                                    "reason": spec.skip_reason})
                    print(f"[skip] {label}: {spec.skip_reason[:60]}")
                    continue
            try:
                rec = (lower_kmeans_cell(mesh) if arch_id == "kmeans-fraud"
                       else lower_cell(arch_id, shape_name, mesh))
                rec["mesh_name"] = mesh_name
                results.append(rec)
                mem = rec.get("memory", {})
                print(f"[ok] {label}: counted in {rec['compile_s']}s, "
                      f"flops/dev {rec.get('flops_per_device', -1):.3g}, "
                      f"bytes/dev {rec.get('bytes_per_device', -1):.3g}, "
                      f"argbytes/dev "
                      f"{mem.get('argument_size_in_bytes', -1):.3g}",
                      flush=True)
            except Exception as e:
                results.append({"arch": arch_id, "shape": shape_name,
                                "mesh": mesh_name, "status": "error",
                                "error": f"{type(e).__name__}: {e}"[:500]})
                print(f"[ERR] {label}: {type(e).__name__}: {str(e)[:160]}",
                      flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    with open(args.out, "w") as f:      # the trailing skip records too
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    cuda = torch.cuda.is_initialized()
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error -> {args.out} "
          f"in {time.perf_counter() - t_start:.1f} s; "
          f"cuda_initialized={cuda}")
    if cuda:
        return 5          # the dry run must never touch a device
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
