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
# tensors, laid out by models/sharding.py's specs on the mesh as DTensors
# (`Sharding.place`): the argument bytes are the sum of the first device's
# shards. The step then runs once on those DTensors under a dispatch mode
# (`CostMode`) that sees the first device's local aten ops, as the JAX
# package's cost analysis reads the partitioned per-device program:
#
#   * FLOPs by FlopCounterMode's formulas (matmuls, attention and
#     convolutions; elementwise work counts none) and the bytes each op
#     reads and writes (views excluded);
#   * the collectives DTensor issues, by the JAX package's kinds, as the
#     bytes of each one's result buffer on the device; `link_bytes` counts
#     an all-reduce twice (a ring's reduce-scatter and all-gather). The
#     mesh's device type is "cuda" (launch/mesh.py), so a Shard->Shard
#     redistribution is DTensor's all-to-all, as on the card;
#   * the high-water mark of live local storages (the arguments included):
#     `memory.peak_memory_in_bytes`, and `temp_size_in_bytes` = peak less
#     arguments;
#   * the eight ops with the most FLOPs, by local input shapes (`top_ops`).
#
# The kmeans-fraud iteration runs whole. An LM cell is counted by probes,
# as the JAX package's roofline corrects its cost analysis: each layer
# loop at 1 and 2 repeats, one microbatch, the totals extrapolated
# (`lower_cell`, the record's `probes`). On the two-pod mesh, whose 'pod'
# axis is pure data parallelism, an LM step is counted on the first pod's
# (data, model) mesh at the pod's share of the batch, plus one all-reduce
# over 'pod' of the gradient shards (the record's `pod`). Where the
# DTensor step raises (an op DTensor has no sharding strategy for), the
# record keeps status ok
# with the step counted once on global meta tensors and divided over the
# chips, and says so: `count_basis` "global/chips" and `collective_error`
# with the op.

import argparse
import collections
import dataclasses
import json
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.tree import leaves, tree_map, unflatten_like

BF16 = torch.bfloat16
META = torch.device("meta")

# Per-cell training microbatch counts (activation-memory control; see
# EXPERIMENTS.md §Perf for the derivation).
MICROBATCHES = {("llama3-405b", "train_4k"): 8,
                ("deepseek-v2-236b", "train_4k"): 2,
                ("command-r-35b", "train_4k"): 2}
# >=100B params: bf16 Adam moments (DESIGN.md §6)
BF16_MOMENT_ARCHS = {"llama3-405b", "deepseek-v2-236b"}

# the JAX package's collective kinds (its dryrun.parse_collectives)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
# DTensor's collectives by op name (namespaces _c10d_functional and
# _dtensor); the first two only wait for or wrap a result
_COLLECTIVE_OPS = {
    "wait_tensor": None, "_wrap_tensor_autograd": None,
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")

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
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def link_bytes(collectives: dict) -> int:
    """Per-device link traffic of `collectives` ({kind: result bytes}): an
    all-reduce counts twice (ring reduce-scatter + all-gather), as in the
    JAX package's parse_collectives."""
    return sum(collectives[k] * (2 if k == "all-reduce" else 1)
               for k in COLLECTIVE_KINDS)


class StepError(RuntimeError):
    """A counted step raised; the message names the last op the mode saw."""


class CostMode(TorchDispatchMode):
    """Counts, in one dispatch, FLOPs the way `FlopCounterMode` does (its
    formulas, and its decomposition of ops it has no formula for), the
    bytes every non-view aten op reads and writes, the result bytes of
    every collective by kind, the live storages' high-water mark, and the
    FLOPs of each op by its local input shapes (`top_ops`: the eight
    largest, which say where a count's FLOPs went).

    On DTensors the mode declines the DTensor-level op (NotImplemented):
    DTensor then runs its local ops and collectives, which come back
    through the mode on this device's shards. Only ops on `device` (the
    step's tensors' device, meta in the dry run) count: the ones DTensor's
    sharding propagation runs on fake tensors and its own index
    bookkeeping on host tensors do not."""

    def __init__(self, device=META):
        super().__init__()
        self.device = torch.device(device)
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.live = self.peak = self.allocated = 0
        self._storages = WeakIdKeyDictionary()
        self.op = None
        self.by_op = collections.Counter()

    def hold(self, *trees) -> None:
        """Count the storages of every tensor in `trees` (a DTensor's local
        shard) as live: the step's arguments."""
        for t in leaves(list(trees)):
            if isinstance(t, torch.Tensor):
                self._track(_local(t), new=False)

    def _track(self, t: torch.Tensor, new: bool = True) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._release, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        if new:
            self.allocated += n

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        self.op = func
        if func in _METADATA_OPS or any(issubclass(t, DTensor)
                                        for t in types):
            return NotImplemented
        ins = _tensors(args) + _tensors(kwargs)
        elsewhere = not ins and "device" in kwargs \
            and torch.device(kwargs["device"]) != self.device
        if elsewhere or any(isinstance(t, FakeTensor)
                            or t.device != self.device for t in ins):
            return func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return self._collective(func, args, kwargs)
        if func not in self.registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) or t.device != self.device
               for t in outs):
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            f = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.by_op[(str(packet), tuple(tuple(t.shape) for t in ins))] \
                += f
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        for t in outs:
            self._track(t)
        return out

    def _collective(self, func, args, kwargs):
        name = func._schema.name.split("::")[-1]
        if name not in _COLLECTIVE_OPS:
            raise RuntimeError(f"{func}: no collective kind for it")
        out = func(*args, **kwargs)
        kind = _COLLECTIVE_OPS[name]
        if kind is not None:
            outs = _tensors(out)
            self.collectives[kind] += _nbytes(outs)
            self.bytes += _nbytes(args) + _nbytes(outs)
            for t in outs:
                self._track(t)
        return out

    def result(self) -> dict:
        coll = dict(self.collectives)
        coll["link_bytes"] = link_bytes(coll)
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll, "peak": self.peak,
                "allocated": self.allocated,
                "top_ops": [[op, [list(x) for x in shapes], f] for
                            (op, shapes), f in self.by_op.most_common(8)]}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def count_cost(fn, *args, **kwargs) -> dict:
    """fn(*args) once under `CostMode`, DTensors and plain tensors mixing
    as replicated (`implicit_replication`): {flops, bytes, collectives
    (with link_bytes), peak (arguments included), allocated}."""
    from torch.distributed.tensor.experimental import implicit_replication
    first = next((t for t in leaves([args, kwargs])
                  if isinstance(t, torch.Tensor)), None)
    mode = CostMode(META if first is None else _local(first).device)
    mode.hold(args, kwargs)
    try:
        with implicit_replication(), mode:
            fn(*args, **kwargs)
    except Exception as e:
        raise StepError(f"{mode.op}: {type(e).__name__}: {e}") from e
    return mode.result()


def place(tree, shardings):
    """`tree` with every leaf laid out by the matching leaf of `shardings`
    (`Sharding.place`): DTensors whose local tensors are the first
    device's shards."""
    return unflatten_like(tree, [sh.place(t) for t, sh in
                                 zip(leaves(tree), leaves(shardings))])


def local_bytes(tree) -> int:
    """Bytes of the local tensors of every leaf of `tree`."""
    return sum(_nbytes(_local(t)) for t in leaves(tree))


def count_on_mesh(fn, args: tuple, shardings: tuple, chips: int, *,
                  basis: str | None = None) -> dict:
    """The counts of fn(*args) on the first device: every argument tree laid
    out by its shardings and the step run on the DTensors. If that raises
    (or basis="global/chips" asks for it), the step is counted once on the
    global tensors and divided over `chips`, and the result carries
    `collective_error` (when it raised). Returns the cost dict of
    `count_cost` with `argument_bytes` and `count_basis`.

    The first device's tensor-parallel regions take the last 'model'
    coordinate (`models/tp.py:as_last_rank`): only the query-sequence
    split's work depends on it, and the last rank's blocks hold no
    sequence start, so a local window masks none of their keys."""
    from repro_torch.models import tp
    placed = tuple(place(a, s) for a, s in zip(args, shardings))
    arg_bytes = local_bytes(placed)
    error = None
    if basis is None:
        try:
            with tp.as_last_rank():
                cost = count_cost(fn, *placed)
            cost.update(count_basis="per-device",
                        argument_bytes=arg_bytes)
            return cost
        except StepError as e:
            error = str(e)[:500]
    del placed
    cost = count_cost(fn, *args)
    cost = {"flops": cost["flops"] / chips,
            "bytes": cost["bytes"] / chips,
            "peak": cost["peak"] / chips,
            "allocated": cost["allocated"] / chips,
            "count_basis": "global/chips", "argument_bytes": arg_bytes}
    if error is not None:
        cost["collective_error"] = error
    return cost


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


# the counts per (arch, shape, config, micro, batch, mesh, sharding mode):
# each cell is counted once per process on each mesh and in each mode
_STEP_COSTS: dict[tuple, dict] = {}


def cell_config(arch_id: str, shape_name: str, mesh, *, cfg=None,
                global_batch: int | None = None,
                sharding_mode: str = "2d"):
    """The cell's config with its activation batch axes pinned for `mesh`
    and `sharding_mode` (DESIGN.md §6)."""
    cfg = cfg or all_archs()[arch_id].config
    sh = SHAPES[shape_name]
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
    return dataclasses.replace(cfg, act_axes=act_axes)


def cell_program(arch_id: str, shape_name: str, mesh, cfg, *,
                 micro: int | None, global_batch: int | None,
                 sharding_mode: str):
    """(step, argument trees, their shardings) of one cell: the step takes
    the trees positionally."""
    from repro_torch.models import sharding as S
    from repro_torch.models.lm import init_params_shape_only
    from repro_torch.serving.decode import init_cache, serve_step
    from repro_torch.training.adamw import AdamWConfig
    from repro_torch.training.train_step import init_state, make_train_step

    sh = SHAPES[shape_name]
    params = init_params_shape_only(cfg)
    param_sh = S.param_shardings(mesh, params, sharding_mode)
    batch = input_specs(arch_id, shape_name, cfg=cfg,
                        global_batch=global_batch)
    if sh.kind == "train":
        opt_cfg = AdamWConfig(
            moment_dtype=BF16 if arch_id in BF16_MOMENT_ARCHS
            else torch.float32)
        state = init_state(params_shape_to_zeros(params), opt_cfg)
        step = make_train_step(cfg, opt_cfg, microbatches=micro)
        return step, (params, state, batch), (
            param_sh, _opt_state_shardings(param_sh, mesh),
            S.batch_shardings(mesh, batch, sharding_mode))
    if sh.kind == "prefill":
        return _prefill_step(cfg), (params, batch), (
            param_sh, S.batch_shardings(mesh, batch, sharding_mode))
    cache = init_cache(cfg, global_batch or sh.global_batch, sh.seq_len,
                       enc_len=sh.seq_len if cfg.enc_dec else 0, device=META)

    def decode(params, cache, token, pos):
        # the position's value changes no count: attention masks the
        # whole cache
        return serve_step(params, cfg, cache, token, sh.seq_len - 1)
    return decode, (params, cache, batch["token"], batch["pos"]), (
        param_sh, S.cache_shardings(mesh, cache),
        S.batch_shardings(mesh, batch["token"]), S.replicated(mesh))


def _with_repeats(cfg, group_repeats: list, enc_layers: int | None):
    """`cfg` with each layer group at the given repeats (and the encoder at
    `enc_layers`), as the JAX package's roofline probes."""
    from repro_torch.configs.base import ScanGroup
    kw = {"groups": tuple(ScanGroup(g.unit, r)
                          for g, r in zip(cfg.groups, group_repeats))}
    if cfg.enc_dec and enc_layers is not None:
        kw["n_enc_layers"] = enc_layers
    return dataclasses.replace(cfg, **kw)


def _probe_plan(cfg) -> list:
    """[(group repeats, encoder layers)] of the probes: every layer loop at
    1, then each loop at 2 with the others at 1."""
    ones = [1] * len(cfg.groups)
    enc = 1 if cfg.enc_dec else None
    plan = [(ones, enc)]
    for i in range(len(cfg.groups)):
        plan.append((ones[:i] + [2] + ones[i + 1:], enc))
    if cfg.enc_dec:
        plan.append((ones, 2))
    return plan


def _linear_parts(cost: dict) -> dict:
    parts = {k: cost[k] for k in ("flops", "bytes")}
    parts["temp"] = max(0, cost["peak"] - cost["argument_bytes"])
    for k in COLLECTIVE_KINDS:
        parts[k] = cost.get("collectives", {}).get(k, 0)
    return parts


def _extrapolate(costs: list, cfg, micro: int) -> dict:
    """The step's per-device counts from the probes (`_probe_plan` order):
    unit_x = probe(x at 2) - probe(all at 1), base = probe(all at 1) -
    sum_x unit_x, total = micro * (base + sum_x R_x unit_x), as the JAX
    package's roofline corrects its cost analysis. The temporaries are
    one microbatch's (microbatches run one after another): base +
    sum_x R_x unit_x, not times micro, and never below a probe's own: a
    high-water mark need not grow with the layers (on torch 2.11 the
    straight line through granite-moe-3b-a800m train_4k's probes fell to
    zero, a peak of the arguments alone)."""
    parts = [_linear_parts(c) for c in costs]
    repeats = [g.repeats for g in cfg.groups]
    if cfg.enc_dec:
        repeats.append(cfg.n_enc_layers)
    base, units = parts[0], parts[1:]
    out = {}
    for k in base:
        unit = [u[k] - base[k] for u in units]
        total = base[k] - sum(unit) + sum(r * u for r, u in zip(repeats,
                                                               unit))
        if k == "temp":
            out[k] = max([total] + [p[k] for p in parts])
        else:
            out[k] = max(0, total) * micro
    return out


def _cell_cost(arch_id, shape_name, mesh, cfg, micro, global_batch,
               sharding_mode, basis=None) -> dict:
    key = (arch_id, shape_name, cfg, micro, global_batch, _mesh_label(mesh),
           sharding_mode, basis)
    if key not in _STEP_COSTS:
        step, args, shardings = cell_program(
            arch_id, shape_name, mesh, cfg, micro=micro,
            global_batch=global_batch, sharding_mode=sharding_mode)
        _STEP_COSTS[key] = count_on_mesh(step, args, shardings,
                                         _chips(mesh), basis=basis)
    return _STEP_COSTS[key]


def _pod_split(mesh) -> tuple:
    """(pod count, the first pod's own mesh) of a mesh with a 'pod' axis;
    (1, mesh) otherwise."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return 1, mesh
    return (int(mesh.size(names.index("pod"))),
            mesh[tuple(n for n in names if n != "pod")])


def _batch_ways(mesh, sharding_mode: str) -> int:
    """The devices a batch is split over (`sharding.batch_shardings`)."""
    names = tuple(mesh.mesh_dim_names)
    axes = [a for a in ("pod", "data") if a in names]
    if sharding_mode == "fsdp":
        axes.append("model")
    ways = 1
    for a in axes:
        ways *= int(mesh.size(names.index(a)))
    return ways


def _pod_grad_bytes(mesh, cfg, sharding_mode: str,
                    accumulated: bool) -> int:
    """The bytes of the first device's gradient shards on `mesh`, which a
    train step all-reduces over 'pod': each parameter's shard in its own
    dtype, or float32 where microbatches accumulate the gradient
    (`train_step.make_train_step`'s accum_dtype)."""
    from repro_torch.models import sharding as S
    from repro_torch.models.lm import init_params_shape_only
    params = init_params_shape_only(cfg)
    placed = place(params, S.param_shardings(mesh, params, sharding_mode))
    return sum(_local(t).numel() * (4 if accumulated else t.element_size())
               for t in leaves(placed))


def lower_cell(arch_id: str, shape_name: str, mesh, *, cfg=None,
               micro: int | None = None,
               global_batch: int | None = None,
               sharding_mode: str = "2d") -> dict:
    """Lay out one cell on `mesh` and count its step on the first device
    by probes (`_probe_plan`): each layer loop at 1 and 2 repeats, one
    microbatch of global_batch / micro, the totals extrapolated
    (`_extrapolate`), as the JAX package's roofline does; the record says
    so in `probes`. Returns the analysis record. cfg/micro/batch/
    sharding_mode overrides support the §Perf hillclimb variants
    (launch/perf.py).

    On a mesh with a 'pod' axis, which is pure data parallelism (the
    parameters are replicated over it), a device does what a device of
    one pod does with the pod's share of the batch: the step is counted
    on the first pod's (data, model) mesh at global_batch / pods, and a
    train step adds one all-reduce over 'pod' of its gradient shards
    (`pod` in the record). Running the step on the three-axis mesh gives
    the same FLOPs, but a batch sharded over two axes turns into
    `_StridedShard` placements, whose redistributions DTensor plans by a
    graph search, and a cell took up to half an hour. A batch that does
    not split over the pods (one sequence) runs on the whole mesh.

    A record counted per device has `replication`: its FLOPs over the
    same probes counted once on global tensors and divided over the
    counted mesh's chips, 1 where no device repeats another's work."""
    sh = SHAPES[shape_name]
    t0 = time.perf_counter()
    gb = global_batch or sh.global_batch
    micro = (micro if micro is not None
             else MICROBATCHES.get((arch_id, shape_name), 1)) \
        if sh.kind == "train" else None
    base = cfg or all_archs()[arch_id].config
    m = micro or 1
    pgb = gb // m
    pods, count_mesh = _pod_split(mesh)
    if pods > 1 and pgb % _batch_ways(mesh, sharding_mode) == 0:
        pgb //= pods
    else:
        pods, count_mesh = 1, mesh
    pcfg = cell_config(arch_id, shape_name, count_mesh, cfg=base,
                       global_batch=pgb, sharding_mode=sharding_mode)
    plan = _probe_plan(pcfg)
    cfgs = [_with_repeats(pcfg, r, e) for r, e in plan]
    pmicro = 1 if micro else None
    costs = [_cell_cost(arch_id, shape_name, count_mesh, c, pmicro, pgb,
                        sharding_mode) for c in cfgs]
    failed = next((c for c in costs if "collective_error" in c), None)
    if failed is not None:
        # one basis for every probe
        costs = [_cell_cost(arch_id, shape_name, count_mesh, c, pmicro, pgb,
                            sharding_mode, basis="global/chips")
                 for c in cfgs]
    full = cell_config(arch_id, shape_name, mesh, cfg=base,
                       global_batch=gb, sharding_mode=sharding_mode)
    args = placed_arguments(arch_id, shape_name, mesh, full, micro, gb,
                            sharding_mode)
    tot = _extrapolate(costs, full, m)
    flat = None
    if failed is None:
        flat = _extrapolate([
            _cell_cost(arch_id, shape_name, count_mesh, c, pmicro, pgb,
                       sharding_mode, basis="global/chips")
            for c in cfgs], full, m)
    cost = {"flops": tot["flops"], "bytes": tot["bytes"],
            "peak": args + tot["temp"], "argument_bytes": args,
            "count_basis": costs[0]["count_basis"]}
    if failed is not None:
        cost["collective_error"] = failed["collective_error"]
    else:
        coll = {k: tot[k] for k in COLLECTIVE_KINDS}
        cost["collectives"] = coll
    pod = None
    if pods > 1:
        grad = 0
        if sh.kind == "train":
            grad = _pod_grad_bytes(count_mesh, base, sharding_mode,
                                   accumulated=m > 1)
        pod = {"pods": pods, "counted_on": _mesh_label(count_mesh),
               "probe_global_batch_per_pod": pgb,
               "grad_all_reduce_bytes": grad}
        cost["bytes"] += 2 * grad
        if "collectives" in cost:
            cost["collectives"]["all-reduce"] += grad
    if "collectives" in cost:
        cost["collectives"]["link_bytes"] = link_bytes(cost["collectives"])
    rec = analyze(cost)
    rec["probes"] = {"group_repeats": [r for r, _ in plan],
                     "enc_layers": [e for _, e in plan]
                     if pcfg.enc_dec else None,
                     "microbatches": m, "probe_global_batch": pgb}
    if pod is not None:
        rec["pod"] = pod
    if "top_ops" in costs[0]:
        rec["top_ops"] = costs[0]["top_ops"]
    if flat is not None:
        rec["replication"] = tot["flops"] / flat["flops"]
    rec.update(arch=arch_id, shape=shape_name, mesh=_mesh_label(mesh),
               status="ok", compile_s=round(time.perf_counter() - t0, 1))
    return rec


def placed_arguments(arch_id, shape_name, mesh, cfg, micro, global_batch,
                     sharding_mode) -> int:
    """The first device's argument bytes of the cell (every layer)."""
    _, args, shardings = cell_program(
        arch_id, shape_name, mesh, cfg, micro=micro,
        global_batch=global_batch, sharding_mode=sharding_mode)
    return local_bytes([place(a, s) for a, s in zip(args, shardings)])


def analyze(cost: dict) -> dict:
    """The record of one counted step (`count_on_mesh`), per device, with
    the JAX package's keys."""
    args = int(cost["argument_bytes"])
    peak = max(int(cost["peak"]), args)
    rec = {"flops_per_device": cost["flops"],
           "bytes_per_device": cost["bytes"],
           "memory": {"argument_size_in_bytes": args,
                      "peak_memory_in_bytes": peak,
                      "temp_size_in_bytes": peak - args},
           "count_basis": cost["count_basis"]}
    if "collective_error" in cost:
        rec["collective_error"] = cost["collective_error"]
    else:
        rec["collectives"] = dict(cost["collectives"])
    return rec


_KMEANS_COSTS: dict[tuple, dict] = {}


def kmeans_cost(mesh, *, sparse: bool = False) -> dict:
    """`count_on_mesh` of one online iteration of the kmeans-fraud cell
    (FULL) on `mesh`, memoized per mesh and FUSE_BEAVER setting."""
    from repro_torch.configs.kmeans_fraud import FULL
    from repro_torch.core import protocol
    from repro_torch.launch.kmeans_step import (arg_shardings,
                                                online_iteration_fn)
    key = (sparse, protocol.FUSE_BEAVER, _mesh_label(mesh),
           tuple(mesh.mesh_dim_names))
    if key not in _KMEANS_COSTS:
        fn, args = online_iteration_fn(FULL.n, FULL.d, FULL.k, FULL.d_a,
                                       sparse=sparse, device=META)
        _KMEANS_COSTS[key] = count_on_mesh(
            fn, args, arg_shardings(mesh, args, FULL.n), _chips(mesh))
    return _KMEANS_COSTS[key]


def lower_kmeans_cell(mesh) -> dict:
    """The paper's own config: one online Lloyd iteration on shares."""
    from repro_torch.configs.kmeans_fraud import FULL as KCFG
    t0 = time.perf_counter()
    cost = kmeans_cost(mesh)
    rec = analyze(cost)
    rec["top_ops"] = cost["top_ops"]
    rec.update(arch="kmeans-fraud", shape=f"n{KCFG.n}_d{KCFG.d}_k{KCFG.k}",
               mesh=_mesh_label(mesh), status="ok",
               compile_s=round(time.perf_counter() - t0, 1))
    return rec


# The tensor-parallel check (`--tp-ratios`): every arch's reduced config on
# a small fake mesh, where a device that repeats no other's work reads a
# ratio of 1 and one that repeats it on every 'model' rank reads 4.
TP_MESH = (2, 4)
TP_RATIO_BOUND = 1.10
# the JAX package's own ratio on that mesh where it is above the bound (the
# recurrent archs, whose scans' elementwise work XLA's cost analysis counts
# as FLOPs and FlopCounterMode does not), the smaller of its readings at
# global batch 2 and 8
REFERENCE_RATIOS = {("recurrentgemma-2b", "train_4k"): 1.33,
                    ("recurrentgemma-2b", "prefill_32k"): 1.32,
                    ("rwkv6-1.6b", "train_4k"): 1.22,
                    ("rwkv6-1.6b", "prefill_32k"): 1.22}


def replication(arch_id: str, shape_name: str, mesh,
                global_batch: int) -> dict:
    """The work a device repeats, for the arch's reduced config on `mesh`
    in the 2D mode at one microbatch: `ratio` is `lower_cell`'s
    `replication`, beside its `bound` (TP_RATIO_BOUND or the JAX package's
    own ratio where that is higher)."""
    cell = lower_cell(arch_id, shape_name, mesh,
                      cfg=all_archs()[arch_id].reduced, micro=1,
                      global_batch=global_batch)
    rec = {"arch": arch_id, "shape": shape_name,
           "global_batch": global_batch, "mesh": _mesh_label(mesh),
           "ratio": cell.get("replication"),
           "bound": max(TP_RATIO_BOUND,
                        REFERENCE_RATIOS.get((arch_id, shape_name), 0.0)),
           "count_basis": cell["count_basis"],
           "link_bytes": cell.get("collectives", {}).get("link_bytes"),
           "top_ops": cell.get("top_ops", [])[:3]}
    if "collective_error" in cell:
        rec["collective_error"] = cell["collective_error"]
    return rec


def tp_ratios(shapes, batches) -> list:
    """`replication` of every arch on the fake TP_MESH for each of
    `shapes` and `batches` (skipped shapes left out)."""
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh(TP_MESH, ("data", "model"))
    return [replication(arch_id, shape, mesh, gb)
            for arch_id, spec in all_archs().items() for shape in shapes
            if shape not in spec.skip_shapes for gb in batches]


def tp_ratio_fails(rec: dict) -> bool:
    """A `replication` record above its bound or not counted per device."""
    return rec["count_basis"] != "per-device" \
        or "collective_error" in rec or rec["ratio"] > rec["bound"]


def ok_line(rec: dict) -> str:
    """One record's printed summary; a record counted on the global basis
    names it and the op that stopped the DTensor step."""
    mem = rec["memory"]
    line = (f"counted in {rec['compile_s']}s ({rec['count_basis']}), "
            f"flops/dev {rec['flops_per_device']:.3g}, "
            f"bytes/dev {rec['bytes_per_device']:.3g}, "
            f"argbytes/dev {mem['argument_size_in_bytes']:.3g}, "
            f"peak/dev {mem['peak_memory_in_bytes']:.3g}")
    if "collective_error" in rec:
        return line + f", no collectives: {rec['collective_error'][:160]}"
    line += f", link/dev {rec['collectives']['link_bytes']:.3g}"
    if "replication" in rec:
        line += f", replication {rec['replication']:.4f}"
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kmeans", action="store_true")
    ap.add_argument("--tp-ratios", action="store_true",
                    help="the reduced configs' replication ratios on a "
                         "fake (2, 4) mesh (--shape: a comma list, "
                         "default train_4k)")
    ap.add_argument("--batches", default="2",
                    help="--tp-ratios' global batches, a comma list")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if args.tp_ratios:
        return tp_main(args, t_start)

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
                print(f"[ok] {label}: {ok_line(rec)}", flush=True)
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


def tp_main(args, t_start: float) -> int:
    """`--tp-ratios`: one line a cell, the records to --out; exit 1 where a
    ratio is above its bound or a step fell back to global/chips."""
    recs = tp_ratios((args.shape or "train_4k").split(","),
                     [int(b) for b in args.batches.split(",")])
    for r in recs:
        line = (f"[{'FAIL' if tp_ratio_fails(r) else 'ok'}] {r['arch']}/"
                f"{r['shape']}/gb{r['global_batch']} on {r['mesh']}: "
                f"ratio {r['ratio'] or float('nan'):.4f} "
                f"(bound {r['bound']:.2f}), "
                f"{r['count_basis']}")
        if "collective_error" in r:
            line += f", {r['collective_error'][:160]}"
        print(line, flush=True)
    with open(args.out, "w") as f:
        json.dump(recs, f, indent=1)
    bad = sum(map(tp_ratio_fails, recs))
    cuda = torch.cuda.is_initialized()
    print(f"done: {len(recs)} cells, {bad} above their bound -> {args.out} "
          f"in {time.perf_counter() - t_start:.1f} s; "
          f"cuda_initialized={cuda}")
    if cuda:
        return 5
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
