"""Partition specs for the (pod, data, model) production mesh, as DTensor
placements.

Scheme (DESIGN.md §6): 2D parameter sharding — FSDP over 'data' on one dim,
tensor parallelism over 'model' on the other; activations/batch over
('pod','data'); experts (EP) and vocab over 'model'. The 'pod' axis is pure
DP (gradient all-reduce crosses DCN once per step, optionally compressed).

Rules are name+shape driven so they apply to every arch in the pool; leaves
whose dims don't divide the mesh fall back to replication.

A `Spec` holds one entry per tensor dim, as the JAX package's
`PartitionSpec` does: None (replicated), a mesh axis name, or a tuple of
names (the dim split over each, major to minor). `placements` turns it into
one `Shard`/`Replicate` per dim of a `DeviceMesh`; a dim split over two
axes is `Shard(d)` on both mesh dims. A `Sharding` pairs a mesh with a spec,
as a `NamedSharding` does, and `place` lays a tensor out by one.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from repro_torch.models.tree import flatten_with_path, tree_map, unflatten_like


class Spec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names. A
    one-name tuple is kept as the name, as `PartitionSpec` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _axis_size(mesh, name: str) -> int:
    return int(mesh.size(_axis_names(mesh).index(name)))


def placements(mesh, spec: Spec) -> tuple:
    """One DTensor placement per mesh dim: Shard(d) where `spec` names that
    dim's axis at tensor dim d, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in _axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the `NamedSharding` counterpart). Not a tuple, so
    a tree of Shardings has them as its leaves."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, tensor):
        """`tensor` as a DTensor laid out by this sharding (the first
        device's shard as its local tensor)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, self.placements)


# param-name -> (fsdp_dim, tp_dim) for 2D matrices (-1 = none)
_MATRIX_RULES = {
    # in-projections (D, out): FSDP on D, TP on out
    "wq": (0, 1), "wk": (0, 1), "wv": (0, 1), "wg": (0, 1),
    "xq": (0, 1), "xk": (0, 1), "xv": (0, 1),
    "w_gate": (0, 1), "w_up": (0, 1), "wk_ch": (0, 1), "wr_ch": (0, 1),
    "w_in": (0, 1), "w_gate_branch": (0, 1),
    "wq_a": (0, 1), "wq_b": (0, 1), "wkv_a": (0, 1), "wkv_b": (0, 1),
    "wr": (0, 1), "w_rg": (0, 1), "w_ig": (0, 1),
    # out-projections (in, D): TP on in (contraction), FSDP on D
    "wo": (1, 0), "xo": (1, 0), "w_down": (1, 0), "wv_ch": (1, 0),
    "w_out": (1, 0),
    # router (D, E): FSDP on D only
    "router": (0, -1),
}

_EXPERT_PARAMS = {"w_gate", "w_up", "w_down"}  # when rank-3: (E, ., .)

_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _path_keys(path) -> list:
    """A `tree.flatten_with_path` keystr (``['groups'][0]['b0']['wq']``)
    or a sequence of keys -> [dict key (str) | sequence index (int)]."""
    if isinstance(path, str):
        return [m.group(1) if m.group(1) is not None else int(m.group(2))
                for m in _KEY.finditer(path)]
    return list(path)


def spec_for(path, leaf, mode: str = "2d") -> Spec:
    """Leading stacked-layer dims get None.

    mode='2d'   : FSDP over 'data' + TP over 'model' (default).
    mode='fsdp' : pure FSDP — parameters sharded over BOTH axes on one dim,
                  no tensor parallelism; batch shards over both axes too.
    """
    name = None
    in_experts = False
    for key in _path_keys(path):
        if key == "moe":
            in_experts = True
        if key == "shared":
            in_experts = False  # shared experts are plain dense matrices
        if isinstance(key, str):
            name = key
    shape = tuple(leaf.shape)
    nd = len(shape)

    if name in ("embed", "head"):
        if mode == "fsdp":
            return Spec(None, ("data", "model")) if shape[1] % 256 == 0 \
                else Spec(None, "model")
        return Spec(None, "model")
    if name is None or nd <= 1:
        return Spec(*([None] * nd))

    # stacked rank: matrices may carry 1 (stacked repeats) leading dim;
    # experts carry (repeats, E) or (E,) leading dims
    if name in _MATRIX_RULES:
        fsdp, tp = _MATRIX_RULES[name]
        if in_experts and name in _EXPERT_PARAMS:
            # (..., E, d1, d2): EP over 'model' on E + FSDP over 'data' on
            # the d_model dim. Unpadded expert counts (E % 16 != 0) skip EP
            # and shard d_model over the whole pod.
            lead = nd - 3
            d_dim = lead + 1 if name in ("w_gate", "w_up") else lead + 2
            spec = [None] * nd
            if shape[lead] % 16 == 0:
                spec[lead] = "model"
                if shape[d_dim] % 16 == 0:
                    spec[d_dim] = "data"
            elif shape[d_dim] % 256 == 0:
                spec[d_dim] = ("data", "model")
            elif shape[d_dim] % 16 == 0:
                spec[d_dim] = "data"
            return Spec(*spec)
        lead = nd - 2
        spec = [None] * nd
        if mode == "fsdp":
            # shard ONE dim over the whole 256-chip pod; no TP
            for dim in (fsdp, tp):
                if dim >= 0 and shape[lead + dim] % 256 == 0:
                    spec[lead + dim] = ("data", "model")
                    return Spec(*spec)
            for dim in (fsdp, tp):
                if dim >= 0 and shape[lead + dim] % 16 == 0:
                    spec[lead + dim] = "data"
                    return Spec(*spec)
            return Spec(*spec)
        if fsdp >= 0 and shape[lead + fsdp] % 16 == 0:
            spec[lead + fsdp] = "data"
        if tp >= 0 and shape[lead + tp] % 16 == 0:
            spec[lead + tp] = "model"
        return Spec(*spec)
    return Spec(*([None] * nd))


def param_shardings(mesh, params_shape, mode: str = "2d"):
    """Tree of Shardings matching `params_shape` (e.g. the meta tree of
    `init_params_shape_only`)."""
    flat = flatten_with_path(params_shape)
    return unflatten_like(params_shape,
                          [Sharding(mesh, spec_for(path, leaf, mode))
                           for path, leaf in flat])


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def batch_spec(mesh) -> Spec:
    axes = _data_axes(mesh)
    return Spec(axes if len(axes) > 1 else axes[0])


def batch_shardings(mesh, batch_shape, mode: str = "2d"):
    axes = _data_axes(mesh)
    if mode == "fsdp":
        axes = axes + ("model",)     # pure-DP: batch over the whole pod
    n_data = int(np.prod([_axis_size(mesh, a) for a in axes]))

    def leaf_spec(leaf):
        if leaf.shape and leaf.shape[0] % n_data == 0:
            return Sharding(mesh,
                            Spec(axes, *([None] * (len(leaf.shape) - 1))))
        return Sharding(mesh, Spec())
    return tree_map(leaf_spec, batch_shape)


def cache_shardings(mesh, cache_shape):
    """KV caches (leaves are (R, B, S|W|H, ...), stacked over the repeats):
    batch dim 1 over ('pod','data'), dim 2 (sequence / window /
    state-heads) over 'model' — the cache is the decode working set and must
    spread over the whole pod. Dims that don't divide the mesh fall back to
    replication per dim."""
    axes = _data_axes(mesh)
    n_data = int(np.prod([_axis_size(mesh, a) for a in axes]))
    n_model = _axis_size(mesh, "model") if "model" in _axis_names(mesh) \
        else 1

    def leaf_spec(leaf):
        spec = [None] * len(leaf.shape)
        if len(leaf.shape) >= 2 and leaf.shape[1] % n_data == 0:
            spec[1] = axes
        if len(leaf.shape) >= 3 and leaf.shape[2] % n_model == 0:
            spec[2] = "model"
        return Sharding(mesh, Spec(*spec))
    return tree_map(leaf_spec, cache_shape)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, Spec())
