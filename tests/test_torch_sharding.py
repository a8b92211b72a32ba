"""The port's sharding specs and meshes against the JAX package's: the spec
of every parameter leaf of the ten archs in both modes, and the local shard
shape of every parameter, batch input and decode cache on the production
meshes (DTensor on the fake process group, in a child process) against
`NamedSharding(AbstractMesh(...), reference spec).shard_shape`."""
import jax
import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_archs as j_all_archs
from repro.models import sharding as JS
from repro_torch.configs.base import all_archs
from repro_torch.models import sharding as S
from repro_torch.models.lm import init_params_shape_only
from repro_torch.models.tree import flatten_with_path

from _torch_plans import abstract_mesh, ref_dryrun, run_child

ARCHS = list(all_archs())
MODES = ["2d", "fsdp"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_param_specs(arch_id, mode):
    from repro.models.lm import init_params_shape_only as j_shapes
    cfg = j_all_archs()[arch_id].config
    flat = jax.tree_util.tree_flatten_with_path(j_shapes(cfg))[0]
    return {jax.tree_util.keystr(p): (tuple(leaf.shape),
                                      tuple(JS.spec_for(p, leaf, mode)))
            for p, leaf in flat}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_spec_for_matches_reference(arch_id, mode):
    want = _ref_param_specs(arch_id, mode)
    got = {path: (tuple(leaf.shape), tuple(S.spec_for(path, leaf, mode)))
           for path, leaf in flatten_with_path(
               init_params_shape_only(all_archs()[arch_id].config))}
    assert got == want


@pytest.mark.parametrize("arch_id", ARCHS)
def test_sharding_specs_divide_production_mesh(arch_id):
    cfg = all_archs()[arch_id].config
    n_sharded = 0
    for path, leaf in flatten_with_path(init_params_shape_only(cfg)):
        spec = S.spec_for(path, leaf)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            assert leaf.shape[dim] % 16 == 0, (arch_id, path, leaf.shape,
                                               spec)
            n_sharded += 1
    assert n_sharded > 0  # big matrices must actually shard


def test_spec_and_placements_of_a_pod_wide_dim():
    """A dim split over two axes is Shard(d) on both mesh dims; a one-name
    tuple is kept as the name (as PartitionSpec keeps it)."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert S.Spec(("data",), None) == ("data", None)
    assert S.placements(Mesh(), S.Spec(None, ("data", "model"))) == (
        Replicate(), Shard(1), Shard(1))
    assert S.placements(Mesh(), S.Spec(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))


# one child lays every tree out on both production meshes
_CHILD = """
import json
from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as S
from repro_torch.models.lm import init_params_shape_only
from repro_torch.models.tree import flatten_with_path, leaves
from repro_torch.serving.decode import init_cache
import torch

def local(t, sh):
    dt = sh.place(t)
    assert tuple(dt.shape) == tuple(t.shape)
    return list(dt.to_local().shape)

out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    rec = {"params": {}, "batch": {}, "cache": {}}
    for arch_id, spec in all_archs().items():
        shapes = init_params_shape_only(spec.config)
        for mode in ("2d", "fsdp"):
            psh = S.param_shardings(mesh, shapes, mode)
            rec["params"][f"{arch_id}|{mode}"] = {
                p: local(t, sh) for (p, t), sh in
                zip(flatten_with_path(shapes), leaves(psh))}
        for shape_name, sh in SHAPES.items():
            if shape_name in spec.skip_shapes:
                continue
            batch = dryrun.input_specs(arch_id, shape_name)
            for mode in ("2d", "fsdp"):
                bsh = S.batch_shardings(mesh, batch, mode)
                rec["batch"][f"{arch_id}|{shape_name}|{mode}"] = {
                    k: local(batch[k], bsh[k]) for k in batch}
            if sh.kind == "decode":
                cfg = spec.config
                cache = init_cache(cfg, sh.global_batch, sh.seq_len,
                                   enc_len=sh.seq_len if cfg.enc_dec else 0,
                                   device="meta")
                csh = S.cache_shardings(mesh, cache)
                rec["cache"][f"{arch_id}|{shape_name}"] = {
                    p: local(t, s) for (p, t), s in
                    zip(flatten_with_path(cache), leaves(csh))}
    odd = torch.empty((3, 7), dtype=torch.int32, device="meta")
    osh = S.batch_shardings(mesh, odd)
    rec["odd"] = [list(osh.spec), local(odd, osh)]
    out[name] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_layouts():
    return run_child(_CHILD, timeout=600)


def _shard_shape(mesh, spec, shape):
    from jax.sharding import NamedSharding
    return list(NamedSharding(mesh, spec).shard_shape(tuple(shape)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_shard_shapes_match_reference(port_layouts, mesh_name):
    from repro.models.lm import init_params_shape_only as j_shapes
    mesh = abstract_mesh(*MESHES[mesh_name])
    got = port_layouts[mesh_name]["params"]
    n = 0
    for arch_id, spec in j_all_archs().items():
        shapes = j_shapes(spec.config)
        for mode in MODES:
            sh = JS.param_shardings(mesh, shapes, mode)
            want = {jax.tree_util.keystr(p): _shard_shape(mesh, s.spec,
                                                          leaf.shape)
                    for (p, leaf), s in zip(
                        jax.tree_util.tree_flatten_with_path(shapes)[0],
                        jax.tree.leaves(sh))}
            assert got[f"{arch_id}|{mode}"] == want, (arch_id, mode)
            n += len(want)
    assert n > 400


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_shard_shapes_match_reference(port_layouts, mesh_name):
    dr = ref_dryrun()
    mesh = abstract_mesh(*MESHES[mesh_name])
    got = port_layouts[mesh_name]["batch"]
    for arch_id, spec in j_all_archs().items():
        for shape_name in JSHAPES:
            if shape_name in spec.skip_shapes:
                continue
            batch = dr.input_specs(arch_id, shape_name)
            for mode in MODES:
                sh = JS.batch_shardings(mesh, batch, mode)
                want = {k: _shard_shape(mesh, sh[k].spec, batch[k].shape)
                        for k in batch}
                assert got[f"{arch_id}|{shape_name}|{mode}"] == want, (
                    arch_id, shape_name, mode)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_shard_shapes_match_reference(port_layouts, mesh_name):
    from repro.serving.decode import init_cache
    mesh = abstract_mesh(*MESHES[mesh_name])
    got = port_layouts[mesh_name]["cache"]
    n = 0
    for arch_id, spec in j_all_archs().items():
        cfg = spec.config
        for shape_name, sh in JSHAPES.items():
            if sh.kind != "decode" or shape_name in spec.skip_shapes:
                continue
            cache = jax.eval_shape(lambda: init_cache(
                cfg, sh.global_batch, sh.seq_len,
                enc_len=sh.seq_len if cfg.enc_dec else 0))
            csh = JS.cache_shardings(mesh, cache)
            want = {jax.tree_util.keystr(p): _shard_shape(mesh, s.spec,
                                                          leaf.shape)
                    for (p, leaf), s in zip(
                        jax.tree_util.tree_flatten_with_path(cache)[0],
                        jax.tree.leaves(csh))}
            assert got[f"{arch_id}|{shape_name}"] == want, (arch_id,
                                                            shape_name)
            n += 1
    assert n >= 10


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_sharding_falls_back_when_indivisible(port_layouts, mesh_name):
    spec, local = port_layouts[mesh_name]["odd"]
    assert spec == [] and local == [3, 7]


def test_dev_mesh_places_a_reduced_config_whole():
    """The (1,1) device mesh (a world-size-1 gloo group on the CPU): every
    parameter's local shape is its global one, and `_pin_batch` pins a
    DTensor's batch dim to act_axes."""
    out = run_child("""
import dataclasses, json, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs.base import all_archs
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import sharding as S
from repro_torch.models.lm import _pin_batch, init_params
from repro_torch.models.tree import leaves
cfg = all_archs()["granite-moe-3b-a800m"].reduced
params = init_params(cfg, 0, device="cpu")
mesh = make_dev_mesh("cpu")
sh = S.param_shardings(mesh, params)
same = [tuple(s.place(t).to_local().shape) == tuple(t.shape)
        for t, s in zip(leaves(params), leaves(sh))]
x = distribute_tensor(torch.ones(4, 3), mesh, [Replicate(), Replicate()])
pinned = _pin_batch(x, dataclasses.replace(cfg, act_axes=("data",)))
print(json.dumps({"n": len(same), "same": all(same),
                  "pinned": [repr(p) for p in pinned.placements],
                  "equal": bool(torch.equal(pinned.full_tensor(),
                                            torch.ones(4, 3)))}))
""")
    assert out["n"] > 10 and out["same"]
    assert out["pinned"][0].startswith("Shard(dim=0")
    assert out["pinned"][1].startswith("Replicate")
    assert out["equal"]
