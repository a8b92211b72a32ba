"""The tensor-parallel regions' math (models/tp.py) on a real 4-rank gloo
group (mesh data 2 x model 2, or data 1 x model 4), against the plain
model.

Every reduced config below runs its forward, its CE loss and the gradient
of every parameter twice in one process: plain, and as a DTensor step in
the 2D mode (parameters laid out by `param_shardings`, the batch by
`batch_shardings`, `act_axes=("data",)`). The modules' bf16 and f32 casts
are set to float64 in the rank processes (`BF16`, `F32` of layers, lm and
recurrent), so both runs round nothing and differ only by the order of
their sums: they must agree within 1e-10, relative to the largest value.

The configs cover each layout: GQA with the KV heads split (llama3-405b,
kv 2 over 2), MQA with the KV head sliced from the whole weight and the
RG-LRU (recurrentgemma-2b, kv 1 over 2), the query-sequence split (a
copy of gemma2-27b with 3 heads, local window and softcaps), RWKV6 by
whole heads and, with one 128-wide head, by key channels, MLA with the MoE
and its shared expert (deepseek-v2-236b), cross-attention and the encoder
(seamless-m4t-medium), and both MoE dispatches (granite-moe-3b-a800m,
'global' and 'per_example'). On model 4, the ranks above the first take
a KV head and a head of key channels other than the first: llama3-405b's
8 heads, kv 2 (KV head 1 for ranks 2 and 3) and rwkv6-1.6b's 2 heads
(head 1 for ranks 2 and 3). Each records which region helpers ran, so a
config that fell back to DTensor's own layout shows."""
import json

import pytest

from _torch_plans import start_ranks

# name -> (arch, config overrides, mesh (data, model))
CONFIGS = {
    "llama3-405b": ("llama3-405b", {}, (2, 2)),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, (2, 2)),
    "gemma2-27b-3-heads": ("gemma2-27b", {"n_heads": 3, "n_kv_heads": 1},
                           (2, 2)),
    "rwkv6-1.6b": ("rwkv6-1.6b", {}, (2, 2)),
    "rwkv6-1.6b-1-head": ("rwkv6-1.6b", {"rwkv_head_dim": 128}, (2, 2)),
    "deepseek-v2-236b": ("deepseek-v2-236b", {}, (2, 2)),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, (2, 2)),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}, (2, 2)),
    "granite-moe-3b-a800m-per-example": (
        "granite-moe-3b-a800m", {"moe_dispatch": "per_example"}, (2, 2)),
    "llama3-405b-model-4": ("llama3-405b", {}, (1, 4)),
    "rwkv6-1.6b-model-4": ("rwkv6-1.6b", {}, (1, 4)),
}

# the region helpers each config must run (beyond enter / column / row)
_LAYOUT = {"llama3-405b": {"exit_sum"},
           "recurrentgemma-2b": {"whole", "gather"},
           "gemma2-27b-3-heads": {"rows", "gather_rows", "exit_rows"},
           "rwkv6-1.6b": {"scatter", "all_sum"},
           "rwkv6-1.6b-1-head": {"all_sum", "whole"},
           "deepseek-v2-236b": {"gather"},
           "seamless-m4t-medium": {"exit_sum"},
           "granite-moe-3b-a800m": {"exit_sum"},
           "granite-moe-3b-a800m-per-example": {"exit_gather", "own"},
           "llama3-405b-model-4": {"whole", "exit_sum"},
           "rwkv6-1.6b-model-4": {"all_sum", "whole", "own"}}

_RANK = r"""
import collections, dataclasses, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import all_archs
from repro_torch.models import layers as L, lm as M, recurrent as R
from repro_torch.models import sharding as S, tp as T
from repro_torch.models.tree import leaves, tree_map, unflatten_like
F64 = torch.float64
for mod in (L, M, R):
    mod.BF16 = mod.F32 = F64
calls = collections.Counter()

def counted(name, fn):
    def wrap(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)
    return wrap
for name, fn in list(vars(T.Region).items()):
    if callable(fn) and not name.startswith("_"):
        setattr(T.Region, name, counted(name, fn))
meshes = {}
configs = json.loads(open(path).read())
B, T_ = 4, 32

def run(params, batch, cfg):
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten_like(params, flat)
    hidden = M.forward(tree, cfg, tokens=batch["tokens"],
                       enc_inputs=batch.get("enc_inputs"),
                       patch_embeds=batch.get("patch_embeds"))
    loss = M.ce_loss(tree, cfg, hidden, batch["labels"])
    return [hidden, loss, *torch.autograd.grad(loss, flat)]

out = {}
for name, (arch, kw, shape) in configs.items():
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = init_device_mesh("cpu", shape,
                                         mesh_dim_names=("data", "model"))
    mesh = meshes[shape]
    cfg = dataclasses.replace(all_archs()[arch].reduced, **kw)
    params = tree_map(lambda t: t.to(F64), M.init_params(cfg, 0,
                                                         device="cpu"))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, T_), generator=gen)
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["enc_inputs"] = torch.randn(B, T_, cfg.d_model, generator=gen,
                                          dtype=F64)
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = torch.randn(B, cfg.n_patches, cfg.d_model,
                                            generator=gen, dtype=F64)
    calls.clear()
    plain = run(params, batch, cfg)
    plain_calls = sum(calls.values())
    calls.clear()
    sh = S.param_shardings(mesh, params)
    placed = unflatten_like(params, [s.place(t) for t, s in
                                     zip(leaves(params), leaves(sh))])
    dbatch = {k: S.batch_shardings(mesh, v).place(v)
              for k, v in batch.items()}
    with implicit_replication():
        sharded = [t.full_tensor() for t in
                   run(placed, dbatch,
                       dataclasses.replace(cfg, act_axes=("data",)))]
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(sharded, plain)]
    out[name] = {"hidden": rel[0], "loss": rel[1], "grads": max(rel[2:]),
                 "n_grads": len(rel) - 2, "plain_calls": plain_calls,
                 "calls": dict(calls)}
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp") / "configs.json"
    path.write_text(json.dumps(CONFIGS))
    procs = start_ranks(_RANK, path)
    logs = []
    for p in procs:
        log, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        logs.append(log)
    return json.loads(logs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_step_equals_plain_in_float64(sharded, name):
    """The DTensor step's hidden states, loss and every parameter's
    gradient equal the plain model's within 1e-10 in float64, the step
    ran through the regions (enter, column and row parallel weights and
    the config's own layout), and the plain run through none."""
    got = sharded[name]
    assert got["n_grads"] > 10
    for key in ("hidden", "loss", "grads"):
        assert got[key] < 1e-10, (key, got[key])
    assert got["plain_calls"] == 0
    ran = set(got["calls"])
    assert {"enter", "column", "row"} <= ran, ran
    assert _LAYOUT[name] <= ran, ran
