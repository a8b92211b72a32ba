"""The dry run's collective counter (`launch/dryrun.py:CostMode`) against the
JAX package's `parse_collectives`, and the sharded kmeans-fraud iteration.

(a) Hand-built programs with one known collective each: a Shard(0)-by-Shard
    product reduced to Replicate (all-reduce), a Shard(0) tensor gathered
    (all-gather), a product reduced to Shard(0) (reduce-scatter), and a
    Shard(0) -> Shard(1) redistribution, which must read as all-to-all.
    The reference's side is the same program compiled by XLA on 8 host
    devices, its HLO parsed with the `/*index=N*/` comments stripped first
    (the reference's regex cannot cross the `=` in them and undercounts a
    tuple collective).
(b) The reduced kmeans iteration (n=4096, d=64, k=16, d_a=32) on a
    (data=4, model=2) mesh: the port's all-reduce bytes equal the
    reference's corrected parse, and its peak lies between its arguments
    and its arguments plus everything the step allocates.
(c) The same iteration's words on a real 4-rank gloo group (mesh 2 x 2):
    equal to the unsharded port's and the reference's jitted
    `online_iteration_fn`'s, word for word. This is what shows that the
    iteration's reduction points are right: on meta tensors a wrong
    reduction cannot show.

The fake group and the 8-device XLA backend each run in a child process."""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ring as jring
from repro.core.kmeans import _encode_np
from repro.core.triples import TrustedDealer as JTrustedDealer
from repro.launch import kmeans_step as JKS
from repro_torch.core import ring
from repro_torch.launch import dryrun
from repro_torch.launch import kmeans_step as KS

from _torch_plans import ROOT, run_child

N, D, K, DA = 4096, 64, 16, 32
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "link_bytes")
PROGRAMS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_REF_CHILD = r"""
import json, os, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
jax.devices()
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch import dryrun as D
from repro.launch.kmeans_step import arg_shardings, online_iteration_fn
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
mesh = jax.make_mesh((4, 2), ("data", "model"))

def parse(compiled):
    return D.parse_collectives(re.sub(r"/\*.*?\*/", "", compiled.as_text()))

def sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)

def ns(*spec):
    return NamedSharding(mesh, P(*spec))

def mm(a, b):
    return a @ b

def scatter(a, b):
    return jax.lax.psum_scatter(a @ b, "data", scatter_dimension=0,
                                tiled=True)
out = {
    "all-reduce": parse(jax.jit(
        mm, in_shardings=(ns(None, "data"), ns("data", None)),
        out_shardings=ns()).lower(sds(16, 64), sds(64, 32)).compile()),
    "all-gather": parse(jax.jit(
        lambda x: x, in_shardings=ns("data", None),
        out_shardings=ns()).lower(sds(64, 32)).compile()),
    "reduce-scatter": parse(jax.jit(shard_map(
        scatter, mesh=mesh, in_specs=(P(None, "data"), P("data", None)),
        out_specs=P("data", None))).lower(sds(16, 64),
                                          sds(64, 32)).compile()),
    "all-to-all": parse(jax.jit(
        lambda x: x, in_shardings=ns("data", None),
        out_shardings=ns(None, "data")).lower(sds(64, 64)).compile())}
fn, args = online_iteration_fn(%d, %d, %d, %d)
compiled = jax.jit(fn, in_shardings=arg_shardings(mesh, args, %d),
                   out_shardings=ns()).lower(*args).compile()
out["kmeans"] = parse(compiled)
out["kmeans_uncorrected"] = D.parse_collectives(compiled.as_text())
print(json.dumps(out))
""" % (N, D, K, DA, N)

_PORT_CHILD = r"""
import json
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun
from repro_torch.launch.kmeans_step import arg_shardings, online_iteration_fn
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import layers as L
mesh = make_fake_mesh((4, 2), ("data", "model"))
R = Replicate()

def on(shape, *placements):
    return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                             placements)
a, b = on((16, 64), Shard(1), R), on((64, 32), Shard(0), R)
x, y = on((64, 32), Shard(0), R), on((64, 64), Shard(0), R)
programs = {
    "all-reduce": (lambda a, b: (a @ b).redistribute(mesh, (R, R)), (a, b)),
    "all-gather": (lambda x: x.redistribute(mesh, (R, R)), (x,)),
    "reduce-scatter": (lambda a, b: (a @ b).redistribute(mesh, (Shard(0), R)),
                       (a, b)),
    "all-to-all": (lambda y: y.redistribute(mesh, (Shard(1), R)), (y,))}
out = {name: dryrun.count_cost(fn, *args)["collectives"]
       for name, (fn, args) in programs.items()}
fn, args = online_iteration_fn(%d, %d, %d, %d, device="meta")
out["kmeans"] = dryrun.count_on_mesh(fn, args,
                                     arg_shardings(mesh, args, %d), 8)
# three heads over a width sharded two ways: DTensor cannot split it as it
# is; split_dims gathers that dim first
h = on((2, 3, 12), R, Shard(2))
try:
    h.reshape(2, 3, 3, 4)
    out["plain_split_raises"] = False
except RuntimeError:
    out["plain_split_raises"] = True
split = L.split_dims(h, 2, 3, 3, 4)
out["split"] = [list(split.shape), [str(p) for p in split.placements]]
# the backward of merging three heads into a width splits the width's
# gradient, which a product with a weight sharded on its rows leaves
# sharded two ways: merge_dims gathers it first
def merged_grad(merge):
    x = on((2, 3, 4), R, R).requires_grad_(True)
    y = merge(x) @ on((12, 5), R, Shard(0))
    (g,) = torch.autograd.grad(y, x, grad_outputs=on((2, 5), R, R))
    return [str(p) for p in g.placements]
try:
    merged_grad(lambda x: x.reshape(2, 12))
    out["plain_merge_grad_raises"] = False
except RuntimeError:
    out["plain_merge_grad_raises"] = True
out["merge_grad"] = merged_grad(lambda x: L.merge_dims(x, 2, 12))
print(json.dumps(out))
""" % (N, D, K, DA, N)


@pytest.fixture(scope="module")
def ref_counts():
    return run_child(_REF_CHILD, timeout=300)


@pytest.fixture(scope="module")
def port_counts():
    return run_child(_PORT_CHILD, timeout=300)


@pytest.mark.parametrize("program", PROGRAMS)
def test_hand_built_collectives_match_reference(port_counts, ref_counts,
                                                program):
    got, want = port_counts[program], ref_counts[program]
    assert set(got) == set(KINDS) == set(want)
    assert got == want, program
    assert got[program] > 0
    # the Shard(0) -> Shard(1) redistribution is one all-to-all of its
    # result (64 x 16 f32 words a device), not the CPU fallback's all-gather
    if program == "all-to-all":
        assert got["all-gather"] == 0 and got["all-to-all"] == 64 * 16 * 4


def test_kmeans_all_reduce_bytes_match_reference(port_counts, ref_counts):
    """S3's ten (k, d/2) products over the sharded samples (two local, four
    in each of the two Beaver products, FUSE_BEAVER on) and the two (k,)
    sums of C are all-reduced: 10 * 16 * 32 * 8 + 2 * 16 * 8 = 41,216
    bytes, the reference's count once its tuple all-reduce is parsed whole
    (it reads 256 with the `/*index=N*/` comments left in)."""
    got = port_counts["kmeans"]
    want = ref_counts["kmeans"]
    assert got["count_basis"] == "per-device"
    assert got["collectives"] == want
    assert want["all-reduce"] == 10 * K * (D // 2) * 8 + 2 * K * 8 == 41216
    assert ref_counts["kmeans_uncorrected"]["all-reduce"] == 256
    assert want["link_bytes"] == 2 * 41216


def test_kmeans_peak_memory_bounds(port_counts):
    """The high-water mark of live local storages is at least the
    arguments (the first device's shards) and at most the arguments plus
    every storage the step allocates."""
    cost = port_counts["kmeans"]
    args = cost["argument_bytes"]
    rec = dryrun.analyze(cost)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == args > 0
    assert args < mem["peak_memory_in_bytes"] <= args + cost["allocated"]
    assert mem["temp_size_in_bytes"] == mem["peak_memory_in_bytes"] - args
    # the first device's shards: n over the 4 data devices
    assert args * 4 > dryrun._nbytes(list(KS.online_iteration_fn(
        N, D, K, DA, device="meta")[1])) > args


def test_split_dims_gathers_a_dim_its_heads_do_not_divide(port_counts):
    assert port_counts["plain_split_raises"]
    assert port_counts["split"] == [[2, 3, 3, 4], ["R", "R"]]


def test_merge_dims_gathers_a_gradient_its_heads_do_not_divide(port_counts):
    assert port_counts["plain_merge_grad_raises"]
    assert port_counts["merge_grad"] == ["R", "R"]


def test_reduced_products_forwards_every_op():
    """The iteration's backend wrapper all-reduces dense products only; the
    sparse ops are the inner backend's own (the numpy backend's CSR loop,
    which packs no ELL), and so is any other attribute."""
    from repro_torch.core import backend as B
    from repro_torch.core import sparse as S
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 63, (40, 24), dtype=np.uint64) \
        * (rng.random((40, 24)) >= 0.8)
    y = ring.from_u64_numpy(rng.integers(0, 2 ** 63, (24, 5),
                                         dtype=np.uint64))
    inner = B.NumpyBackend()
    wrapped = KS._ReducedProducts(inner)
    csr = S.CSRMatrix.from_dense(x)
    before = S.ELL_PACK_SECONDS
    got = wrapped.ring_spmm_csr(csr, y)
    assert S.ELL_PACK_SECONDS == before and "_ell" not in csr.__dict__
    assert torch.equal(got, inner.ring_spmm_csr(csr, y))
    a = ring.from_u64_numpy(x)
    assert torch.equal(wrapped.ring_mm(a, y), inner.ring_mm(a, y))
    blocks, idx, counts = S.CSRMatrix.from_dense(x).ell(bm=8, bk=128)
    pad = torch.cat([y, y.new_zeros((128 - 24, 5))])
    assert torch.equal(wrapped.ring_spmm(blocks, idx, counts, pad),
                       inner.ring_spmm(blocks, idx, counts, pad))
    assert wrapped.name == inner.name == "numpy"
    inner.extra = object()
    assert wrapped.extra is inner.extra


def _words(seed: int) -> list:
    """Encoded data, centroid shares and the reference's offline tensors
    of one dense iteration, as uint64 words."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (K, D))
    x = centers[rng.integers(0, K, N)] + rng.normal(0, 0.2, (N, D))
    enc = _encode_np(x, jring.F)
    mu = _encode_np(x[rng.choice(N, K, replace=False)], jring.F)
    r = rng.integers(0, 2 ** 63, (K, D), dtype=np.uint64)
    words = [enc[:, :DA], enc[:, DA:], r, (mu - r).astype(np.uint64)]
    flat = JKS.materialize_offline(JKS.record_offline_shapes(N, D, K, DA),
                                   JTrustedDealer(seed=seed + 1))
    words += [np.asarray(t, np.uint64) for t in flat]
    return [np.ascontiguousarray(w, np.uint64) for w in words]


_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.core import ring
from repro_torch.launch import kmeans_step as KS
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
fn, args = KS.online_iteration_fn(%d, %d, %d, %d, device="cpu")
words = np.load(path + "/words.npz")
shards = [sh.place(ring.from_u64_numpy(words[f"a{i}"])) for i, sh in
          enumerate(KS.arg_shardings(mesh, args, %d))]
with implicit_replication():
    out = fn(*shards)
full = [o.full_tensor() for o in out]
if rank == 0:
    np.savez(path + "/out.npz", *[ring.to_u64_numpy(t) for t in full],
             placements=np.array([str(o.placements) for o in out]))
dist.destroy_process_group()
""" % (N, D, K, DA, N)


def _start_ranks(code: str, arg) -> list:
    """Four processes running `code` as ranks 0-3 of a gloo group at a
    free localhost port (argv: rank, port, arg)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                              str(arg)], cwd=str(ROOT), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for r in range(4)]


def test_sharded_iteration_words_match_unsharded_and_reference(tmp_path):
    words = _words(seed=11)
    np.savez(tmp_path / "words.npz",
             **{f"a{i}": w for i, w in enumerate(words)})
    procs = _start_ranks(_RANK, tmp_path)
    jfn, _ = JKS.online_iteration_fn(N, D, K, DA, backend="xla")
    want = [np.asarray(w, np.uint64)
            for w in jax.jit(jfn)(*[jnp.asarray(w) for w in words])]
    fn, _ = KS.online_iteration_fn(N, D, K, DA, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = [ring.to_u64_numpy(t)
                 for t in fn(*[ring.from_u64_numpy(w) for w in words])]
    finally:
        torch.set_num_threads(threads)
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    got = np.load(tmp_path / "out.npz")
    assert list(got["placements"]) == ["(Replicate(), Replicate())"] * 2
    for i, (w, pl) in enumerate(zip(want, plain)):
        np.testing.assert_array_equal(pl, w)
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


_MOE_RANK = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, axes = int(sys.argv[1]), sys.argv[2], tuple(sys.argv[3].split(","))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import all_archs
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models.lm import init_params
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(all_archs()["granite-moe-3b-a800m"].reduced,
                          moe_dispatch="per_example", act_axes=axes)
moe = init_params(cfg, 0, device="cpu")["groups"][0]["b0"]["moe"]
p = {k: v[0].to(torch.float64) for k, v in moe.items()}
gen = torch.Generator().manual_seed(0)
x = torch.randn(4, 32, cfg.d_model, generator=gen, dtype=torch.float64)
co = torch.randn(4, 32, cfg.d_model, generator=gen, dtype=torch.float64)

def run(x, p, co):
    x = x.detach().requires_grad_(True)
    ps = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    out = L.moe_mlp(ps, x, cfg)
    return out, torch.autograd.grad((out * co).sum(), [x, *ps.values()])
out, grads = run(x, p, co)
sh = S.param_shardings(mesh, {"moe": p})["moe"]
batch = [Shard(0) if a in axes else Replicate() for a in ("data", "model")]
with implicit_replication():
    dout, dgrads = run(distribute_tensor(x, mesh, batch),
                       {k: sh[k].place(v) for k, v in p.items()},
                       distribute_tensor(co, mesh, batch))
    dout, dgrads = dout.full_tensor(), [g.full_tensor() for g in dgrads]
if rank == 0:
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    print(json.dumps({"out": rel(dout, out),
                      "grads": dict(zip(["x", *p], map(rel, dgrads, grads)))}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("axes", ["data", "data,model"])
def test_moe_layer_on_a_4_rank_group_equals_plain(axes):
    """The MoE layer of a DTensor step (the dispatch, `_expert_ffn`'s
    expert-parallel einsums on the local shards, the combine) on a real
    4-rank gloo group (mesh 2 x 2), in float64: its output and every
    gradient equal the plain layer's. Tokens over 'data' and experts over
    'model' (2D), or tokens over both and every expert on each device
    (pure FSDP's batch axes). The router runs in float32, so the
    gradients that pass through it (the router's and the input's) agree
    to float32's precision; the experts' to float64's."""
    procs = _start_ranks(_MOE_RANK, axes)
    logs = []
    for p in procs:
        log, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        logs.append(log)
    got = json.loads(logs[0].strip().splitlines()[-1])
    assert got["out"] == 0.0
    assert set(got["grads"]) == {"x", "router", "w_gate", "w_up", "w_down"}
    for name, err in got["grads"].items():
        assert err < (1e-5 if name in ("x", "router") else 1e-12), name


def test_kmeans_cli_records_and_roofline_terms(tmp_path):
    """`dryrun --kmeans` on both production meshes and `roofline --arch
    kmeans-fraud`: collectives with the reference's six keys, the FULL
    cell's all-reduce (10 * 16 * 512 * 8 + 2 * 16 * 8 bytes a device on the
    single pod; twice that on two pods, where DTensor reduces over 'pod'
    and 'data' one after the other), and a float collective term."""
    from repro_torch.configs.kmeans_fraud import FULL
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    runs = {}
    for name, args in (("dryrun", ["--kmeans"]),
                       ("roofline", ["--arch", "kmeans-fraud"])):
        out = tmp_path / f"{name}.json"
        runs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{name}", *args,
             "--out", str(out)], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for name, (out, p) in runs.items():
        log, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        assert "cuda_initialized=False" in log
    one = 10 * FULL.k * FULL.d_a * 8 + 2 * FULL.k * 8
    assert one == 655616
    recs = json.loads(runs["dryrun"][0].read_text())
    assert [r["mesh_name"] for r in recs] == ["single", "multi"]
    for r, ways in zip(recs, (1, 2)):
        assert "collective_error" not in r
        assert set(r["collectives"]) == set(KINDS)
        assert r["collectives"]["all-reduce"] == ways * one
        assert r["memory"]["peak_memory_in_bytes"] \
            > r["memory"]["argument_size_in_bytes"]
    (row,) = json.loads(runs["roofline"][0].read_text())
    assert isinstance(row["collective_s"], float)
    assert row["collective_s"] == 2 * one / 450e9
    terms = {"compute": row["compute_s"], "memory": row["memory_s"],
             "collective": row["collective_s"]}
    assert row["dominant"] == max(terms, key=terms.get)
    assert row["roofline_step_s"] == max(terms.values())
