"""The port's dry run and roofline against the JAX package's: the cell list
and its skip records, the microbatch and moment tables, every input spec,
the analytic model FLOPs (float for float), and one laid-out and counted
cell each of train, prefill and decode on a fake (2, 2) mesh (in a child
process) whose argument bytes are the sum over the reference's shard
shapes, with the collectives and peak the DTensor step records, and the
probes' extrapolation against a full count."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import all_archs as j_all_archs
from repro.models import sharding as JS
from repro_torch.configs.base import SHAPES, all_archs
from repro_torch.launch import dryrun, roofline

from _torch_plans import (ROOT, abstract_mesh, ref_dryrun, ref_roofline,
                          run_child)

ARCHS = list(all_archs())
_DTYPES = {torch.int32: np.dtype(np.int32), torch.bfloat16: "bfloat16",
           torch.float32: np.dtype(np.float32)}


def test_cells_and_skip_records_match_reference():
    mine, ref = all_archs(), j_all_archs()
    assert list(mine) == list(ref)
    assert list(SHAPES) == list(JSHAPES)
    for name, sh in SHAPES.items():
        j = JSHAPES[name]
        assert (sh.seq_len, sh.global_batch, sh.kind) == (
            j.seq_len, j.global_batch, j.kind)
    for arch_id in mine:
        assert mine[arch_id].skip_shapes == ref[arch_id].skip_shapes
        assert mine[arch_id].skip_reason == ref[arch_id].skip_reason


def test_microbatch_and_moment_tables_match_reference():
    dr = ref_dryrun()
    assert dryrun.MICROBATCHES == dr.MICROBATCHES
    assert dryrun.BF16_MOMENT_ARCHS == dr.BF16_MOMENT_ARCHS


@pytest.mark.parametrize("arch_id", ARCHS)
def test_input_specs_match_reference(arch_id):
    dr = ref_dryrun()
    for shape_name in SHAPES:
        got = dryrun.input_specs(arch_id, shape_name)
        want = dr.input_specs(arch_id, shape_name)
        assert list(got) == list(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape_name,
                                                                 k)
            assert np.dtype(_DTYPES[got[k].dtype]) == np.dtype(
                want[k].dtype), (shape_name, k)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_model_flops_match_reference(arch_id):
    rf = ref_roofline()
    spec = all_archs()[arch_id]
    n = 0
    for shape_name in SHAPES:
        if shape_name in spec.skip_shapes:
            continue
        got = roofline.model_flops(arch_id, shape_name)
        assert got == rf.model_flops(arch_id, shape_name), shape_name
        n += 1
    assert n >= 3


def test_kmeans_model_flops_and_constants():
    from repro.configs.kmeans_fraud import FULL as JK
    from repro_torch.configs.kmeans_fraud import FULL, REDUCED
    from repro.configs import kmeans_fraud as jkf
    for mine in (FULL, REDUCED):
        ref = JK if mine.name == JK.name else jkf.REDUCED
        assert mine == type(mine)(**{f: getattr(ref, f) for f in
                                      ("name", "n", "d", "k", "d_a",
                                       "sparsity")})
    # the reference's plaintext-Lloyd formula (roofline.analyze_kmeans)
    want = 2.0 * JK.n * JK.d * JK.k + 4.0 * JK.n * JK.k + 2.0 * JK.n * JK.d
    assert roofline.kmeans_model_flops(FULL) == want
    # H100 SXM5 data-sheet figures, one chip pod of 256
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.CHIPS) == (989e12, 3.35e12, 450e9, 256)


def test_cost_mode_counts_what_flop_counter_mode_counts():
    """One mode counts FLOPs by FlopCounterMode's formulas (an int64 ring
    product on meta included) and the bytes of every non-view op."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import all_archs as archs
    from repro_torch.models.lm import forward, init_params_shape_only
    cfg = archs()["deepseek-v2-236b"].reduced
    params = init_params_shape_only(cfg)
    tok = torch.empty((2, 64), dtype=torch.int32, device="meta")

    def run():
        with torch.no_grad():
            forward(params, cfg, tokens=tok)
    fc = FlopCounterMode(display=False)
    with fc:
        run()
    cost = dryrun.count_cost(run)
    assert cost["flops"] == fc.get_total_flops() > 0
    a = torch.empty((1 << 20, 512), dtype=torch.int64, device="meta")
    b = torch.empty((512, 16), dtype=torch.int64, device="meta")
    from repro_torch.kernels.modmatmul import ring_matmul_plain
    mm = dryrun.count_cost(ring_matmul_plain, a, b)
    assert mm["flops"] == 2 * (1 << 20) * 512 * 16
    assert mm["bytes"] == 8 * ((1 << 20) * 512 + 512 * 16 + (1 << 20) * 16)
    view = dryrun.count_cost(lambda t: t.T, a)
    assert view["bytes"] == 0


# reduced configs at the cells' real shapes, on a (data=2, model=2) mesh
_CELLS = [("granite-34b", "train_4k"), ("granite-34b", "prefill_32k"),
          ("granite-34b", "decode_32k"), ("deepseek-v2-236b", "train_4k")]

_LOWER_CHILD = """
import json
from repro_torch.configs.base import all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh((2, 2), ("data", "model"))
out = {}
for arch_id, shape in %r:
    rec = dryrun.lower_cell(arch_id, shape, mesh,
                            cfg=all_archs()[arch_id].reduced)
    rec["mesh_name"] = "2x2"
    out[f"{arch_id}|{shape}"] = rec
print(json.dumps(out))
""" % (_CELLS,)


@pytest.fixture(scope="module")
def lowered():
    return run_child(_LOWER_CHILD, timeout=600)


def _ref_arg_bytes(arch_id, shape_name):
    """The reference's argument bytes of the cell on an abstract (2, 2)
    mesh: each argument's shard shape under the reference's specs."""
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.models.lm import init_params_shape_only
    from repro.serving.decode import init_cache
    dr = ref_dryrun()
    mesh = abstract_mesh((2, 2), ("data", "model"))
    cfg = j_all_archs()[arch_id].reduced
    sh = JSHAPES[shape_name]
    params = init_params_shape_only(cfg)
    psh = JS.param_shardings(mesh, params)
    batch = dr.input_specs(arch_id, shape_name, cfg=cfg)

    def nbytes(tree, shardings):
        return sum(int(np.prod(NamedSharding(mesh, s.spec).shard_shape(
            t.shape))) * np.dtype(t.dtype).itemsize
            for t, s in zip(jax.tree.leaves(tree),
                            jax.tree.leaves(shardings)))
    total = nbytes(params, psh)
    rep = NamedSharding(mesh, PartitionSpec())
    if sh.kind == "train":
        mom = 2 if arch_id in dr.BF16_MOMENT_ARCHS else 4
        leaves = jax.tree.leaves(params)
        total += 2 * sum(int(np.prod(NamedSharding(mesh, s.spec)
                                     .shard_shape(t.shape))) * mom
                         for t, s in zip(leaves, jax.tree.leaves(psh)))
        total += 4                                     # the int32 step
        total += nbytes(batch, JS.batch_shardings(mesh, batch))
    elif sh.kind == "prefill":
        total += nbytes(batch, JS.batch_shardings(mesh, batch))
    else:
        cache = jax.eval_shape(lambda: init_cache(
            cfg, sh.global_batch, sh.seq_len,
            enc_len=sh.seq_len if cfg.enc_dec else 0))
        total += nbytes(cache, JS.cache_shardings(mesh, cache))
        total += nbytes(batch["token"], JS.batch_shardings(mesh,
                                                           batch["token"]))
        total += nbytes(batch["pos"], rep)
    return total


@pytest.mark.parametrize("cell", _CELLS, ids=lambda c: "|".join(c))
def test_lower_cell_records(lowered, cell, tmp_path):
    from benchmarks.report import dryrun_table
    rec = lowered["|".join(cell)]
    assert rec["status"] == "ok" and rec["mesh"] == "2x2"
    assert (rec["arch"], rec["shape"]) == cell
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["compile_s"] >= 0 and rec["count_basis"] == "per-device"
    assert "collective_error" not in rec
    assert set(rec["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "link_bytes"}
    assert rec["collectives"]["link_bytes"] == dryrun.link_bytes(
        rec["collectives"]) > 0
    assert rec["probes"]["microbatches"] == dryrun.MICROBATCHES.get(cell, 1)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _ref_arg_bytes(*cell)
    assert mem["peak_memory_in_bytes"] == mem["argument_size_in_bytes"] \
        + mem["temp_size_in_bytes"] > mem["argument_size_in_bytes"]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps([rec]))
    table = dryrun_table(str(path))
    assert f"| {cell[0]} | {cell[1]} | 2x2 | ok |" in table


@pytest.mark.parametrize("module", ["dryrun", "roofline"])
def test_cli_writes_a_trailing_skip_record(module, tmp_path):
    """A run whose last cell is a skip writes that record too (the
    reference's loops wrote after each counted cell only), exits 0 and
    never initializes CUDA."""
    out = tmp_path / f"{module}.json"
    args = [sys.executable, "-m", f"repro_torch.launch.{module}", "--arch",
            "granite-34b", "--shape", "long_500k", "--out", str(out)]
    if module == "dryrun":
        args += ["--mesh", "single"]
    run = subprocess.run(args, capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT),
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "cuda_initialized=False" in run.stdout
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("granite-34b", "long_500k", "skip")]


_PERF_CHILD = """
import json
from repro_torch.launch import perf
from repro_torch.launch.mesh import make_fake_mesh
perf.MESH = make_fake_mesh((2, 2), ("data", "model"))
out = {mode: perf.measure_lm("granite-34b", "decode_32k", sharding_mode=mode)
       for mode in ("2d", "fsdp")}
out["kmeans"] = perf.measure_kmeans(sparse=True, fuse=True)
print(json.dumps(out))
"""


def test_perf_terms_only_where_the_counts_can_move():
    """A variant that changes only the sharding mode reports its own step
    terms: the step runs on the first device's DTensor shards, so the mode
    moves the argument bytes and the collectives. The kmeans-fraud cell's
    counted operations are int64 ring products, timed at the ring rate,
    not the bf16 one."""
    out = run_child(_PERF_CHILD, timeout=600)
    base, mode = out["2d"], out["fsdp"]
    for rec in (base, mode):
        assert rec["step_s"] > 0 and "not_modelled" not in rec
        assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert rec["collective_s"] == rec["link_dev"] / roofline.LINK_BW > 0
        assert rec["step_s"] == max(rec["compute_s"], rec["memory_s"],
                                    rec["collective_s"])
    assert mode["argument_bytes_dev"] != base["argument_bytes_dev"]
    assert mode["collective_s"] != base["collective_s"]
    km = out["kmeans"]
    assert km["compute_s"] == km["flops_dev"] / roofline.RING_OPS
    assert km["collective_s"] == km["link_dev"] / roofline.LINK_BW > 0
    assert roofline.RING_OPS == 2 * 132 * 64 * 1.98e9 / 3


_PROBE_CHILD = """
import dataclasses, json
from repro_torch.configs.base import ScanGroup, all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh((2, 2), ("data", "model"))
cfg = all_archs()["granite-34b"].reduced
cfg = dataclasses.replace(cfg, groups=tuple(ScanGroup(g.unit, 3)
                                            for g in cfg.groups))
out = {}
for shape in ("train_4k", "decode_32k"):
    probed = dryrun.lower_cell("granite-34b", shape, mesh, cfg=cfg)
    full = dryrun.cell_config("granite-34b", shape, mesh, cfg=cfg)
    step, args, shardings = dryrun.cell_program(
        "granite-34b", shape, mesh, full, global_batch=None,
        sharding_mode="2d", micro=dryrun.MICROBATCHES.get(
            ("granite-34b", shape), 1) if shape == "train_4k" else None)
    out[shape] = [probed, dryrun.analyze(dryrun.count_on_mesh(
        step, args, shardings, 4))]
print(json.dumps(out))
"""


def test_probes_extrapolate_to_the_full_count():
    """Every layer of a loop does the same work: the FLOPs and the peak the
    probes extrapolate (each loop at 1 and 2 repeats) equal those of the
    step run with all three layers. The bytes and collectives agree to a
    relative 1e-5: the backward of slicing a stacked (R, ...) parameter
    writes and reduces a whole (R, ...) gradient per layer, which grows as
    R^2, and a straight line through 1 and 2 repeats misses that (2e-7 of
    the train step's bytes, 5e-6 of its reduce-scatter here)."""
    out = run_child(_PROBE_CHILD, timeout=600)
    for shape, (probed, full) in out.items():
        assert probed["probes"]["group_repeats"] == [[1], [2]]
        assert "probes" not in full
        assert probed["flops_per_device"] == full["flops_per_device"]
        assert probed["memory"] == full["memory"], shape
        assert probed["bytes_per_device"] == pytest.approx(
            full["bytes_per_device"], rel=1e-5)
        assert probed["collectives"] == pytest.approx(full["collectives"],
                                                      rel=1e-5)
        assert probed["collectives"]["link_bytes"] > 0


_POD_PROBE_CHILD = """
import dataclasses, json
from repro_torch.configs.base import ScanGroup, all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
arch = %r
mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = all_archs()[arch].reduced
kw = {"groups": tuple(ScanGroup(g.unit, 3) for g in cfg.groups)}
if cfg.enc_dec:
    kw["n_enc_layers"] = 3
cfg = dataclasses.replace(cfg, **kw)
probed = dryrun.lower_cell(arch, "train_4k", mesh, cfg=cfg, global_batch=16)
pod = mesh["data", "model"]
full = dryrun.cell_config(arch, "train_4k", pod, cfg=cfg, global_batch=8)
step, args, shardings = dryrun.cell_program(
    arch, "train_4k", pod, full, micro=1, global_batch=8, sharding_mode="2d")
print(json.dumps([probed, dryrun.analyze(dryrun.count_on_mesh(
    step, args, shardings, 4))]))
"""


@pytest.mark.parametrize("arch_id", ["recurrentgemma-2b",
                                     "seamless-m4t-medium"])
def test_pod_mesh_probes_match_a_full_count(arch_id):
    """On a (pod=2, data=2, model=2) mesh a train cell is counted on the
    first pod's (2, 2) mesh at half the batch, by probes over every loop
    (the recurrent arch's layer group; the encoder-decoder's decoder group
    and encoder, each at 3 layers), plus one all-reduce over 'pod' of the
    gradient shards. Against the step run whole on the pod's mesh: the
    FLOPs are equal; the bytes and collectives agree to a relative 1e-5
    (the R^2 term of `test_probes_extrapolate_to_the_full_count`) once the
    pod's all-reduce is added; the peak, a high-water mark and not a sum,
    to 1e-3 (the encoder-decoder's probes miss 2 MiB of 2.3 GB)."""
    probed, full = run_child(_POD_PROBE_CHILD % arch_id, timeout=300)
    pod = probed["pod"]
    assert pod["pods"] == 2 and pod["counted_on"] == "2x2"
    assert pod["probe_global_batch_per_pod"] == 8
    grad = pod["grad_all_reduce_bytes"]
    assert grad > 0 and probed["count_basis"] == "per-device"
    assert probed["flops_per_device"] == full["flops_per_device"]
    assert probed["bytes_per_device"] == pytest.approx(
        full["bytes_per_device"] + 2 * grad, rel=1e-5)
    want = dict(full["collectives"])
    want["all-reduce"] += grad
    want["link_bytes"] += 2 * grad
    assert probed["collectives"] == pytest.approx(want, rel=1e-5)
    mem, fmem = probed["memory"], full["memory"]
    assert mem["argument_size_in_bytes"] == fmem["argument_size_in_bytes"]
    assert mem["peak_memory_in_bytes"] == pytest.approx(
        fmem["peak_memory_in_bytes"], rel=1e-3)


_POD_MESH_CHILD = """
import json
from repro_torch.configs.base import all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = all_archs()["recurrentgemma-2b"].reduced
probed = dryrun.lower_cell("recurrentgemma-2b", "train_4k", mesh, cfg=cfg,
                           global_batch=16)
full = dryrun.cell_config("recurrentgemma-2b", "train_4k", mesh, cfg=cfg,
                          global_batch=16)
step, args, shardings = dryrun.cell_program(
    "recurrentgemma-2b", "train_4k", mesh, full, micro=1, global_batch=16,
    sharding_mode="2d")
print(json.dumps([probed, dryrun.analyze(dryrun.count_on_mesh(
    step, args, shardings, 8))]))
"""


def test_pod_mesh_count_matches_the_three_axis_step():
    """The pod-as-data-parallel count against the step run on the whole
    (2, 2, 2) mesh: the same FLOPs, argument bytes, all-gathers,
    reduce-scatters and all-to-alls. DTensor on three axes all-reduces
    more over 'pod' (it reduces a partial sum one mesh axis at a time,
    and its sums over 'pod' come before the reduce-scatter over 'data'),
    so its all-reduce is at least the pod count's, which all-reduces the
    gradient shards once."""
    probed, full = run_child(_POD_MESH_CHILD, timeout=300)
    assert probed["pod"]["counted_on"] == "2x2"
    assert probed["flops_per_device"] == full["flops_per_device"]
    assert probed["memory"]["argument_size_in_bytes"] \
        == full["memory"]["argument_size_in_bytes"]
    for kind in ("all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert probed["collectives"][kind] == full["collectives"][kind], kind
    assert full["collectives"]["all-reduce"] \
        >= probed["collectives"]["all-reduce"] > 0


_TWO_POD_CHILD = """
import json
from repro_torch.configs.base import all_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
pods = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
one = make_fake_mesh((2, 2), ("data", "model"))
out = {}
for arch in %r:
    cfg = all_archs()[arch].reduced
    out[arch] = [dryrun.lower_cell(arch, "train_4k", m, cfg=cfg,
                                   global_batch=16) for m in (pods, one)]
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch_id", ["granite-34b", "recurrentgemma-2b"])
def test_two_pods_read_no_more_flops_a_device_than_one(arch_id):
    """The same train cell (global batch 16) on two pods of (2, 2) and on
    one: a device of two pods takes half a pod's share of the batch and,
    with every product split over 'model', does no more work than a
    device of one pod (before the tensor-parallel regions, DTensor
    gathered weights and repeated products where a device's sequences did
    not divide over 'model', and the two-pod records read more). Each
    record's `replication` (its FLOPs over the probes' global count a
    chip) is at most the tensor-parallel bound."""
    two, one = run_child(_TWO_POD_CHILD % ([arch_id],), timeout=300)[arch_id]
    assert two["pod"]["pods"] == 2 and "pod" not in one
    for rec in (two, one):
        assert rec["count_basis"] == "per-device"
        assert "collective_error" not in rec
        assert 0.8 < rec["replication"] <= dryrun.TP_RATIO_BOUND
    assert two["flops_per_device"] <= one["flops_per_device"]
    assert two["flops_per_device"] == pytest.approx(
        one["flops_per_device"] / 2, rel=0.05)
