"""The port's replication ratio (`launch/dryrun.py:replication`) against
the JAX package's on the same (data=2, model=4) mesh, for granite-34b,
llama3-405b and recurrentgemma-2b's reduced train_4k at global batch 2
and one microbatch: the reference's `lower_cell` on 8 host devices under
`jax.set_mesh`, its `cost_analysis()` FLOPs times 8 over the same call's
on a (1, 1) mesh. XLA counts elementwise work too (the RG-LRU's scan), so
its ratio bounds the port's where it is above 1.10; the port reads at most
max(1.10, the reference's ratio), and `dryrun.REFERENCE_RATIOS` holds the
reference's recurrentgemma-2b reading. Each side in a child process."""
import pytest

from repro_torch.launch import dryrun

from _torch_plans import TP_CHILD, run_child

ARCHS = ["granite-34b", "llama3-405b", "recurrentgemma-2b"]

_REF_CHILD = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
jax.devices()
from jax.sharding import Mesh
from repro.configs.base import all_archs
from repro.launch import dryrun as D
devices = jax.devices()
meshes = {"2x4": Mesh(np.array(devices).reshape(2, 4), ("data", "model")),
          "1x1": Mesh(np.array(devices[:1]).reshape(1, 1),
                      ("data", "model"))}
out = {}
for arch in %r:
    flops = {}
    for name, mesh in meshes.items():
        with jax.set_mesh(mesh):
            flops[name] = D.lower_cell(
                arch, "train_4k", mesh, cfg=all_archs()[arch].reduced,
                global_batch=2, micro=1)["flops_per_device"]
    out[arch] = flops["2x4"] * 8 / flops["1x1"]
print(json.dumps(out))
""" % (ARCHS,)


@pytest.fixture(scope="module")
def reference():
    return run_child(_REF_CHILD, timeout=600)


@pytest.fixture(scope="module")
def port():
    return run_child(TP_CHILD % ("train_4k", ARCHS), timeout=300)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_port_repeats_no_more_than_the_reference(reference, port, arch_id):
    ref, rec = reference[arch_id], port[arch_id]
    assert 0.99 < ref < 1.4
    assert rec["count_basis"] == "per-device"
    assert rec["ratio"] <= max(dryrun.TP_RATIO_BOUND, ref)
    if (arch_id, "train_4k") in dryrun.REFERENCE_RATIOS:
        assert dryrun.REFERENCE_RATIOS[(arch_id, "train_4k")] \
            == pytest.approx(ref, abs=0.005)
    else:
        assert ref <= dryrun.TP_RATIO_BOUND
