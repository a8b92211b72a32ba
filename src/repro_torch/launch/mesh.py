"""Production mesh constructors (functions, not module constants:
importing this module starts no process group).

The production meshes are `DeviceMesh`es over torch's `fake` process group:
one process stands in for every rank (it is rank 0), and a collective
returns without moving data. That is what a dry run needs — the sharded
local shapes and the counts of the step — and it needs no device at all.
The fake group is this process's default group, so it and a real group
never share a process: the dry run and roofline are their own processes.

A fake mesh's device type is "cuda", the card's: DTensor then issues a
Shard->Shard redistribution as its all-to-all, as on the card (on a "cpu"
mesh it would all-gather and keep a chunk, since gloo has no all-to-all).
DeviceMesh sets up no device on the fake backend, so no CUDA context is
made and none is needed: the tensors live on the meta device.
"""
from __future__ import annotations

# the fake group covers the larger production mesh; the single-pod mesh
# takes its first 256 ranks
FAKE_WORLD = 512


def ensure_fake_group(world_size: int = FAKE_WORLD) -> None:
    """Start the fake default process group (rank 0 of `world_size`) unless
    it runs already. Refuses when a real group is this process's default."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group runs in this "
                "process; the fake production mesh needs a process of its own")
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"the fake group has {dist.get_world_size()} ranks, "
                f"{world_size} are needed")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_fake_mesh(shape: tuple, names: tuple, world_size: int | None = None):
    """A mesh of `shape` with axes `names` over the fake group (started
    with `world_size` ranks, default the mesh's size, unless one runs)."""
    from torch.distributed.device_mesh import init_device_mesh
    size = 1
    for s in shape:
        size *= s
    ensure_fake_group(world_size or size)
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 chips as (data=16, model=16). Multi-pod: 2 pods =
    512 chips as (pod=2, data=16, model=16); 'pod' is the DCN-crossing pure-DP
    axis (gradient all-reduce only, optionally int8-compressed). On the fake
    group (`make_fake_mesh`); its tensors live on the meta device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes, FAKE_WORLD)


def make_dev_mesh(device: str = "cuda"):
    """1-device mesh with the production axis names, over a world-size-1
    group on `device` (nccl on a GPU, gloo on the CPU). Starts that group
    at a free localhost port unless one runs already."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    elif dist.get_backend() == "fake":
        raise RuntimeError("the fake production group runs in this process; "
                           "the device mesh needs a process of its own")
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
