"""Tensor-parallel regions over the mesh axis 'model' for a DTensor step
(Megatron's f and g operators, written with DTensor's local-tensor API).

In the 2D mode (`cfg.act_axes` without 'model') a block's math runs on
local shards: the activation enters replicated over 'model' and split by
batch over the act axes (`enter`); each weight is gathered over the act
axes (the FSDP all-gather) and kept as this rank's slice over 'model'
(`column`, `row`, `shard`) or gathered whole (`whole`); a row-parallel
product leaves a partial sum over 'model' that leaves the region reduced
(`exit_sum`). Every local tensor carries the placement its gradient takes
back into DTensor (`to_local(grad_placements=...)`): a rank-specific use
of a replicated value gives a partial sum over 'model', which DTensor
reduces; the parameters' gradients are partial over the act axes too,
reduced to their own layout.

The query-sequence split (`rows`, `gather_rows`, `exit_rows`) serves
attention whose heads do not divide the 'model' ways: each rank takes two
of 2 * ways blocks of the sequence, r and 2 * ways - 1 - r, so that causal
attention gives the ranks about the same work. With a local window it does
not: rows within a window of the sequence's start see fewer keys, and the
first rank's block 0 holds them. The dry run counts one device, the first,
and reads its 'model' coordinate as the last one (`as_last_rank`), whose
two blocks are the middle ones: at the lengths, windows and ways of the
package's cells its attention costs the most of any rank's
(tests/test_torch_tp_layout.py).

`region` returns `PLAIN` for a plain tensor, a DTensor of another mode, a
mesh without a 'model' axis of two or more devices, or sizes the ways do
not divide. `Plain`'s every method returns its input, so a block's one
body runs its plain ops word for word."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

MODEL = "model"
_LAST_RANK = [False]


@contextlib.contextmanager
def as_last_rank():
    """Regions made inside read this process's 'model' coordinate as the
    last (`launch/dryrun.py:count_on_mesh` counts the first device so)."""
    _LAST_RANK[0] = True
    try:
        yield
    finally:
        _LAST_RANK[0] = False


class Plain:
    """The region of a step without one: every method returns its input."""
    ways = batch_ways = 1
    rank = 0

    def local(self, t):
        return t

    def enter(self, x):
        return x

    def exit_sum(self, y):
        return y

    def exit_gather(self, y, dim):
        return y

    def gather(self, y, dim, *, partial_grad=True):
        return y

    def all_sum(self, y, *, partial_grad):
        return y

    def all_max(self, y):
        return y

    def scatter(self, y, dim):
        return y

    def exit_total(self, total):
        return total

    def column(self, w):
        return w

    def row(self, w):
        return w

    def shard(self, w, dim):
        return w

    def whole(self, w):
        return w

    def own(self, t, dim):
        return t


PLAIN = Plain()


@dataclasses.dataclass(frozen=True)
class Region(Plain):
    mesh: Any
    names: tuple          # the mesh's axis names
    act_axes: tuple       # the axes the batch is split over
    ways: int             # devices over 'model'
    rank: int             # this device's coordinate over 'model'
    batch_ways: int       # devices the batch is split over

    def placements(self, model, act) -> tuple:
        """One placement per mesh axis: `model` on 'model', `act` on the
        act axes, Replicate on any other."""
        from torch.distributed.tensor import Replicate
        return tuple(model if a == MODEL else act if a in self.act_axes
                     else Replicate() for a in self.names)

    # -- activations ------------------------------------------------------

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """A DTensor batch input (tokens, labels) as this rank's rows, with
        no gradient."""
        from torch.distributed.tensor import Replicate, Shard
        return t.redistribute(self.mesh, self.placements(
            Replicate(), Shard(0))).to_local()

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: the activation pinned to (Shard(0) over the act
        axes, Replicate over 'model') as this rank's local tensor, whose
        gradient is a partial sum over 'model'."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        return x.redistribute(self.mesh, self.placements(
            Replicate(), Shard(0))).to_local(
            grad_placements=self.placements(Partial(), Shard(0)))

    def exit_sum(self, y: torch.Tensor) -> torch.Tensor:
        """Megatron's g: a partial sum over 'model' (a row-parallel
        product), all-reduced, as the DTensor the block goes on with."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        return DTensor.from_local(
            y, self.mesh, self.placements(Partial(), Shard(0))).redistribute(
            self.mesh, self.placements(Replicate(), Shard(0)))

    def exit_gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of dim `dim`, all-gathered over 'model', as the
        DTensor the block goes on with (its gradient is sliced back)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        return DTensor.from_local(
            y, self.mesh, self.placements(Shard(dim), Shard(0))).redistribute(
            self.mesh, self.placements(Replicate(), Shard(0)))

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """A local tensor equal on every 'model' rank, as a DTensor."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        return DTensor.from_local(y, self.mesh, self.placements(
            Replicate(), Shard(0)))

    def gather(self, y: torch.Tensor, dim: int, *,
               partial_grad: bool = True) -> torch.Tensor:
        """The slices of dim `dim` of every 'model' rank, all-gathered, as
        a local tensor. Its gradient is a partial sum over 'model' (each
        rank uses the whole in its own way; reduce-scattered back) or, with
        partial_grad=False, the same on every rank (sliced back)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        g = Partial() if partial_grad else Replicate()
        return self.exit_gather(y, dim).to_local(
            grad_placements=self.placements(g, Shard(0)))

    def all_sum(self, y: torch.Tensor, *,
                partial_grad: bool) -> torch.Tensor:
        """A partial sum over 'model', all-reduced, as a local tensor; its
        gradient as `gather`'s."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        g = Partial() if partial_grad else Replicate()
        return self.exit_sum(y).to_local(
            grad_placements=self.placements(g, Shard(0)))

    def all_max(self, y: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over 'model' of a local tensor, with no
        gradient."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        return DTensor.from_local(
            y.detach(), self.mesh,
            self.placements(Partial("max"), Shard(0))).redistribute(
            self.mesh, self.placements(Replicate(), Shard(0))).to_local()

    def scatter(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """A partial sum over 'model', reduce-scattered: this rank's slice
        of dim `dim` of the sum."""
        from torch.distributed.tensor import DTensor, Partial, Shard
        return DTensor.from_local(
            y, self.mesh, self.placements(Partial(), Shard(0))).redistribute(
            self.mesh, self.placements(Shard(dim), Shard(0))).to_local(
            grad_placements=self.placements(Shard(dim), Shard(0)))

    def exit_total(self, total: torch.Tensor) -> torch.Tensor:
        """A scalar summed over this rank's rows (the same on every 'model'
        rank), all-reduced over the act axes, as a replicated DTensor."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        return DTensor.from_local(
            total, self.mesh, self.placements(Replicate(), Partial())
        ).redistribute(self.mesh, self.placements(Replicate(), Replicate()))

    # -- parameters -------------------------------------------------------

    def shard(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of dim `dim` of a parameter, gathered over the
        act axes; its gradient is a partial sum over them."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        dim %= w.ndim
        return w.redistribute(self.mesh, self.placements(
            Shard(dim), Replicate())).to_local(
            grad_placements=self.placements(Shard(dim), Partial()))

    def column(self, w: torch.Tensor) -> torch.Tensor:
        """A column-parallel weight (in, out): this rank's columns."""
        return self.shard(w, -1)

    def row(self, w: torch.Tensor) -> torch.Tensor:
        """A row-parallel weight (in, out): this rank's rows."""
        return self.shard(w, 0)

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter gathered whole; its gradient a partial sum over
        'model' and the act axes (each rank uses it in its own way)."""
        from torch.distributed.tensor import Partial, Replicate
        return w.redistribute(self.mesh, self.placements(
            Replicate(), Replicate())).to_local(
            grad_placements=self.placements(Partial(), Partial()))

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of dim `dim` of t, split evenly over
        'model'."""
        k = t.shape[dim] // self.ways
        return t.narrow(dim, self.rank * k, k)

    # -- the query-sequence split -----------------------------------------

    def blocks(self, t: int) -> tuple:
        """(block length, this rank's two block starts) of a sequence of t
        in 2 * ways blocks."""
        c = t // (2 * self.ways)
        return c, (self.rank * c, (2 * self.ways - 1 - self.rank) * c)

    def rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's two blocks of dim 1."""
        c, starts = self.blocks(y.shape[1])
        return torch.cat([y[:, s:s + c] for s in starts], 1)

    def _natural(self, y: torch.Tensor) -> torch.Tensor:
        """Dim 1 gathered in rank order (each rank's blocks r and
        2 * ways - 1 - r) back in sequence order."""
        b, t = y.shape[:2]
        c = t // (2 * self.ways)
        z = y.reshape(b, self.ways, 2, c, *y.shape[2:])
        return torch.cat([z[:, :, 0], z[:, :, 1].flip(1)], 1).reshape(
            y.shape)

    def gather_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's blocks of dim 1, gathered in sequence order, as a
        local tensor each rank uses in its own way."""
        return self._natural(self.gather(y, 1))

    def exit_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's blocks of dim 1, gathered in sequence order, as the
        DTensor the block goes on with."""
        return self.exit(self._natural(self.gather(y, 1,
                                                   partial_grad=False)))

    def splits_rows(self, t: int) -> bool:
        return t % (2 * self.ways) == 0


def region(x, cfg, *sizes: int) -> Plain:
    """The tensor-parallel region of a DTensor step in the 2D mode: x a
    DTensor on a mesh with a 'model' axis of two or more devices that
    divide every one of `sizes`, and `cfg.act_axes` naming the batch's axes
    without 'model'. `PLAIN` for anything else (plain tensors, the
    pure-FSDP mode, decode's replicated activations)."""
    if type(x) is torch.Tensor or not cfg.act_axes \
            or MODEL in cfg.act_axes:
        return PLAIN
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return PLAIN
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if MODEL not in names or not set(cfg.act_axes) <= set(names):
        return PLAIN
    ways = int(mesh.size(names.index(MODEL)))
    if ways < 2 or any(n % ways for n in sizes):
        return PLAIN
    batch_ways = 1
    for a in cfg.act_axes:
        batch_ways *= int(mesh.size(names.index(a)))
    rank = ways - 1 if _LAST_RANK[0] else int(mesh.get_local_rank(MODEL))
    return Region(mesh, names, tuple(cfg.act_axes), ways, rank, batch_ways)
