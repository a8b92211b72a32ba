"""Blocked-ELL sparse x dense: for each row block, the sum over its first
`counts[r]` tiles of `tile @ Y[idx*bk:(idx+1)*bk]`, in one of three word
types: int64 words mod 2^64 (Protocol 2 step 2, core/sparse.py), int32
words mod 2^32, or float32 (both through the kernel API, `kernels/ops.py`).

Port of the Pallas TPU kernel `repro/kernels/spmm.py:spmm_ell` with all
three of its tile products (`_tile_matmul`). The CUDA kernel is
`csrc/spmm.cu`, one template on the word type; its header says what bounds
it and how its split of the tile list answers that. The reference keeps all
of Y in VMEM and its API asserts that Y fits a 12 MB budget
(`repro/kernels/ops.py:spmm`); that is a TPU limit and is not ported, since
this kernel stages Y one bk x k tile at a time. Beside it:

* `dense_to_ell` / `csr_to_ell` — the host packers, numpy copies of the
  reference's, so the tiles the kernel reads are word for word the ones
  the reference packs.
* `spmm_ell_plain` — the plain PyTorch version (the semantics of the
  reference's `XlaBackend.ring_spmm`). On the CPU integer `@` wraps mod
  2^l; on CUDA `torch.matmul` refuses integer words, so there it is a
  broadcast multiply-and-sum over chunks of bk. Float32 takes `@` on any
  device, in full FP32 on CUDA as long as
  `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
* `column_groups` — how the wrapper cuts a Y wider than `MAX_K` columns
  into groups: each group's columns are copied contiguous, launched once,
  and the group outputs concatenated.
* `spmm_ell` — the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises. `LAUNCHES` counts launches on int64
  words, `LAUNCHES_U32` on int32 words, `LAUNCHES_F32` on float32.

The f32 kernel splits long tile lists over blocks that meet by `atomicAdd`
in an order that changes from run to run, so its sums agree with the plain
version to rounding, not bit for bit; the ring words are exact. The
transposed Y views of the main path (`ct.s1.T`) are copied `.contiguous()`
by the wrapper.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `spmm_ell` on int64 words
LAUNCHES_U32 = 0        # ... on int32 words (mod 2^32)
LAUNCHES_F32 = 0        # ... on float32
WORD_CODES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}  # csrc/spmm.cu

MAX_K = 8               # widest Y column group one launch takes
SMEM_BYTES = 48 * 1024  # dynamic shared memory for one staged Y tile
TARGET_BLOCKS = 4 * 132  # enough blocks to fill an H100's 132 SMs
# (plan() never splits a list more than TARGET_BLOCKS ways, well inside
# CUDA's gridDim.y limit)
MIN_SLOTS_PER_SPLIT = 4


# ---------------------------------------------------------------------------
# layout conversion: dense / CSR -> blocked-ELL (host, numpy)
# ---------------------------------------------------------------------------

def dense_to_ell(x: np.ndarray, bm: int = 8, bk: int = 128):
    """Pack a dense matrix into blocked-ELL (numpy, host-side, offline)."""
    n, d = x.shape
    n_pad = (-n) % bm
    d_pad = (-d) % bk
    xp = np.pad(x, ((0, n_pad), (0, d_pad)))
    nrb, ncb = xp.shape[0] // bm, xp.shape[1] // bk
    tiles = xp.reshape(nrb, bm, ncb, bk).transpose(0, 2, 1, 3)  # (nrb,ncb,bm,bk)
    nonempty = (tiles != 0).any(axis=(2, 3))                    # (nrb, ncb)
    counts = nonempty.sum(1).astype(np.int32)
    maxb = max(1, int(counts.max()))
    blocks = np.zeros((nrb, maxb, bm, bk), x.dtype)
    idx = np.zeros((nrb, maxb), np.int32)
    for i in range(nrb):
        cols = np.flatnonzero(nonempty[i])
        blocks[i, :len(cols)] = tiles[i, cols]
        idx[i, :len(cols)] = cols
    return blocks, idx, counts


def csr_to_ell(indptr, indices, data, shape, bm: int = 8, bk: int = 128):
    """CSR -> blocked-ELL without densifying: memory stays proportional to
    the number of non-empty (bm x bk) tiles, never to n*d. Fully vectorized
    (one sort over nnz)."""
    n, d = shape
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    data = np.asarray(data)
    nrb = -(-n // bm)
    ncb = -(-d // bk)
    nnz = len(data)
    if nnz == 0:
        return (np.zeros((nrb, 1, bm, bk), data.dtype),
                np.zeros((nrb, 1), np.int32), np.zeros((nrb,), np.int32))
    rows = np.repeat(np.arange(n), np.diff(indptr))
    rb, cb = rows // bm, indices // bk
    tile_id = rb * ncb + cb
    uniq, inv = np.unique(tile_id, return_inverse=True)
    counts = np.bincount(uniq // ncb, minlength=nrb).astype(np.int32)
    maxb = max(1, int(counts.max()))
    # slot of each unique tile within its row block (uniq is sorted, so
    # tiles of one row block are contiguous)
    starts = np.zeros(nrb, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot_of_uniq = np.arange(len(uniq)) - starts[uniq // ncb]
    blocks = np.zeros((nrb, maxb, bm, bk), data.dtype)
    idx = np.zeros((nrb, maxb), np.int32)
    idx[uniq // ncb, slot_of_uniq] = (uniq % ncb).astype(np.int32)
    blocks[rb, slot_of_uniq[inv], rows % bm, indices % bk] = data
    return blocks, idx, counts


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------

def spmm_ell_plain(blocks: torch.Tensor, idx: torch.Tensor,
                   counts: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """blocks (nrb, maxb, bm, bk), idx (nrb, maxb), counts (nrb,), y
    (d_pad, k) -> (nrb*bm, k) in the word type of blocks and y (mod 2^64 on
    int64, mod 2^32 on int32, float32), in plain PyTorch on any device.
    Slots j >= counts[r] contribute nothing, whatever they hold."""
    nrb, maxb, bm, bk = blocks.shape
    k = y.shape[1]
    keep = (torch.arange(maxb, device=blocks.device)[None, :]
            < counts[:, None])                                   # (nrb, maxb)
    # padded slots may hold any index: point them at tile 0
    idx = torch.where(keep, idx.long(), 0)
    y_tiles = y.reshape(-1, bk, k)[idx]                          # (nrb,maxb,bk,k)
    if blocks.device.type == "cpu" or blocks.dtype.is_floating_point:
        contrib = blocks @ y_tiles                               # (nrb,maxb,bm,k)
    else:
        contrib = _broadcast_tile_matmul(blocks, y_tiles)
    contrib = torch.where(keep[..., None, None], contrib, 0)
    # the sum keeps the word type (an int32 sum would promote to int64)
    return contrib.sum(1, dtype=contrib.dtype).reshape(nrb * bm, k)


def _broadcast_tile_matmul(blocks: torch.Tensor,
                           y_tiles: torch.Tensor) -> torch.Tensor:
    """Batched tile products as sums of broadcast products over bk, for
    devices whose matmul refuses integer words."""
    nrb, maxb, bm, bk = blocks.shape
    k = y_tiles.shape[-1]
    out = torch.zeros((nrb, maxb, bm, k), dtype=blocks.dtype,
                      device=blocks.device)
    # bound the (nrb, maxb, bm, chunk, k) broadcast product to ~2^25 words
    chunk = max(1, (1 << 25) // max(1, nrb * maxb * bm * k))
    for lo in range(0, bk, chunk):
        hi = min(bk, lo + chunk)
        out += (blocks[..., lo:hi, None]
                * y_tiles[:, :, None, lo:hi, :]).sum(3, dtype=blocks.dtype)
    return out


def plan(nrb: int, maxb: int) -> tuple[int, int]:
    """(slots per split, number of splits) for an ELL product: the tile
    list of each row block is cut over gridDim.y so that about
    TARGET_BLOCKS blocks are in flight when there are few row blocks."""
    splits = max(1, min(-(-TARGET_BLOCKS // max(1, nrb)),
                        -(-maxb // MIN_SLOTS_PER_SPLIT)))
    per_split = -(-maxb // splits)
    splits = -(-maxb // per_split)
    return per_split, splits


def column_groups(k: int) -> list[tuple[int, int]]:
    """[lo, hi) column ranges of y, each at most MAX_K wide and of near-equal
    widths, that together cover its k columns: one launch each. Each
    group's product is the same function on fewer columns, exact mod 2^l."""
    groups = max(1, -(-k // MAX_K))
    bounds = [g * k // groups for g in range(groups + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def spmm_ell(blocks: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL sparse x dense -> (nrb*bm, k), in the word type of
    blocks and y: int64 (mod 2^64), int32 (mod 2^32) or float32. CPU
    tensors: plain version. CUDA tensors: the hand kernel, one launch per
    column group of y (`column_groups`), or an exception.

    The tiles of used slots must point into y (idx[r, j] < d_pad / bk for
    j < counts[r]), as `csr_to_ell` / `dense_to_ell` make them: the kernel
    reads them unchecked, since a check would need a device sync per call.
    Padded slots are never read and may hold anything."""
    if blocks.dim() != 4 or idx.dim() != 2 or counts.dim() != 1 \
            or y.dim() != 2:
        raise ValueError(
            f"spmm_ell needs blocks (nrb, maxb, bm, bk), idx (nrb, maxb), "
            f"counts (nrb,), y (d_pad, k); got {tuple(blocks.shape)}, "
            f"{tuple(idx.shape)}, {tuple(counts.shape)}, {tuple(y.shape)}")
    nrb, maxb, bm, bk = blocks.shape
    k = y.shape[1]
    if tuple(idx.shape) != (nrb, maxb) or tuple(counts.shape) != (nrb,):
        raise ValueError(f"idx {tuple(idx.shape)} / counts "
                         f"{tuple(counts.shape)} do not match blocks "
                         f"{tuple(blocks.shape)}")
    if y.shape[0] % bk:
        raise ValueError(f"y has {y.shape[0]} rows, not a multiple of the "
                         f"tile width bk={bk}")
    if blocks.dtype not in WORD_CODES or y.dtype != blocks.dtype:
        raise TypeError(
            f"spmm_ell takes blocks and y of one word type, int64 (mod "
            f"2^64), int32 (mod 2^32) or float32; got {blocks.dtype} and "
            f"{y.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) \
            or counts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx and counts must be integer, got {idx.dtype} "
                        f"and {counts.dtype}")
    devs = {t.device for t in (blocks, idx, counts, y)}
    if len(devs) != 1:
        raise ValueError(f"spmm_ell operands lie on {sorted(map(str, devs))}")
    if blocks.device.type == "cpu":
        return spmm_ell_plain(blocks, idx, counts, y)
    if blocks.device.type != "cuda":
        raise ValueError(f"spmm_ell runs on cpu or cuda, not {blocks.device}")
    groups = column_groups(k)
    widest = max(hi - lo for lo, hi in groups)
    if bk * widest * blocks.element_size() > SMEM_BYTES:
        raise ValueError(f"a staged Y tile of {bk}x{widest} words exceeds "
                         f"{SMEM_BYTES} bytes of shared memory")
    global LAUNCHES, LAUNCHES_U32, LAUNCHES_F32
    if nrb * bm * k == 0 or maxb == 0:
        return torch.zeros((nrb * bm, k), dtype=blocks.dtype,
                           device=blocks.device)
    per_split, splits = plan(nrb, maxb)
    alloc = torch.zeros if splits > 1 else torch.empty
    blocks = blocks.contiguous()
    idx = idx.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    fn = _build.launcher("spmm")
    outs = []
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        for lo, hi in groups:
            yg = y[:, lo:hi].contiguous()        # no copy for one group
            out = alloc((nrb * bm, hi - lo), dtype=blocks.dtype,
                        device=blocks.device)
            err = fn(blocks.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                     yg.data_ptr(), out.data_ptr(), nrb, maxb, bm, bk,
                     hi - lo, per_split, splits, WORD_CODES[blocks.dtype],
                     stream)
            _build.check(err, "spmm_ell")
            if blocks.dtype == torch.int64:
                LAUNCHES += 1
            elif blocks.dtype == torch.int32:
                LAUNCHES_U32 += 1
            else:
                LAUNCHES_F32 += 1
            outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)
