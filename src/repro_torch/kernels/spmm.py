"""Blocked-ELL sparse x dense: for each row block, the sum over its first
`counts[r]` tiles of `tile @ Y[idx*bk:(idx+1)*bk]`, in one of three word
types: int64 words mod 2^64 (Protocol 2 step 2, core/sparse.py), int32
words mod 2^32, or float32 (both through the kernel API, `kernels/ops.py`).

Port of the Pallas TPU kernel `repro/kernels/spmm.py:spmm_ell` with all
three of its tile products (`_tile_matmul`). The CUDA kernels are in
`csrc/spmm.cu`, templates on the word type; its header says what bounds
each shape on an H100 and what the design does about it. The reference
keeps all of Y in VMEM and its API asserts that Y fits a 12 MB budget
(`repro/kernels/ops.py:spmm`); that is a TPU limit and is not ported, since
these kernels stage Y one tile at a time. Beside them:

* `dense_to_ell` / `csr_to_ell` — the host packers, numpy copies of the
  reference's, so the tiles the kernel reads are word for word the ones
  the reference packs.
* `spmm_ell_plain` — the plain PyTorch version (the semantics of the
  reference's `XlaBackend.ring_spmm`). On the CPU integer `@` wraps mod
  2^l; on CUDA `torch.matmul` refuses integer words, so there it is a
  broadcast multiply-and-sum over chunks of bk. Float32 takes `@` on any
  device, in full FP32 on CUDA as long as
  `torch.backends.cuda.matmul.allow_tf32` is False (PyTorch's default).
* `plan` — the one launch of a product, for any width of Y: which kernel
  (narrow, k <= 16: each lane sums all k columns over its words of a tile
  row, bound by the bytes of the tiles; wide, k > 16: column tiles of 32 V
  words over the grid, lanes over Y's columns, the zero words of the tiles
  skipped, bound by the bytes of Y), its column tile, the row blocks a
  block takes or the split of long tile lists, and its shared memory. A
  tile too wide for shared memory is staged in pieces of `bkp` columns; a
  wide warp takes 2 or 4 tile rows when bm > 8. Both run on one instance
  of each kernel (16 sums a lane narrow, one column a lane wide). What no
  plan can stage (wide tiles of more than 32 rows, or too tall for one
  piece of 32 columns) is refused with a ValueError before any launch.
  `Plan.work` is the block-to-work map the kernels compute, so the CPU
  tests can check that it covers every slot and column once.
* `spmm_ell` — the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises. Every call on the card is one
  launch, counted by word type: `LAUNCHES` (int64), `LAUNCHES_U32` (int32),
  `LAUNCHES_F32` (float32). A split launch zeroes its output in a small
  kernel of its own first, counted in `ZERO_LAUNCHES`. Y is read in place,
  row-major with its leading dimension or (narrow kernel) as the
  transposed view of a row-major matrix; a Y that neither kernel can read
  in place is copied contiguous once for the call, counted in `COPIES`.

Split tile lists meet by `atomicAdd` in an order that changes from run to
run, so f32 sums agree with the plain version to rounding, not bit for
bit; the ring words are exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import modmatmul

LAUNCHES = 0            # kernel launches by `spmm_ell` on int64 words
LAUNCHES_U32 = 0        # ... on int32 words (mod 2^32)
LAUNCHES_F32 = 0        # ... on float32
ZERO_LAUNCHES = 0       # zero kernels launched before split products
COPIES = 0              # Y operands copied because no kernel reads them
WORD_CODES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}  # csrc/spmm.cu

# An H100 (csrc/spmm.cu, 256 threads a block): 132 SMs, 227 KB of shared
# memory a block, 228 KB an SM (1 KB of it reserved per resident block).
SMS = 132
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
NARROW_WIDTHS = (3, 4, 8, 10, 12, 16)   # K instances: sums a lane keeps
WIDE_WIDTHS = (1, 2, 4, 8)          # V instances: Y columns a lane owns
# narrow kernel: a block per few row blocks, or a row block's list split
# over blocks so that about TARGET_BLOCKS are in flight, at least
# MIN_SLOTS_PER_SPLIT slots a block
TARGET_BLOCKS = 4 * SMS
MIN_SLOTS_PER_SPLIT = 4
# wide kernel: a ring of X_STAGES X tiles and Y_STAGES Y tiles; a warp per
# tile row, or 2 or 4 rows (tiles of at most WARPS * MAX_ROWS_PER_WARP
# rows); the group's counts and idx copied to shared memory, at most
# IDX_CAP ints
X_STAGES = 4
Y_STAGES = 3
WARPS = 8
MAX_ROWS_PER_WARP = 4
IDX_CAP = 4096
PIECE_ALIGN = 32        # a piece of a tile holds a multiple of 32 columns


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




# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """One launch of csrc/spmm.cu for a product of nrb row blocks of maxb
    slots of bm x bk tiles with a Y of k columns."""
    wide: bool          # the wide kernel (k > 16), else the narrow one
    width: int          # narrow: sums a lane keeps (K); wide: columns a lane
    col_tile: int       # columns of Y a block covers
    col_tiles: int      # column tiles, over the grid
    rows_per_block: int  # row blocks a block takes
    splits: int         # blocks sharing one row block's tile list
    per_split: int      # slots of the list a block takes
    x_words: int        # words of a staged X tile (wide)
    y_words: int        # words of a staged Y tile
    y_stride: int       # words between the staged Y rows (row-major Y)
    meta_off: int       # bytes of the staged tiles before the wide block's
                        # copy of counts and idx
    smem: int           # dynamic shared memory, bytes
    blocks: int         # grid size
    bkp: int            # tile columns (Y rows) staged at once: bk, or a
                        # piece of it when a whole tile does not fit
    pieces: int         # pieces a tile is staged in, ceil(bk / bkp)
    rpw_shift: int      # wide: log2 of the tile rows a warp takes

    @property
    def zeroed(self) -> bool:
        """A split launch meets by atomicAdd, so a zero kernel runs first."""
        return self.splits > 1

    def work(self, b: int, nrb: int, maxb: int,
             k: int) -> tuple[int, int, int, int, int, int]:
        """What block b computes, as csrc/spmm.cu's `Ring` decodes it: row
        blocks [ra, rb), of each the slots [j0, min(counts[r], jcap)), and
        the columns [col0, col0 + cols) of Y. Row blocks are innermost, so
        neighbouring blocks read the same Y tiles."""
        units = -(-nrb // self.rows_per_block)
        ru, rest = b % units, b // units
        ct, s = rest % self.col_tiles, rest // self.col_tiles
        ra = ru * self.rows_per_block
        j0 = s * self.per_split
        col0 = ct * self.col_tile
        return (ra, min(nrb, ra + self.rows_per_block), j0,
                min(maxb, j0 + self.per_split), col0,
                min(self.col_tile, k - col0))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wide_group(width: int, word: int) -> int:
    """Row blocks a wide block takes at once (csrc/spmm.cu wide_group): its
    sums, group x width words a lane, stay within 64 registers."""
    return min(16, 256 // (width * word))


def _narrow_piece(bk: int, row_words: int, fixed: int, word: int) -> int:
    """Tile columns the narrow kernel stages at once: all bk when their
    Y rows (row_words words each, plus `fixed` bytes) fit in a block's
    shared memory, else the most that fit, a multiple of PIECE_ALIGN."""
    if word * row_words * bk + fixed <= SMEM_PER_BLOCK:
        return bk
    return (SMEM_PER_BLOCK - fixed) // (word * row_words) \
        // PIECE_ALIGN * PIECE_ALIGN


def plan(nrb: int, maxb: int, bm: int, bk: int, k: int, word: int,
         y_t: bool = False) -> Plan:
    """The launch of one spmm_ell (word: bytes of a word; y_t: Y is the
    transposed view of a row-major matrix, read in place by the narrow
    kernel). A tile whose staged rows do not fit in shared memory is staged
    in pieces of `bkp` columns. Raises ValueError, before any launch, for
    tiles no plan can stage: with Y wider than 16 columns, tiles of more
    than WARPS * MAX_ROWS_PER_WARP rows, or so tall that a piece of
    PIECE_ALIGN columns does not fit."""
    vec = 16 // word                          # words in 16 bytes
    if k <= NARROW_WIDTHS[-1]:
        width = next(w for w in NARROW_WIDTHS if w >= k)
        splits = max(1, min(-(-TARGET_BLOCKS // max(1, nrb)),
                            -(-maxb // MIN_SLOTS_PER_SPLIT)))
        per_split = -(-maxb // splits)
        splits = -(-maxb // per_split)
        # many row blocks: a block walks a few, about 2 * TARGET_BLOCKS
        rows_per_block = max(1, nrb // (2 * TARGET_BLOCKS)) \
            if splits == 1 else 1
        # a tile staged in pieces takes the one instance that keeps 16 sums
        widest = NARROW_WIDTHS[-1]
        fixed = 4 * rows_per_block + 16 + word * (vec + widest)
        if y_t:       # Y^T's rows, bkp words each
            bkp = _narrow_piece(bk, width, fixed, word)
            if bkp < bk:
                width = widest
                bkp = _narrow_piece(bk, width, fixed, word)
            y_stride, y_words = bkp, _round_up(width * bkp, vec)
        else:         # bkp rows at an odd stride: no bank conflicts
            y_stride = k | 1
            bkp = _narrow_piece(bk, y_stride, fixed, word)
            if bkp < bk:
                width = widest
            y_words = _round_up(bkp * y_stride + width, vec)
        meta_off = _round_up(word * y_words, 16)
        smem = meta_off + 4 * rows_per_block
        return Plan(False, width, k, 1, rows_per_block, splits, per_split, 0,
                    y_words, y_stride, meta_off, smem,
                    -(-nrb // rows_per_block) * splits, bkp, -(-bk // bkp), 0)
    rpw = next((r for r in (1, 2, 4) if r <= MAX_ROWS_PER_WARP
                and bm <= WARPS * r), None)
    if not 1 <= bm or rpw is None:
        raise ValueError(f"spmm_ell on the card takes y wider than "
                         f"{NARROW_WIDTHS[-1]} columns with tiles of 1 to "
                         f"{WARPS * MAX_ROWS_PER_WARP} rows, not {bm}")
    budget = SMEM_PER_BLOCK - 4 * IDX_CAP - 16
    x_words = _round_up(bm * bk, vec)
    room = budget - word * X_STAGES * x_words
    bkp = bk
    if room < word * Y_STAGES * bk * 32:
        # not even 32 columns of whole tiles fit: stage them in pieces
        bkp = budget // (word * (Y_STAGES * 32 + X_STAGES * bm + vec)) \
            // PIECE_ALIGN * PIECE_ALIGN
        if bkp < PIECE_ALIGN:
            raise ValueError(
                f"spmm_ell on the card cannot stage {bm}x{bk} tiles of "
                f"{word}-byte words with y wider than {NARROW_WIDTHS[-1]} "
                f"columns: a piece of {PIECE_ALIGN} columns needs more "
                f"than {SMEM_PER_BLOCK} bytes of shared memory")
        x_words = _round_up(bm * bkp, vec)
        room = budget - word * X_STAGES * x_words
    width = next((v for v in WIDE_WIDTHS if 32 * v >= k), WIDE_WIDTHS[-1])
    if bkp < bk or rpw > 1:       # the one instance that takes these: V = 1
        width = 1
    while width > 1 and word * Y_STAGES * bkp * 32 * width > room:
        width //= 2
    col_tile = y_stride = 32 * width
    y_words = bkp * col_tile
    ring = word * (Y_STAGES * y_words + X_STAGES * x_words)
    col_tiles = -(-k // col_tile)
    resident = SMS * max(1, SMEM_PER_SM // (ring + 4 * IDX_CAP + 1024))
    rpw_shift = rpw.bit_length() - 1
    rows_per_block = min(nrb, wide_group(width, word) >> rpw_shift)
    base = -(-nrb // rows_per_block) * col_tiles
    splits = 1
    if base < resident // 2 and maxb > MIN_SLOTS_PER_SPLIT:
        splits = min(max(1, resident // base),
                     -(-maxb // MIN_SLOTS_PER_SPLIT))
    # the group's copy of counts and idx: rows_per_block * (1 + per) ints
    splits = max(splits, -(-maxb // (IDX_CAP // rows_per_block - 1)))
    per_split = -(-maxb // splits)
    splits = -(-maxb // per_split)
    meta_off = _round_up(ring, 16)
    smem = meta_off + 4 * rows_per_block * (1 + per_split)
    return Plan(True, width, col_tile, col_tiles, rows_per_block, splits,
                per_split, x_words, y_words, y_stride, meta_off, smem,
                base * splits, bkp, -(-bk // bkp), rpw_shift)


def _piece_bytes(ptr: int, *sizes: int) -> int:
    """The widest cp.async piece (16, 8 or 4 bytes) that divides the base
    address and every byte offset of the copies."""
    return next(g for g in (16, 8, 4)
                if ptr % g == 0 and all(s % g == 0 for s in sizes))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def spmm_ell(blocks: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL sparse x dense -> (nrb*bm, k), in the word type of
    blocks and y: int64 (mod 2^64), int32 (mod 2^32) or float32. CPU
    tensors: plain version. CUDA tensors: the hand kernel, one launch for
    any width of y (`plan`), or an exception.

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
    global LAUNCHES, LAUNCHES_U32, LAUNCHES_F32, ZERO_LAUNCHES, COPIES
    if nrb * bm * k == 0 or maxb == 0:
        return torch.zeros((nrb * bm, k), dtype=blocks.dtype,
                           device=blocks.device)
    word = blocks.element_size()
    lay = modmatmul.layout(y)
    p = plan(nrb, maxb, bm, bk, k, word, lay is not None and lay[0])
    if lay is None or (lay[0] and p.wide):
        y = y.contiguous()
        lay = (False, max(1, k))
        COPIES += 1
    y_t, ldy = lay
    blocks = blocks.contiguous()
    idx = idx.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    out = torch.empty((nrb * bm, k), dtype=blocks.dtype, device=blocks.device)
    if y_t:
        yg = _piece_bytes(y.data_ptr(), ldy * word, bk * word, p.bkp * word)
    elif not p.wide and ldy == k == p.y_stride:    # the piece is one run
        yg = _piece_bytes(y.data_ptr(), bk * k * word, p.bkp * k * word)
    else:
        yg = _piece_bytes(y.data_ptr(), ldy * word, k * word,
                          p.col_tile * word, p.y_stride * word)
    # X: whole tiles, or bm rows of a piece at the tile's row stride
    xg = _piece_bytes(blocks.data_ptr(), bm * bk * word, bk * word,
                      p.bkp * word)
    fn = _build.launcher("spmm")
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = fn(blocks.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                 y.data_ptr(), out.data_ptr(), nrb, maxb, bm, bk, k, ldy,
                 int(y_t), int(p.wide), p.width, p.col_tile, p.col_tiles,
                 p.rows_per_block, p.per_split, p.splits, p.x_words,
                 p.y_words, p.y_stride, yg, xg, p.meta_off, p.blocks, p.smem,
                 p.bkp, p.rpw_shift, WORD_CODES[blocks.dtype], stream)
    _build.check(err, "spmm_ell")
    if p.zeroed:
        ZERO_LAUNCHES += 1
    if blocks.dtype == torch.int64:
        LAUNCHES += 1
    elif blocks.dtype == torch.int32:
        LAUNCHES_U32 += 1
    else:
        LAUNCHES_F32 += 1
    return out
