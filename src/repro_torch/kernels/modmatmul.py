"""Ring matmul (n, d) @ (d, k) mod 2^64 on int64 words, or mod 2^32 on
int32 words.

Port of the Pallas TPU kernel `src/repro/kernels/modmatmul.py:71
modmatmul`, both bodies (`_kernel_u64` at `:56`, `_kernel_u32` at `:29`).
The CUDA kernels are in `csrc/modmatmul.cu`, templates on the word type;
its header says what bounds them and how each variant answers that. u32
words are int32 tensors, as u64 words are int64 ones: int32 `+ - * @` wrap
mod 2^32 on the CPU, and PyTorch has no `add` for uint32. Beside it:

* `ring_matmul_plain` — the plain PyTorch version. On the CPU integer `@`
  wraps mod 2^l; on CUDA `torch.matmul` refuses integer words, so there it
  is a broadcast multiply-and-sum over K chunks.
* `layout` — how the kernels read an operand in place: row-major, or the
  transposed view of a row-major matrix, with its leading dimension.
* `plan` — which variant a launch takes, and its K chunk and grid: the
  long-K kernel (few output rows, K cut over a few hundred blocks), the
  tall-skinny kernel (few output columns, B staged whole), their wide
  forms for the kmeans-fraud cell's (16, n) @ (n, 512) and (n, 512) @
  (512, 16), or the general tile.
* `prepare` — the plan of a product and the operands to hand it. The
  long-K kernels also read A, and the tall kernels B, as a transposed
  view; everything else is read row-major. The fit's and the cell's views
  (`mu.s0.T`, `mut.s1[da:]`, `c.s0.T`) all land where they are read in
  place; an operand that its variant cannot read is copied contiguous and
  counted in `COPIES`.
* `ring_matmul` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. `LAUNCHES` counts launches on
  int64 words, `LAUNCHES_U32` on int32 words. The output is allocated
  empty; a launch whose blocks meet by atomicAdd zeroes it in a small
  kernel of its own that the product overlaps, counted in `ZERO_LAUNCHES`.

The wide forms (`csrc/modmatmul.cu` longw_kernel, tallw_kernel): at the
cell's n = 524,288 each product moves 2.21 GB, 0.66 ms at 3.35 TB/s, and
does 4.29e9 64-bit multiply-adds, 0.77 ms at three 32-bit IMADs each, so
both are bound by operations with the bytes close behind. Each reads its
big operand once, in 16-byte cp.async copies, while the multiplies run,
three IMADs a product on split sums (the header says why that is ~1.03 ms
at best). Long-K wide gives a block all 16 rows of C and a 512-column
slab, 32 sums a thread (B read once; about eight blocks an SM meeting by
atomicAdd); tall wide stages B whole in one block an SM whose two halves
walk their own 256-row slabs of A, 128 bytes of each row a chunk.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = 0            # kernel launches by `ring_matmul` on int64 words
LAUNCHES_U32 = 0        # ... on int32 words (the mod-2^32 ring)
COPIES = 0              # operands copied because their kernel cannot read them
ZERO_LAUNCHES = 0       # zero kernels launched before split products
WORD_BITS = {torch.int64: 64, torch.int32: 32}
INT32_MAX = 2 ** 31 - 1

SMS = 132               # an H100's streaming multiprocessors
# tall-skinny (csrc/modmatmul.cu tall_kernel): 128 rows a block; B staged
# whole; K in one stage up to TALL_ONE_STAGE_K words, else TALL_KC a stage
TALL_ROWS = 128
TALL_MAX_N = 8
TALL_MAX_B_WORDS = 2048
TALL_ONE_STAGE_K = 32
TALL_KC = 16
# long-K (longk_kernel): up to 8 output rows and 256 columns; a stage of
# about LONG_STAGE_BYTES of A and B rows; at most LONG_MAX_BLOCKS blocks
LONG_MAX_M = 8
LONG_MAX_N = 256
LONG_STAGE_BYTES = 16 * 1024
LONG_MIN_KB = 8
LONG_MAX_BLOCKS = 3 * SMS
# long-K wide (longw_kernel): up to 16 output rows and, above LONG_MAX_N,
# up to LONGW_MAX_N columns; each block a LONGW_SLAB-column slab and every
# row; K in chunks of LONGW_KB rows over about LONGW_BLOCKS blocks in all
LONGW_MAX_M = 16
LONGW_MAX_N = 2048
LONGW_SLAB = 512
LONGW_KB = 8
LONGW_BLOCKS = 8 * SMS
# tall wide (tallw_kernel): up to 16 output columns with B of up to
# TALLW_MAX_K rows staged whole (with the ring, the shared memory a block
# can take); TALLW_ROWS rows of A a block at a time (two halves of 256), in
# chunks of TALLW_KC words, walked by at most one block an SM
TALLW_MAX_N = 16
TALLW_MAX_K = 640
TALLW_ROWS = 512
TALLW_KC = 16
# general tile (general_kernel)
BK = 16                 # K chunk staged in shared memory
TILES = ((128, 8), (8, 32))   # (BM, BN) of general tiles 0 and 1
TARGET_BLOCKS = 4 * SMS  # enough blocks to fill the card
MIN_K_PER_SPLIT = 4 * BK
# general tiles are 0 and 1
VARIANT_CODES = {"tall": 2, "longk": 3, "tallw": 4, "longw": 5}
TRANSPOSED_A = ("longk", "longw")   # variants that read A^T in place
TRANSPOSED_B = ("tall", "tallw")    # ... and B^T


class Plan(NamedTuple):
    """A launch of csrc/modmatmul.cu."""
    variant: str        # "tall", "longk", "tallw", "longw" or "general"
    tile: int           # general tile id (0 or 1); 0 otherwise
    chunk: int          # K words a stage, or a split (general)
    blocks: int         # longk, tallw: grid size; general, longw: K splits
                        # (of each tile or slab); tall: row slabs

    @property
    def zeroed(self) -> bool:
        """A longk, longw or general launch split along K meets by
        atomicAdd, so the launcher zeroes C first, in a launch of its own."""
        return self.variant not in TRANSPOSED_B and self.blocks > 1


def ring_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, k) mod 2^l in plain PyTorch, on any device: l = 64 on
    int64 words, 32 on int32 words. The meta device (shapes only, the dry
    run) takes the matmul too, so a cost count sees one product."""
    if a.device.type in ("cpu", "meta"):
        return a @ b
    return _broadcast_matmul(a, b)


def _broadcast_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over d of the broadcast products a[:, d, None] * b[None, d, :],
    for devices whose matmul refuses integer words. The sums keep the word
    type (an int32 `sum` would otherwise promote to int64)."""
    n, d = a.shape
    k = b.shape[1]
    out = torch.zeros((n, k), dtype=a.dtype, device=a.device)
    # bound the (n, chunk, k) broadcast product to ~2^25 words
    chunk = max(1, (1 << 25) // max(1, n * k))
    for lo in range(0, d, chunk):
        hi = min(d, lo + chunk)
        out += (a[:, lo:hi, None] * b[None, lo:hi, :]).sum(1, dtype=a.dtype)
    return out


def layout(t: torch.Tensor) -> tuple[bool, int] | None:
    """(transposed, leading dimension) under which the kernels read the
    2-D tensor t in place: row-major (t[i, j] at i * ld + j), or the
    transposed view of a row-major matrix (t[i, j] at j * ld + i), counted
    from t's first element (its storage offset included). None when t is
    neither, or its leading dimension does not fit 32 bits."""
    r, c = t.shape
    sr, sc = t.stride()
    if (c == 1 or sc == 1) and (r == 1 or sr >= c):
        ld = sr if r > 1 else c
        return (False, ld) if ld <= INT32_MAX else None
    if (r == 1 or sr == 1) and (c == 1 or sc >= r):
        ld = sc if c > 1 else r
        return (True, ld) if ld <= INT32_MAX else None
    return None


def _general_plan(m: int, kdim: int, n: int) -> Plan:
    """The general tile that wastes the fewest padded outputs, and K split
    so that about TARGET_BLOCKS blocks are in flight."""
    def padded(t):
        bm, bn = TILES[t]
        return -(-m // bm) * bm * (-(-n // bn) * bn)

    tile = min(range(len(TILES)), key=padded)
    bm, bn = TILES[tile]
    tiles = -(-m // bm) * -(-n // bn)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles),
                        -(-kdim // MIN_K_PER_SPLIT)))
    k_per_split = -(-kdim // splits)
    k_per_split = -(-k_per_split // BK) * BK
    splits = -(-kdim // k_per_split)
    return Plan("general", tile, k_per_split, splits)


def _longk_plan(m: int, kdim: int, n: int, word_bytes: int) -> Plan:
    """K cut into chunks of about LONG_STAGE_BYTES, spread evenly over at
    most LONG_MAX_BLOCKS blocks."""
    kb_max = max(LONG_MIN_KB, LONG_STAGE_BYTES // (word_bytes * (m + n)))
    chunks = -(-kdim // kb_max)
    blocks = min(LONG_MAX_BLOCKS, chunks)
    per_block = -(-chunks // blocks)
    kb = -(-kdim // (blocks * per_block))
    chunks = -(-kdim // kb)
    return Plan("longk", 0, kb, -(-chunks // per_block))


def _longw_plan(kdim: int, n: int) -> Plan:
    """K cut into chunks of LONGW_KB rows, dealt to about LONGW_BLOCKS
    blocks over all the column slabs."""
    slabs = -(-n // LONGW_SLAB)
    chunks = -(-kdim // LONGW_KB)
    return Plan("longw", 0, LONGW_KB,
                min(chunks, max(1, LONGW_BLOCKS // slabs)))


def plan(m: int, kdim: int, n: int, a_t: bool = False, b_t: bool = False,
         word_bytes: int = 8) -> Plan:
    """The launch of an (m, kdim) @ (kdim, n) product whose A and B come
    row-major or as transposed views (a_t, b_t): long-K while C has at most
    LONG_MAX_M rows and LONG_MAX_N columns and B is row-major; tall-skinny
    while B (at most TALL_MAX_B_WORDS words, TALL_MAX_N columns) fits a
    block and A is row-major; long-K wide while C has at most LONGW_MAX_M
    rows and more than LONG_MAX_N but at most LONGW_MAX_N columns and B is
    row-major; tall wide while C has at most TALLW_MAX_N columns, B at most
    TALLW_MAX_K rows and A is row-major; else the general tile, which reads
    both row-major."""
    if m <= LONG_MAX_M and n <= LONG_MAX_N and not b_t:
        return _longk_plan(m, kdim, n, word_bytes)
    if n <= TALL_MAX_N and kdim * n <= TALL_MAX_B_WORDS and not a_t:
        kc = kdim if kdim <= TALL_ONE_STAGE_K else TALL_KC
        return Plan("tall", 0, kc, -(-m // TALL_ROWS))
    if m <= LONGW_MAX_M and LONG_MAX_N < n <= LONGW_MAX_N and not b_t:
        return _longw_plan(kdim, n)
    if n <= TALLW_MAX_N and kdim <= TALLW_MAX_K and not a_t:
        return Plan("tallw", 0, TALLW_KC, min(SMS, -(-m // TALLW_ROWS)))
    return _general_plan(m, kdim, n)


def _operand(t: torch.Tensor, lay: tuple[bool, int] | None,
             transposed_ok: bool) -> tuple[torch.Tensor, bool, int]:
    """(tensor, transposed, leading dimension) to hand a kernel: t itself
    when its layout `lay` is one the kernel reads, else a counted
    contiguous copy."""
    global COPIES
    if lay is None or (lay[0] and not transposed_ok):
        COPIES += 1
        t = t.contiguous()
        lay = (False, max(1, t.shape[1]))
    return t, lay[0], lay[1]


def prepare(a: torch.Tensor, b: torch.Tensor):
    """(plan, (A, a_t, lda), (B, b_t, ldb)) of the product a @ b: the plan
    chosen for the operands' layouts, and each operand as its variant reads
    it (only the long-K variants read A, and only the tall ones B,
    transposed)."""
    la, lb = layout(a), layout(b)
    p = plan(a.shape[0], a.shape[1], b.shape[1], la is not None and la[0],
             lb is not None and lb[0], a.element_size())
    return (p, _operand(a, la, p.variant in TRANSPOSED_A),
            _operand(b, lb, p.variant in TRANSPOSED_B))


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, k) mod 2^64 on int64 words, mod 2^32 on int32 words.
    CPU tensors: plain version. CUDA tensors: the hand kernel, or an
    exception."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ring_matmul needs (n, d) @ (d, k), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in WORD_BITS or b.dtype != a.dtype:
        raise TypeError(f"ring_matmul takes int64 (mod 2^64) or int32 "
                        f"(mod 2^32) ring words, both of one type; got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return ring_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"ring_matmul runs on cpu or cuda, not {a.device}")
    global LAUNCHES, LAUNCHES_U32, ZERO_LAUNCHES
    m, kdim = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or kdim == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    p, (a, a_t, lda), (b, b_t, ldb) = prepare(a, b)
    if p.variant == "general" and -(-n // TILES[p.tile][1]) > 65535:
        raise ValueError(f"ring_matmul: {n} output columns exceed one launch")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    code = VARIANT_CODES.get(p.variant, p.tile)
    fn = _build.launcher("modmatmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), lda, int(a_t), b.data_ptr(), ldb, int(b_t),
                 out.data_ptr(), m, kdim, n, code, p.chunk, p.blocks,
                 WORD_BITS[a.dtype], stream)
    _build.check(err, "ring_matmul")
    ZERO_LAUNCHES += p.zeroed
    if a.dtype == torch.int64:
        LAUNCHES += 1
    else:
        LAUNCHES_U32 += 1
    return out
