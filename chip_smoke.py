"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit. It builds the hand-written kernels from `src/repro_torch/kernels/
csrc` (into the ignored `build/torch_kernels/`), then:

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the build time;
  2. holds each kernel against its plain PyTorch version on the card, with
     exact integer equality, at the main path's full-size shapes and at odd
     and wrap-heavy ones, and times ks_carry_share and spmm_ell there;
     ring_matmul is timed at the operand layouts the dense and sparse fits
     really pass (transposed and sliced views, read in place, and the
     contiguous ones), the wrapper's work included;
  3. runs the secure fit on the GPU (backend="cuda") and on the CPU
     (backend="torch") at a small size, both partitions, and requires the
     same share words, dealer counters and per-tag traffic;
  4. runs the main path — SecureKMeans.fit, vertical, d_a=18, d_b=24, k=5,
     10 iterations at n=100,000 (the paper's fraud-detection deployment
     shape) — with the launch counters set to 0 just before and read just
     after, and requires agreement >= 0.98 with plaintext K-means and no
     ring_matmul operand copy (`modmatmul.COPIES`); it prints the device
     launches ring_matmul made (products and zero kernels);
  4b. runs the sparse main path the same way — SecureKMeans.fit with
     sparse=True (Protocol 2), vertical, d_a=d_b=128, k=3, 90 % zeros,
     5 iterations at n=100,000 — requires agreement >= 0.98 and all three
     kernels launched, and times `spmm_ell` on that fit's own ELL inputs;
  5. drives the kernel API (`repro_torch.kernels.ops`) the same way, with
     the launch counters set to 0 just before and read just after:
     plaintext Lloyd iterations (esd -> argmin_onehot -> C^T x through
     spmm_from_dense) at n=100,000 and the widths of phases 4 and 4b and of
     benchmarks/kernel_bench.py, held to the repository's plaintext_kmeans;
     mod-2^32 ring products; f32 and u32 spmm on phase 4b's own ELL, and
     u64 spmm at k=10. Then it holds each of the API's kernels against its
     plain version at those shapes (ring words exactly, float32 within
     rtol 1e-5, atol 1e-3) and times kernel, plain version and the one
     PyTorch call for the same function where there is one; spmm_ell also
     at the drive's own C^T x (the one-hot of an iteration's argmin_onehot,
     packed as spmm_from_dense packs it, times x at each width);
  6. prints one JSON line of per-kernel launches, times and bounds, the
     nvidia-smi line, and finally {"ok": true, "device": {...}}.

Phases 2 and 3 cover the sparse slice too: `spmm_ell` against its plain
version at both main-path shapes and at odd ones, and the sparse GPU fit
against the sparse CPU fit at k=3 and at k=10. Every spmm_ell call is one
launch for any width of y (`spmm.plan`).

Every float32 plain version runs with torch.backends.cuda.matmul.
allow_tf32 = False (set here), so it is full FP32 like the kernels.

Any failure exits non-zero before the final line. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernel-times [--src DIR]

times only ring_matmul at the fits' own operand layouts, esd beside
addmm + norms, and spmm_ell at every shape of the sparse fit and the
kernel API (phase 4b's four products, f32 / u32 / u64 k=10 S1 and S3, and
the Lloyd drive's C^T x at its three widths), each held to its plain
version first, for the repro_torch package under DIR (default: this
checkout's src/), and prints one JSON line.
Run on two trees in one call, in turns (A, B, B, A), it compares their
kernels on one card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

N = 100_000          # samples of the full-width fit (paper Tables 1-2 max n)
DA, DB, K = 18, 24, 5
ITERS = 10
SEED = 0

# H100 SXM published rates (NVIDIA data sheet / Hopper white paper): HBM3 at
# 3.35 TB/s; 132 SMs at 1.98 GHz boost with 64 32-bit integer multiply-adds
# per SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0). A 64-bit multiply-add mod 2^64 takes
# 3 of them (IMAD.WIDE.U32 plus two cross-term IMADs), and a 64-bit bitwise
# op takes 2 32-bit logic ops at the same issue rate.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT64_MAC_PER_S = INT32_OPS_PER_S / 3
# FP32 outside the tensor cores (NVIDIA's H100 SXM data sheet); an FMA is
# 2 operations of it
FP32_OPS_PER_S = 67e12
# TF32 on the tensor cores (the same data sheet, dense). esd's wide kernel
# (k > esd.SMALL_K) keeps FP32 accuracy with 3xTF32: three TF32 products
# per multiply-add, so it can reach a third of this rate
TF32_OPS_PER_S = 495e12
# multiply-adds per second of each word type of the kernel API
MAC_PER_S = {torch.float32: FP32_OPS_PER_S / 2,
             torch.int32: INT32_OPS_PER_S,
             torch.int64: INT64_MAC_PER_S}
# spmm_ell: the widest Y whose product multiplies every tile word (the
# narrow kernel, spmm.NARROW_WIDTHS); a wider Y goes to the wide kernel,
# which skips the zero words of the tiles, so its bound counts non-zeros
ELL_DENSE_MAX_K = 16

# Launches of each kernel shape per vertical Lloyd iteration at k=5, read
# from core/kmeans.py and core/protocol.py: S1 has 2 Beaver smatmuls
# (4 ring_mm each) + 2 local products; S3 the same over C^T X; S2's
# tournament compares (n,2), (n,1), (n,1) and S3's empty-cluster guard
# (k,), two ks_carry_share launches (one per party) per compare.
MM_PER_ITER = [((N, DA, K), 5), ((N, DB, K), 5), ((K, N, DA), 5),
               ((K, N, DB), 5)]                      # ((m, kdim, n), count)
# The same 20 products with the operand layouts the fit hands ring_matmul
# (core/kmeans.py _x_mut / _share_times_pub, core/protocol.py smatmul):
# ((m, kdim, n), A layout, B layout, count). "row" is row-major and
# contiguous; "t" the transposed view of a row-major matrix (c.s0.T as A,
# the Beaver f and v + f built from mu.s0.T as B); ("mu", lo) rows lo: of
# the transposed (k, d_a + d_b) centroid share (mut.s0[:da], mut.s1[da:]).
MM_FIT_PER_ITER = [
    ((N, DA, K), "row", "t", 2), ((N, DA, K), "row", ("mu", 0), 1),
    ((N, DA, K), "row", "row", 2),
    ((N, DB, K), "row", "t", 2), ((N, DB, K), "row", ("mu", DA), 1),
    ((N, DB, K), "row", "row", 2),
    ((K, N, DA), "t", "row", 3), ((K, N, DA), "row", "row", 2),
    ((K, N, DB), "t", "row", 3), ((K, N, DB), "row", "row", 2)]
KS_PER_ITER = [((N, 2), 2), ((N, 1), 4), ((K,), 2)]  # (shape, count)

# The sparse main path (phase 4b): examples/sparse_vertical.py's widths,
# k, sparsity and iterations at the n of benchmarks/fig4_sparse.py:run_a.
SP_N, SP_DA, SP_DB, SP_K, SP_ITERS, SP_SEED = 100_000, 128, 128, 3, 5, 2
SP_SPARSITY = 0.9
# Per vertical sparse iteration, read from core/kmeans.py: Protocol 2 runs
# 2 spmm_ell in S1 (X_A @ mu-share, X_B @ mu-share: nrb = n/8 row blocks
# of one 8x128 tile) and 2 in S3 (X_A^T @ C-share, X_B^T @ C-share through
# the transpose identity: nrb = 16 row blocks of ceil(n/128) tiles);
# ring_matmul runs the 4 local products; ks_carry_share the (n,1), (n,1)
# tournament compares and the (k,) guard, once per party.
SP_ELL_S1 = (-(-SP_N // 8), 1, 8, 128)
SP_ELL_S3 = (SP_DA // 8, -(-SP_N // 128), 8, 128)
SP_PER_ITER = {"spmm_ell": 4, "ring_matmul": 4, "ks_carry_share": 6}
# its 4 local ring products, with the fit's layouts (as MM_FIT_PER_ITER)
SP_MM_FIT_PER_ITER = [
    ((SP_N, SP_DA, SP_K), "row", ("mu", 0), 1),
    ((SP_N, SP_DB, SP_K), "row", ("mu", SP_DA), 1),
    ((SP_K, SP_N, SP_DA), "t", "row", 1), ((SP_K, SP_N, SP_DB), "t", "row", 1)]
SP_WIDE_K = 10      # phase 3: a sparse fit with y wider than 8 columns

# The kernel API (phase 5) at n = 100,000: esd and argmin_onehot at the
# (d, k) of the fraud deployment (phase 4), of the sparse fit (phase 4b) and
# of benchmarks/kernel_bench.py's esd row; the mod-2^32 ring product at the
# dense fit's tall-skinny and long-K shapes and kernel_bench's square one;
# spmm on phase 4b's ELL of X_A (S1) and X_A^T (S3), and u64 at k = 10.
API_N = 100_000
API_ESD = [(42, 5), (256, 3), (512, 128)]                  # (d, k)
API_MM32 = [(100_000, 18, 5), (5, 100_000, 24), (1024, 512, 128)]
API_ITERS = 3       # plaintext Lloyd iterations per width, through the API
API_SEED = 11


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cold_copies(args: tuple) -> list:
    """Copies of one call's inputs, together at least twice the 50 MB L2
    cache: cycling through them, each call reads its inputs from device
    memory, as the bound assumes."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    count = min(16, max(1, -(-2 * L2_BYTES // max(1, nbytes))))
    return [args] + [tuple(t.clone() for t in args) for _ in range(count - 1)]


def device_ms(fn, arg_sets: list, reps: int = 20, bursts: int = 5) -> float:
    """Median over `bursts` of the mean device time of `reps` back-to-back
    calls fn(*args), cycling through `arg_sets`. A spin kernel queued first
    lets the host enqueue the whole burst before the device reaches it, so
    host launch gaps do not count."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)            # ~10 ms at 1.98 GHz
        start.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def mm_bound_ms(m: int, kdim: int, n: int) -> tuple[float, float]:
    """(bytes ms, operations ms): each operand read once, C written once;
    m*kdim*n 64-bit multiply-adds."""
    return (1e3 * 8 * (m * kdim + kdim * n + m * n) / HBM_BYTES_PER_S,
            1e3 * m * kdim * n / INT64_MAC_PER_S)


def ks_bound_ms(numel: int) -> tuple[float, float]:
    """(bytes ms, operations ms): 35 words read + 1 written per element;
    7 recombinations of 6 64-bit logic ops plus 6 level xors, each two
    32-bit ops."""
    return (1e3 * 8 * 36 * numel / HBM_BYTES_PER_S,
            1e3 * numel * (7 * 6 + 6) * 2 / INT32_OPS_PER_S)


def ell_bound_ms(blocks: torch.Tensor, counts: torch.Tensor,
                 y: torch.Tensor) -> tuple[float, float]:
    """(bytes ms, operations ms) of one spmm_ell: the tiles of the slots
    this input uses (sum of counts), Y, the output and the index arrays;
    one multiply-add of the word type per tile word and column of Y, or,
    for Y wider than ELL_DENSE_MAX_K (the kernel skips zero words), per
    non-zero tile word of the used slots and column of Y."""
    nrb, maxb, bm, bk = blocks.shape
    d_pad, k = y.shape
    word = blocks.element_size()
    used = int(counts.sum()) * bm * bk
    nbytes = word * (used + d_pad * k + nrb * bm * k) \
        + 4 * (nrb * maxb + nrb)
    macs = used
    if k > ELL_DENSE_MAX_K:
        keep = torch.arange(maxb, device=blocks.device)[None, :] \
            < counts[:, None].long()
        macs = int((blocks[keep] != 0).sum())
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * macs * k / MAC_PER_S[blocks.dtype])


def esd_bound_ms(n: int, d: int, k: int) -> tuple[float, float]:
    """(bytes ms, operations ms): x, mu read once, D' written once; one
    multiply-add per (i, j, d) — an FP32 FMA in the narrow kernel, three
    TF32 tensor-core products in the wide one (k > esd.SMALL_K) — and one
    FP32 FMA per (j, d) of the norms."""
    from repro_torch.kernels import esd
    rate = TF32_OPS_PER_S / 3 if k > esd.SMALL_K else FP32_OPS_PER_S
    return (1e3 * 4 * (n * d + k * d + n * k) / HBM_BYTES_PER_S,
            1e3 * (2 * n * d * k / rate + 2 * d * k / FP32_OPS_PER_S))


def argmin_bound_ms(n: int, k: int) -> tuple[float, float]:
    """(bytes ms, operations ms): the f32 distances read once, the int32
    one-hot written once; one compare per distance."""
    return (1e3 * 8 * n * k / HBM_BYTES_PER_S, 1e3 * n * k / FP32_OPS_PER_S)


def mm32_bound_ms(m: int, kdim: int, n: int) -> tuple[float, float]:
    """(bytes ms, operations ms) of a mod-2^32 ring product: 4-byte words,
    one 32-bit IMAD per multiply-add."""
    return (1e3 * 4 * (m * kdim + kdim * n + m * n) / HBM_BYTES_PER_S,
            1e3 * m * kdim * n / INT32_OPS_PER_S)


def _fmt_bound(bound: tuple[float, float]) -> str:
    by = "bytes" if bound[0] >= bound[1] else "operations"
    return f"{max(bound):.4f} ms ({by})"


def mm_device_launches(products: int, zeros: int, copies: int,
                       iters: int) -> str:
    """ring_matmul's device launches over a fit, counted by its wrapper:
    the products, the zero kernels before split ones, the operand copies."""
    total = products + zeros + copies
    return (f"ring_matmul device launches {total} ({products} products, "
            f"{zeros} zero kernels, {copies} copies), "
            f"{total / max(1, iters):g} an iteration")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def within(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> bool:
    """|got - want| <= atol + rtol |want| everywhere (a NaN fails)."""
    diff = (got.double() - want.double()).abs()
    return bool((diff <= atol + rtol * want.double().abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"card: {smi_line} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    return smi_line


def phase_kernels(rng):
    """Kernel = plain version on the card, exact equality; ks_carry_share
    times (ring_matmul is timed at the fits' own layouts,
    `time_fit_layouts`)."""
    from repro_torch.kernels import ksadder, modmatmul
    dev = torch.device("cuda")

    def words(shape):
        return torch.from_numpy(rng.integers(0, 1 << 64, shape, dtype=np.uint64)
                                .view(np.int64)).to(dev)

    def wrap_heavy(shape):    # every word >= 2^63: products overflow always
        top = np.uint64(0xFFFFFFFFFFFFFFFF)
        x = top - rng.integers(0, 1 << 62, shape, dtype=np.uint64)
        return torch.from_numpy(x.view(np.int64)).to(dev)

    rows = {"ks_carry_share": {}}
    worst = {"ring_matmul": 0.0, "ks_carry_share": 0.0}
    mm_cases = [(s, words) for s, _ in MM_PER_ITER] + \
        [((SP_N, SP_DA, SP_K), words), ((SP_K, SP_N, SP_DA), words)] + \
        [((1, 200, 7), words), ((129, 129, 129), words),
         ((64, 300, 24), wrap_heavy)]
    for (m, kdim, n), draw in mm_cases:
        a, b = draw((m, kdim)), draw((kdim, n))
        got = modmatmul.ring_matmul(a, b)
        want = modmatmul.ring_matmul_plain(a, b)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not torch.equal(got, want):
            fail(f"ring_matmul {m}x{kdim}x{n} ({draw.__name__}) differs from "
                 f"its plain version (max abs err {err})")
        worst["ring_matmul"] = max(worst["ring_matmul"], err)
        print(f"ring_matmul ({m},{kdim})@({kdim},{n}) [{draw.__name__}]: "
              f"equal", flush=True)

    for shape in [(N, 2), (N, 1), (K,), (1, 1), ()]:
        flat = [words(shape) for _ in range(6)]
        lvls = [words((len(ksadder.LEVELS), 2) + shape) for _ in range(5)]
        for party0 in (True, False):
            got = ksadder.ks_carry_share(*flat, *lvls, party0=party0)
            want = ksadder.ks_carry_share_plain(*flat, *lvls, party0=party0)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if not torch.equal(got, want):
                fail(f"ks_carry_share {shape} party0={party0} differs from "
                     f"its plain version (max abs err {err})")
            worst["ks_carry_share"] = max(worst["ks_carry_share"], err)
        numel = int(np.prod(shape, dtype=np.int64))
        sets = cold_copies((*flat, *lvls))
        ms = device_ms(lambda *t: ksadder.ks_carry_share(*t, party0=True),
                       sets)
        plain_ms = device_ms(
            lambda *t: ksadder.ks_carry_share_plain(*t, party0=True), sets,
            reps=5, bursts=3)
        del sets
        bound = ks_bound_ms(numel)
        rows["ks_carry_share"][shape] = (ms, plain_ms, bound)
        print(f"ks_carry_share {shape} (both parties): equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{_fmt_bound(bound)}", flush=True)
    return rows, worst


def fit_operand(gen, rows: int, cols: int, kind, mu_width: int):
    """A (rows, cols) operand of random int64 words from `gen`, in the
    layout `kind` of MM_FIT_PER_ITER, as a view of a freshly drawn base."""
    def draw(shape):
        return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                             dtype=torch.int64, device="cuda")
    if kind == "row":
        return draw((rows, cols))
    if kind == "t":
        return draw((cols, rows)).T
    _, lo = kind
    return draw((cols, mu_width)).T[lo:lo + rows]


def time_fit_layouts(table, mu_width: int, seed: int, label: str) -> dict:
    """ring_matmul at the fit's own operand layouts: each (shape, layouts)
    of `table` held word for word to the plain version, then timed with
    the wrapper's work included, on L2-cold inputs (fresh views of fresh
    bases, together at least twice the L2). Returns {(shape, a kind, b
    kind): (ms, plain_ms, bound)} and prints the per-iteration sums."""
    from repro_torch.kernels import modmatmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = {}
    tot = [0.0, 0.0, 0.0]
    for (m, kdim, n), a_kind, b_kind, count in table:
        def make():
            return (fit_operand(gen, m, kdim, a_kind, mu_width),
                    fit_operand(gen, kdim, n, b_kind, mu_width))
        a, b = make()
        got = modmatmul.ring_matmul(a, b)
        want = modmatmul.ring_matmul_plain(a.contiguous(), b.contiguous())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"ring_matmul ({m},{kdim})@({kdim},{n}) A {a_kind} B "
                 f"{b_kind} differs from its plain version")
        nbytes = 8 * (m * kdim + kdim * n)
        sets = [(a, b)] + [make() for _ in range(
            min(15, -(-2 * L2_BYTES // nbytes) - 1))]
        ms = device_ms(modmatmul.ring_matmul, sets)
        plain_ms = device_ms(modmatmul.ring_matmul_plain, sets, reps=3,
                             bursts=3)
        del sets
        bound = mm_bound_ms(m, kdim, n)
        rows[((m, kdim, n), a_kind, b_kind)] = (ms, plain_ms, bound)
        for i, v in enumerate((ms, plain_ms, max(bound))):
            tot[i] += count * v
        print(f"ring_matmul ({m},{kdim})@({kdim},{n}) at the fit's layout "
              f"A {a_kind} {tuple(a.stride())}, B {b_kind} "
              f"{tuple(b.stride())}, x{count} per iteration: equal; kernel "
              f"{ms:.4f} ms (wrapper included), plain {plain_ms:.4f} ms, "
              f"bound {_fmt_bound(bound)}", flush=True)
    print(f"ring_matmul per {label} iteration at the fit's layouts "
          f"({sum(c for *_, c in table)} products): kernel {tot[0]:.4f} ms, "
          f"plain {tot[1]:.4f} ms, bound {tot[2]:.4f} ms", flush=True)
    return rows


def library_spmm(blocks, idx, counts, y):
    """The one PyTorch call for the same product: the non-zero words of the
    used ELL tiles as a sparse tensor (built outside the timing) times Y
    with `torch.sparse.mm`; CSR for float32, COO for ring words (cuSPARSE
    has no integer CSR product, and COO refuses them with a plain
    NotImplementedError). Returns (ms or None, note)."""
    nrb, maxb, bm, bk = blocks.shape
    dev = blocks.device
    keep = torch.arange(maxb, device=dev)[None, :] < counts[:, None].long()
    r, j = keep.nonzero(as_tuple=True)
    rows = (r[:, None, None] * bm + torch.arange(bm, device=dev)[:, None]) \
        .expand(-1, bm, bk)
    cols = (idx[r, j].long()[:, None, None] * bk
            + torch.arange(bk, device=dev)[None, None, :]).expand(-1, bm, bk)
    vals = blocks[r, j].reshape(-1)
    nz = vals != 0
    try:
        sp = torch.sparse_coo_tensor(
            torch.stack([rows.reshape(-1)[nz], cols.reshape(-1)[nz]]),
            vals[nz], (nrb * bm, y.shape[0])).coalesce()
        if y.dtype == torch.float32:
            sp = sp.to_sparse_csr()
        got = torch.sparse.mm(sp, y)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"refused: {type(exc).__name__}: {str(exc)[:120]}"
    from repro_torch.kernels import spmm
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    same = within(got, want, 1e-5, 1e-3) if y.dtype == torch.float32 \
        else torch.equal(got, want)
    ms = device_ms(torch.sparse.mm, [(sp, y)], reps=5, bursts=3)
    return ms, f"ran, result {'agrees' if same else 'DIFFERS'}"


def time_spmm(label, blocks, idx, counts, y, library=False, plain=True):
    """Kernel = plain version (ring words exactly; float32 within rtol 1e-5,
    atol 1e-3, since its split tile lists meet by atomicAdd in an order
    that changes per run), then kernel, plain (when `plain`) and (when
    `library`) library times and the bound. Returns (ms, plain_ms or None,
    bound, lib_ms, err)."""
    from repro_torch.kernels import spmm
    got = spmm.spmm_ell(blocks, idx, counts, y)
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = within(got, want, 1e-5, 1e-3) if y.dtype == torch.float32 \
        else torch.equal(got, want)
    if not ok:
        fail(f"spmm_ell {label} differs from its plain version "
             f"(max abs err {err})")
    sets = cold_copies((blocks, idx, counts, y))
    ms = device_ms(spmm.spmm_ell, sets)
    plain_ms = device_ms(spmm.spmm_ell_plain, sets, reps=3, bursts=3) \
        if plain else None
    del sets
    bound = ell_bound_ms(blocks, counts, y)
    lib_ms, lib_note = library_spmm(blocks, idx, counts, y) if library \
        else (None, "")
    print(f"spmm_ell {label}: {'within tolerance' if y.dtype == torch.float32 else 'equal'}"
          f" (max abs err {err}); kernel {ms:.4f} ms, "
          + (f"plain {plain_ms:.4f} ms, " if plain else "")
          + f"bound {_fmt_bound(bound)}"
          + (f"; torch.sparse.mm {lib_note}"
             + (f", {lib_ms:.4f} ms" if lib_ms is not None else "")
             if library else ""), flush=True)
    return ms, plain_ms, bound, lib_ms, err


def phase_spmm(rng):
    """spmm_ell = plain version on the card at both main-path shapes and at
    odd ones (k=1 and 8, empty row blocks, garbage in padded slots,
    wrap-heavy words, an all-empty matrix), exact equality; times."""
    dev = torch.device("cuda")

    def words(shape, wrap_heavy=False):
        if wrap_heavy:           # every word >= 2^63
            x = np.uint64(0xFFFFFFFFFFFFFFFF) - rng.integers(
                0, 1 << 62, shape, dtype=np.uint64)
        else:
            x = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
        return torch.from_numpy(x.view(np.int64)).to(dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    def case(nrb, maxb, d_pad, k, counts, garbage_idx=False,
             wrap_heavy=False, zero_blocks=False, bm=8, bk=128):
        blocks = words((nrb, maxb, bm, bk), wrap_heavy)
        if zero_blocks:
            blocks.zero_()
        idx = rng.integers(0, d_pad // bk, (nrb, maxb))
        if garbage_idx:          # padded slots point far outside Y
            pad = np.arange(maxb)[None, :] >= np.asarray(counts)[:, None]
            idx[pad] = rng.integers(1 << 20, 1 << 30, int(pad.sum()))
        return blocks, i32(idx), i32(counts), words((d_pad, k), wrap_heavy)

    s1_nrb, s1_maxb, _, _ = SP_ELL_S1
    s3_nrb, s3_maxb, _, _ = SP_ELL_S3
    d_s3 = s3_maxb * 128
    s3_idx = np.broadcast_to(np.arange(s3_maxb), (s3_nrb, s3_maxb))
    rows, worst = {}, 0.0
    main = {
        "S1": (words(SP_ELL_S1), i32(np.zeros((s1_nrb, 1))),
               i32(np.ones(s1_nrb)), words((128, SP_K))),
        "S3": (words(SP_ELL_S3), i32(s3_idx), i32(np.full(s3_nrb, s3_maxb)),
               words((d_s3, SP_K))),
    }
    for name, args in main.items():
        blocks, _, _, y = args
        label = f"{name} {tuple(blocks.shape)} @ {tuple(y.shape)}"
        ms, plain_ms, bound, lib_ms, err = time_spmm(label, *args,
                                                     library=True)
        rows[name] = (ms, plain_ms, bound, lib_ms)
        worst = max(worst, err)
    odd = [
        ("k=1, empty row blocks", case(64, 20, 2560, 1,
                                       rng.integers(0, 21, 64))),
        ("k=8, empty row blocks", case(64, 20, 2560, 8,
                                       rng.integers(0, 21, 64))),
        ("garbage in padded slots", case(40, 12, 1536, 3,
                                         rng.integers(0, 13, 40),
                                         garbage_idx=True)),
        ("wrap-heavy words", case(300, 7, 1280, 3, np.full(300, 7),
                                  wrap_heavy=True)),
        ("all-empty matrix", case(50, 1, 128, 3, np.zeros(50),
                                  zero_blocks=True)),
        ("bm=4, bk=64, k=5", case(33, 9, 640, 5, rng.integers(0, 10, 33),
                                  bm=4, bk=64)),
    ]
    for label, args in odd:
        worst = max(worst, time_spmm(label, *args)[4])
    return rows, worst


def _one_hot_like(rng, n, d, k, sparsity, noise=0.3):
    """Each cluster has a fixed random (1 - sparsity) share of the columns
    as its support; a point is its cluster's center plus noise there and 0
    elsewhere. Separable at 90 % zeros, unlike blobs masked at random."""
    width = max(1, int(round((1 - sparsity) * d)))
    support = np.zeros((k, d), bool)
    for c in range(k):
        support[c, rng.choice(d, width, replace=False)] = True
    centers = rng.uniform(-2, 2, (k, d)) * support
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(0, noise, (n, d))) * support[lab]


def _blobs(rng, n, d, k, spread=5.0, noise=0.3):
    centers = rng.uniform(-spread, spread, (k, d))
    lab = rng.integers(0, k, n)
    return centers[lab] + rng.normal(0, noise, (n, d))


def phase_gpu_equals_cpu():
    """The GPU fit (cuda backend) = the CPU fit (torch backend), word for
    word, with the same dealer counters and per-tag traffic."""
    from repro_torch.core import ring
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    x = _blobs(np.random.default_rng(1), 2048, DA + DB, K)
    splits = {"vertical": (x[:, :DA], x[:, DA:]),
              "horizontal": (x[:1024], x[1024:])}
    for part, (xa, xb) in splits.items():
        res = {}
        for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
            cfg = KMeansConfig(k=K, iters=2, partition=part, seed=3,
                               backend=backend, device=device)
            res[backend] = SecureKMeans(cfg).fit(xa, xb)
        g, c = res["cuda"], res["torch"]
        for field in ("centroids", "assignment"):
            for i in (0, 1):
                gw = ring.to_u64_numpy(getattr(g, field)[i])
                cw = ring.to_u64_numpy(getattr(c, field)[i])
                if not np.array_equal(gw, cw):
                    fail(f"{part}: GPU and CPU {field} s{i} words differ")
        for attr in ("n_matmul", "n_mul", "n_bin"):
            if getattr(g.dealer, attr) != getattr(c.dealer, attr):
                fail(f"{part}: dealer {attr} differs")
        for phase in ("online", "offline"):
            if g.log.by_tag(phase) != c.log.by_tag(phase):
                fail(f"{part}: {phase} CommLog differs: "
                     f"{g.log.by_tag(phase)} vs {c.log.by_tag(phase)}")
        print(f"GPU fit = CPU fit ({part}, n=2048, k={K}, 2 iters): share "
              f"words, dealer counters (matmul {g.dealer.n_matmul}, mul "
              f"{g.dealer.n_mul}, bin {g.dealer.n_bin}) and online/offline "
              f"traffic per tag identical; GPU loop {g.loop_seconds:.3f} s, "
              f"CPU loop {c.loop_seconds:.3f} s", flush=True)


def phase_sparse_gpu_equals_cpu(k: int):
    """The sparse GPU fit = the sparse CPU fit, word for word, with the same
    dealer counters, per-tag traffic and modelled HE seconds; spmm_ell
    makes one launch a product at any k (4 an iteration, vertical)."""
    from repro_torch.core import ring
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.kernels import spmm
    x = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, k,
                      SP_SPARSITY)
    splits = {"vertical": (x[:, :SP_DA], x[:, SP_DA:]),
              "horizontal": (x[:1024], x[1024:])}
    for part, (xa, xb) in splits.items():
        res = {}
        for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
            cfg = KMeansConfig(k=k, iters=2, partition=part, seed=3,
                               sparse=True, backend=backend, device=device)
            before = spmm.LAUNCHES
            res[backend] = SecureKMeans(cfg).fit(xa, xb)
            if backend == "cuda":
                launches = spmm.LAUNCHES - before
        g, c = res["cuda"], res["torch"]
        want = SP_PER_ITER["spmm_ell"] * g.iters_run
        if part == "vertical" and launches != want:
            fail(f"sparse vertical fit, k={k}: {launches} spmm_ell launches, "
                 f"{want} expected (4 an iteration, one a product)")
        for field in ("centroids", "assignment"):
            for i in (0, 1):
                gw = ring.to_u64_numpy(getattr(g, field)[i])
                cw = ring.to_u64_numpy(getattr(c, field)[i])
                if not np.array_equal(gw, cw):
                    fail(f"sparse {part}, k={k}: GPU and CPU {field} s{i} differ")
        for attr in ("n_matmul", "n_mul", "n_bin"):
            if getattr(g.dealer, attr) != getattr(c.dealer, attr):
                fail(f"sparse {part}, k={k}: dealer {attr} differs")
        for phase in ("online", "offline"):
            if g.log.by_tag(phase) != c.log.by_tag(phase):
                fail(f"sparse {part}, k={k}: {phase} CommLog differs: "
                     f"{g.log.by_tag(phase)} vs {c.log.by_tag(phase)}")
        if g.he_seconds != c.he_seconds:
            fail(f"sparse {part}, k={k}: he_seconds {g.he_seconds} vs "
                 f"{c.he_seconds}")
        print(f"sparse GPU fit = CPU fit ({part}, n=2048, d={SP_DA}+{SP_DB},"
              f" k={k}, 2 iters): share words, dealer counters (matmul "
              f"{g.dealer.n_matmul}, mul {g.dealer.n_mul}, bin "
              f"{g.dealer.n_bin}), online/offline traffic per tag and "
              f"he_seconds ({g.he_seconds!r}) identical; GPU loop "
              f"{g.loop_seconds:.3f} s, CPU loop {c.loop_seconds:.3f} s; "
              f"spmm_ell launches {launches} in {g.iters_run} iterations",
              flush=True)


def phase_sparse_main_path():
    """The full-width sparse secure fit (Protocol 2) through the user's
    entry point, with the launch counters read around it; then spmm_ell
    timed on the fit's own ELL inputs."""
    from repro_torch.core import sparse
    from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans,
                                         plaintext_kmeans)
    from repro_torch.kernels import ksadder, modmatmul, spmm
    x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                      SP_DA + SP_DB, SP_K, SP_SPARSITY)
    zeros = float((x == 0).mean())
    cfg = KMeansConfig(k=SP_K, iters=SP_ITERS, partition="vertical",
                       seed=SP_SEED, sparse=True)
    modmatmul.LAUNCHES = 0
    modmatmul.COPIES = 0
    modmatmul.ZERO_LAUNCHES = 0
    ksadder.LAUNCHES = 0
    spmm.LAUNCHES = 0
    sparse.ELL_PACK_SECONDS = 0.0
    res = SecureKMeans(cfg).fit(x[:, :SP_DA], x[:, SP_DA:])
    launches = {"spmm_ell": spmm.LAUNCHES, "ring_matmul": modmatmul.LAUNCHES,
                "ks_carry_share": ksadder.LAUNCHES}
    copies = modmatmul.COPIES
    device_line = mm_device_launches(launches["ring_matmul"],
                                     modmatmul.ZERO_LAUNCHES, copies,
                                     res.iters_run)
    pack_s = sparse.ELL_PACK_SECONDS
    cent = res.centroids_plain()
    labels = res.labels_plain()
    if cent.shape != (SP_K, SP_DA + SP_DB) or not np.isfinite(cent).all():
        fail(f"sparse centroids not finite of shape {(SP_K, SP_DA + SP_DB)}")
    if labels.shape != (SP_N,):
        fail(f"sparse labels of shape {labels.shape}, want {(SP_N,)}")
    _, ref = plaintext_kmeans(x, SP_K, SP_ITERS, seed=SP_SEED)
    agree = float((labels == ref).mean())
    online_mb = res.log.total_bytes("online") / 2 ** 20
    print(f"sparse main path fit (vertical, n={SP_N}, d={SP_DA}+{SP_DB}, "
          f"k={SP_K}, {zeros:.4f} zeros, {res.iters_run} iters): agreement "
          f"with plaintext K-means {agree:.5f}; online_seconds "
          f"{res.online_seconds:.3f}, loop_seconds {res.loop_seconds:.3f}, "
          f"offline_dealer_seconds {res.offline_dealer_seconds:.3f}, "
          f"modelled he_seconds {res.he_seconds:.3f}, online "
          f"{online_mb:.2f} MB in {res.log.total_rounds('online')} rounds, "
          f"ELL packing and upload {pack_s:.3f} s (host, inside the loop)",
          flush=True)
    print(f"launches in the sparse main path: {launches} (expected from the "
          f"code: {SP_ITERS} x {SP_PER_ITER}); ring_matmul operand copies "
          f"{copies}; {device_line}", flush=True)
    if agree < 0.98:
        fail(f"sparse agreement {agree:.5f} < 0.98")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the sparse main path")

    # spmm_ell on this fit's own inputs: the four packed matrices of one
    # iteration, with random Y words of the shapes the fit gives them
    total = [0.0, 0.0, 0.0, 0.0, 0.0]      # ms, plain, bound, bytes, ops
    for label, args in fit_spmm_cases(x):
        ms, plain_ms, bound, _, _ = time_spmm(label, *args)
        for i, v in enumerate((ms, plain_ms, max(bound), *bound)):
            total[i] += v
    print(f"spmm_ell per sparse iteration (4 launches on the fit's data): "
          f"kernel {total[0]:.4f} ms, plain {total[1]:.4f} ms, bound "
          f"{total[2]:.4f} ms", flush=True)
    by = "bytes" if total[3] >= total[4] else "operations"
    return launches, (total[0], total[1], total[2], by)


def fit_spmm_cases(x: np.ndarray) -> list:
    """[(label, (blocks, idx, counts, y))] of the sparse fit's four spmm_ell
    products of one iteration (phase 4b): X_A and X_B packed as the fit
    packs them (S1) and their transposes (S3), with random Y words of the
    fit's shapes (seeded)."""
    from repro_torch.core import ring, sparse
    from repro_torch.core.kmeans import _encode_np
    rng = np.random.default_rng(SP_SEED)
    dev = torch.device("cuda")
    cases = []
    for name, xs in (("X_A", x[:, :SP_DA]), ("X_B", x[:, SP_DA:])):
        csr = sparse.CSRMatrix.from_dense(_encode_np(xs, ring.F))
        for step, mat in (("S1", csr), ("S3", csr.transpose())):
            blocks, idx, counts = mat.ell(device=dev)
            d_pad = blocks.shape[3] * -(-mat.shape[1] // blocks.shape[3])
            y = ring.from_u64_numpy(rng.integers(
                0, 1 << 64, (d_pad, SP_K), dtype=np.uint64), dev)
            label = (f"{step} on the fit's {name}{'^T' if step == 'S3' else ''}"
                     f" {tuple(blocks.shape)}, {int(counts.sum())} tiles used")
            cases.append((label, (blocks, idx, counts, y)))
    return cases


# ---------------------------------------------------------------------------
# phase 5: the kernel API (kernels/ops.py)
# ---------------------------------------------------------------------------

def _api_counters() -> dict:
    """{name in the kernels line: (module, counter)} of every kernel the
    kernel API can launch."""
    from repro_torch.kernels import argmin, esd, ksadder, modmatmul, spmm
    return {"esd": (esd, "LAUNCHES"), "argmin_onehot": (argmin, "LAUNCHES"),
            "ring_matmul_u32": (modmatmul, "LAUNCHES_U32"),
            "spmm_ell_f32": (spmm, "LAUNCHES_F32"),
            "spmm_ell_u32": (spmm, "LAUNCHES_U32"),
            "spmm_ell": (spmm, "LAUNCHES"),
            "spmm_ell_zero": (spmm, "ZERO_LAUNCHES"),
            "ring_matmul": (modmatmul, "LAUNCHES"),
            "ks_carry_share": (ksadder, "LAUNCHES")}


def _u32_words(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)


def lloyd_data(rng) -> dict:
    """{(d, k): (x on the host, x on the card, init rows)} for each esd
    width of phase 5: blobs from `rng`, each plaintext_kmeans init row in a
    blob of its own."""
    lloyd = {}
    for d, k in API_ESD:
        # plaintext_kmeans(seed=API_SEED) starts from these rows
        init = np.random.default_rng(API_SEED).choice(API_N, k, replace=False)
        centers = rng.uniform(-5.0, 5.0, (k, d))
        lab = rng.integers(0, k, API_N)
        lab[init] = np.arange(k)
        x = (centers[lab] + rng.normal(0, 0.3, (API_N, d))).astype(np.float32)
        lloyd[(d, k)] = (x, torch.from_numpy(x).cuda(), init)
    return lloyd


def api_data() -> dict:
    """Phase 5's inputs, made from seeds and uploaded: blobs and their
    plaintext_kmeans init rows at each esd width (each init row is put in a
    blob of its own, so no two centroids start in one blob and the Lloyd
    steps have clear margins: float32 and float64 then agree label for
    label); u32 ring operands; and phase 4b's X_A (the fit's fixed-point
    words, the same seed) packed to blocked ELL as S1 (X_A) and S3 (X_A^T)
    in each word type, with Y operands of the fit's shapes (k = 3; k = 10
    for the u64 words)."""
    from repro_torch.core import ring
    from repro_torch.core.kmeans import _encode_np
    from repro_torch.kernels import spmm
    dev = torch.device("cuda")
    rng = np.random.default_rng(API_SEED)
    lloyd = lloyd_data(rng)
    mm32 = [(_u32_words(rng, (m, kd), dev), _u32_words(rng, (kd, n), dev))
            for m, kd, n in API_MM32]
    xa = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                       SP_DA + SP_DB, SP_K, SP_SPARSITY)[:, :SP_DA]
    enc = _encode_np(xa, ring.F)
    host = {torch.float32: xa.astype(np.float32),
            torch.int32: (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            .view(np.int32),
            torch.int64: enc.view(np.int64)}
    ell = {}
    for dtype, mat in host.items():
        k = SP_WIDE_K if dtype == torch.int64 else SP_K
        for step, m in (("S1", mat), ("S3", np.ascontiguousarray(mat.T))):
            blocks, idx, counts = spmm.dense_to_ell(m)
            rows = m.shape[1]
            d_pad = -(-rows // blocks.shape[3]) * blocks.shape[3]
            if dtype == torch.float32:
                y = torch.from_numpy(rng.normal(0, 1, (d_pad, k))
                                     .astype(np.float32))
            elif dtype == torch.int32:
                y = torch.from_numpy(rng.integers(0, 1 << 32, (d_pad, k),
                                                  dtype=np.uint32)
                                     .view(np.int32))
            else:
                y = torch.from_numpy(rng.integers(0, 1 << 64, (d_pad, k),
                                                  dtype=np.uint64)
                                     .view(np.int64))
            y[rows:] = 0                      # the rows ops.spmm pads
            ell[(dtype, step)] = (torch.from_numpy(blocks).to(dev),
                                  torch.from_numpy(idx).to(dev),
                                  torch.from_numpy(counts).to(dev),
                                  y.to(dev), rows)
    return {"lloyd": lloyd, "mm32": mm32, "ell": ell}


def ctx_spmm_cases(lloyd: dict) -> list:
    """[(label, (blocks, idx, counts, y))] of the Lloyd drive's C^T x at each
    width: the one-hot of its first iteration's argmin_onehot, packed as
    spmm_from_dense packs it (C^T as float32, blocked ELL on the host),
    and x with the zero rows ops.spmm pads it with."""
    from repro_torch.kernels import ops, spmm
    cases = []
    for (d, k), (_, x, init) in lloyd.items():
        mu = x[torch.as_tensor(init, device=x.device)].clone()
        c = ops.argmin_onehot(ops.esd(x, mu))
        blocks, idx, counts = spmm.dense_to_ell(
            c.T.cpu().numpy().astype(np.float32))
        bk = blocks.shape[3]
        y = torch.cat([x, x.new_zeros(((-x.shape[0]) % bk, d))])
        label = (f"f32 C^T x (d={d}, k={k}) {tuple(blocks.shape)} @ "
                 f"{tuple(y.shape)}")
        cases.append((label, tuple(torch.from_numpy(a).to(x.device)
                                   for a in (blocks, idx, counts)) + (y,)))
    return cases


def api_spmm_cases(data: dict) -> list:
    """[(name in the kernels line, label, (blocks, idx, counts, y))] of
    phase 5's spmm_ell shapes: f32, u32 (k=3) and u64 (k=10) on phase 4b's
    X_A (S1) and X_A^T (S3), then the drive's C^T x (f32)."""
    names = {torch.float32: "spmm_ell_f32", torch.int32: "spmm_ell_u32",
             torch.int64: "spmm_ell_k10"}
    cases = []
    for (dtype, step), (blocks, idx, counts, y, _) in data["ell"].items():
        name = names[dtype]
        label = (f"{name.removeprefix('spmm_ell_')} {step} on phase 4b's X_A"
                 f"{'^T' if step == 'S3' else ''} {tuple(blocks.shape)} @ "
                 f"{tuple(y.shape)}")
        cases.append((name, label, (blocks, idx, counts, y)))
    cases += [("spmm_ell_f32", label, args)
              for label, args in ctx_spmm_cases(data["lloyd"])]
    return cases


def phase_api_main_path(data: dict) -> dict:
    """The kernel API through its public entry points, with every launch
    counter set to 0 just before and read just after: API_ITERS plaintext
    Lloyd iterations at each width (esd -> argmin_onehot -> C^T x through
    spmm_from_dense -> new centroids), the mod-2^32 ring products, and
    spmm in f32 and u32 (k = 3) and u64 (k = 10) on phase 4b's ELL. The
    Lloyd results are held to the repository's plaintext_kmeans (float64,
    same init rows); the rest to the plain versions."""
    from repro_torch.core.kmeans import plaintext_kmeans
    from repro_torch.kernels import modmatmul, ops, spmm
    counters = _api_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    lloyd = {}
    for (d, k), (_, x, init) in data["lloyd"].items():
        mu = x[torch.as_tensor(init, device=x.device)].clone()
        for _ in range(API_ITERS):
            c = ops.argmin_onehot(ops.esd(x, mu))
            sums = ops.spmm_from_dense(c.T, x)
            sizes = c.sum(0)[:, None]
            mu = torch.where(sizes > 0, sums / sizes.clamp(min=1), mu)
        lloyd[(d, k)] = (c, mu)
    rings = [ops.ring_matmul(a, b) for a, b in data["mm32"]]
    ells = {key: ops.spmm(blocks, idx, counts, y[:rows])
            for key, (blocks, idx, counts, y, rows) in data["ell"].items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}

    for (d, k), (c, mu) in lloyd.items():
        x_np, _, _ = data["lloyd"][(d, k)]
        mu_ref, lab_ref = plaintext_kmeans(x_np.astype(np.float64), k,
                                           API_ITERS, seed=API_SEED)
        c = c.cpu().numpy()
        mu = mu.cpu().numpy()
        if c.shape != (API_N, k) or not (c.sum(1) == 1).all():
            fail(f"API Lloyd d={d} k={k}: the one-hot is not one 1 per row")
        if mu.shape != (k, d) or not np.isfinite(mu).all():
            fail(f"API Lloyd d={d} k={k}: centroids not finite of shape "
                 f"{(k, d)}")
        agree = float((c.argmax(1) == lab_ref).mean())
        mu_err = float(np.abs(mu - mu_ref).max())
        print(f"kernel API Lloyd (n={API_N}, d={d}, k={k}, {API_ITERS} "
              f"iters): label agreement with plaintext_kmeans {agree:.5f}, "
              f"max centroid difference {mu_err:.3e}", flush=True)
        if agree < 0.999 or mu_err > 1e-3 * max(1.0, np.abs(mu_ref).max()):
            fail(f"API Lloyd d={d} k={k} departs from plaintext_kmeans")
    for (a, b), got in zip(data["mm32"], rings):
        if not torch.equal(got, modmatmul.ring_matmul_plain(a, b)):
            fail(f"API ring_matmul u32 {tuple(a.shape)}@{tuple(b.shape)} "
                 "differs from its plain version")
    for key, got in ells.items():
        blocks, idx, counts, y, rows = data["ell"][key]
        want = spmm.spmm_ell_plain(blocks, idx, counts, y)
        ok = within(got, want, 1e-5, 1e-3) if key[0] == torch.float32 \
            else torch.equal(got, want)
        if not ok:
            fail(f"API spmm {key} differs from its plain version")
    # one launch per spmm call at any width (spmm.plan), and a zero kernel
    # before each split one: C^T x at each width and iteration, then S1 and
    # S3 in each word type
    ell_calls = [(blocks.shape, y.shape[1], y.element_size())
                 for blocks, _, _, y, _ in data["ell"].values()]
    for d, k in data["lloyd"]:
        nrb = -(-k // 8)
        ell_calls += [((nrb, -(-API_N // 128), 8, 128), d, 4)] * API_ITERS
    expected = {
        "esd": len(API_ESD) * API_ITERS,
        "argmin_onehot": len(API_ESD) * API_ITERS,
        "ring_matmul_u32": len(API_MM32),
        "spmm_ell_f32": API_ITERS * len(API_ESD) + 2,
        "spmm_ell_u32": 2,
        "spmm_ell": 2,
        "spmm_ell_zero": sum(spmm.plan(*shape, k, word).zeroed
                             for shape, k, word in ell_calls),
        "ring_matmul": 0, "ks_carry_share": 0}
    print(f"launches in the kernel API path ({wall:.3f} s wall): {launches} "
          f"(expected from the code: {expected}; C^T x assumed to use all "
          f"{-(-API_N // 128)} column tiles of each row block)", flush=True)
    for name in ("spmm_ell_f32", "spmm_ell_u32", "spmm_ell"):
        if launches[name] != expected[name]:
            fail(f"{name}: {launches[name]} launches on the kernel API path, "
                 f"{expected[name]} expected (one a call)")
    for name in ("esd", "argmin_onehot", "ring_matmul_u32", "spmm_ell_f32",
                 "spmm_ell_u32", "spmm_ell"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the kernel API path")
    return launches


def library_esd(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """The PyTorch calls for the same function: the norms, then one addmm."""
    u = (mu * mu).sum(1)
    return torch.addmm(u[None], x, mu.T, alpha=-2)


def library_mm32(a: torch.Tensor, b: torch.Tensor):
    """torch.matmul on int32 words: (ms or None, note)."""
    try:
        got = torch.matmul(a, b)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"refused: {type(exc).__name__}: {str(exc)[:120]}"
    from repro_torch.kernels import modmatmul
    same = torch.equal(got, modmatmul.ring_matmul_plain(a, b))
    ms = device_ms(torch.matmul, [(a, b)], reps=5, bursts=3)
    return ms, f"ran, words {'equal' if same else 'DIFFER'}"


def check_time_esd(x: torch.Tensor, mu: torch.Tensor, plain: bool = True):
    """esd(x, mu) held to its plain version (rtol 1e-5, atol 1e-3), then
    the kernel's, the plain version's (when `plain`) and addmm + norms'
    times on L2-cold inputs, and the bound; printed. Returns (ms, plain_ms
    or None, bound, lib_ms, max abs err)."""
    from repro_torch.kernels import esd
    (n, d), k = x.shape, mu.shape[0]
    got, want = esd.esd(x, mu), esd.esd_plain(x, mu)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not within(got, want, 1e-5, 1e-3):
        fail(f"esd ({n},{d})x({k},{d}) departs from its plain version "
             f"beyond rtol 1e-5, atol 1e-3 (max abs err {err})")
    lib_err = max_abs_err(library_esd(x, mu), want)
    sets = cold_copies((x, mu))
    ms = device_ms(esd.esd, sets)
    plain_ms = device_ms(esd.esd_plain, sets, reps=5, bursts=3) \
        if plain else None
    lib_ms = device_ms(library_esd, sets, reps=5, bursts=3)
    del sets
    bound = esd_bound_ms(n, d, k)
    print(f"esd ({n},{d})x({k},{d}): within rtol 1e-5, atol 1e-3 (max abs "
          f"err {err:.3e}); kernel {ms:.4f} ms, "
          + (f"plain {plain_ms:.4f} ms, " if plain else "")
          + f"addmm + norms {lib_ms:.4f} ms (max abs err {lib_err:.3e}), "
          f"bound {_fmt_bound(bound)}", flush=True)
    return ms, plain_ms, bound, lib_ms, err


def _argmin_edge_rows(rng) -> np.ndarray:
    """Distances with ties, -0.0 against +0.0, +inf rows and NaN rows."""
    d = rng.normal(0, 10, (4096, 7)).astype(np.float32)
    d[::7] = np.round(d[::7])
    d[1::11] = 0.0
    d[1::11, ::2] = -0.0
    d[2::13] = np.inf
    d[3::17, -1] = np.nan
    return d


def phase_api_kernels(data: dict):
    """Each kernel of the API against its plain version at the phase-5
    shapes, then kernel, plain and library times (L2-cold inputs) and the
    bound. Returns ({name: [(ms, plain_ms, bound, lib_ms)]}, {name: worst
    max abs err}); u64 spmm at k=10 is held and printed, with its worst
    error under "spmm_ell_k10"."""
    from repro_torch.kernels import argmin, esd, modmatmul
    rows = {n: [] for n in ("esd", "argmin_onehot", "ring_matmul_u32",
                            "spmm_ell_f32", "spmm_ell_u32")}
    worst = dict.fromkeys([*rows, "spmm_ell_k10"], 0.0)
    for (d, k), (_, x, init) in data["lloyd"].items():
        mu = x[torch.as_tensor(init, device=x.device)].clone()
        ms, plain_ms, bound, lib_ms, err = check_time_esd(x, mu)
        worst["esd"] = max(worst["esd"], err)
        rows["esd"].append((ms, plain_ms, bound, lib_ms))

        dist = esd.esd_plain(x, mu)
        got, want = argmin.argmin_onehot(dist), argmin.argmin_onehot_plain(dist)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"argmin_onehot ({API_N},{k}) differs from its plain version")
        sets = cold_copies((dist,))
        ms = device_ms(argmin.argmin_onehot, sets)
        plain_ms = device_ms(argmin.argmin_onehot_plain, sets, reps=5,
                             bursts=3)
        ctx_ms = device_ms(lambda t: torch.argmin(t, 1), sets, reps=5,
                           bursts=3)
        del sets
        bound = argmin_bound_ms(API_N, k)
        rows["argmin_onehot"].append((ms, plain_ms, bound, None))
        print(f"argmin_onehot ({API_N},{k}): equal; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {_fmt_bound(bound)}; no single "
              f"PyTorch call makes the one-hot (torch.argmin alone, for "
              f"context: {ctx_ms:.4f} ms)", flush=True)
    edge = torch.from_numpy(_argmin_edge_rows(np.random.default_rng(API_SEED))
                            ).cuda()
    got = argmin.argmin_onehot(edge)
    if not torch.equal(got, argmin.argmin_onehot_plain(edge)):
        fail("argmin_onehot on ties, +-0, +inf and NaN rows differs from its "
             "plain version")
    nan_rows = torch.isnan(edge).any(1)
    if (got[nan_rows] != 0).any() or (got[~nan_rows].sum(1) != 1).any():
        fail("argmin_onehot: NaN rows not all zeros, or other rows not "
             "one-hot")
    print(f"argmin_onehot (4096,7) with ties, -0.0/+0.0, +inf rows and "
          f"{int(nan_rows.sum())} NaN rows: equal, NaN rows all zeros",
          flush=True)

    for (a, b), (m, kd, n) in zip(data["mm32"], API_MM32):
        got, want = modmatmul.ring_matmul(a, b), modmatmul.ring_matmul_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"ring_matmul u32 ({m},{kd})@({kd},{n}) differs from its "
                 f"plain version (max abs err {max_abs_err(got, want)})")
        sets = cold_copies((a, b))
        ms = device_ms(modmatmul.ring_matmul, sets)
        plain_ms = device_ms(modmatmul.ring_matmul_plain, sets, reps=3,
                             bursts=3)
        del sets
        lib_ms, lib_note = library_mm32(a, b)
        bound = mm32_bound_ms(m, kd, n)
        rows["ring_matmul_u32"].append((ms, plain_ms, bound, lib_ms))
        print(f"ring_matmul u32 ({m},{kd})@({kd},{n}): equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{_fmt_bound(bound)}; torch.matmul on int32 {lib_note}"
              + (f", {lib_ms:.4f} ms" if lib_ms is not None else ""),
              flush=True)

    for name, label, (blocks, idx, counts, y) in api_spmm_cases(data):
        ms, plain_ms, bound, lib_ms, err = time_spmm(
            label, blocks, idx, counts, y, library=name != "spmm_ell_k10")
        if name in rows:                  # u64 at k=10 is printed only
            rows[name].append((ms, plain_ms, bound, lib_ms))
        worst[name] = max(worst[name], err)
    return rows, worst


def phase_main_path():
    """The full-width secure fit through the user's entry point, with the
    launch counters read around it."""
    from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans,
                                         plaintext_kmeans)
    from repro_torch.kernels import ksadder, modmatmul, spmm
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED)
    modmatmul.LAUNCHES = 0
    modmatmul.COPIES = 0
    modmatmul.ZERO_LAUNCHES = 0
    ksadder.LAUNCHES = 0
    spmm.LAUNCHES = 0
    res = SecureKMeans(cfg).fit(x[:, :DA], x[:, DA:])
    launches = {"ring_matmul": modmatmul.LAUNCHES,
                "ks_carry_share": ksadder.LAUNCHES}
    dense_spmm = spmm.LAUNCHES
    copies = modmatmul.COPIES
    device_line = mm_device_launches(launches["ring_matmul"],
                                     modmatmul.ZERO_LAUNCHES, copies,
                                     res.iters_run)
    cent = res.centroids_plain()
    labels = res.labels_plain()
    if cent.shape != (K, DA + DB) or not np.isfinite(cent).all():
        fail(f"centroids not finite of shape {(K, DA + DB)}: {cent.shape}")
    if labels.shape != (N,):
        fail(f"labels of shape {labels.shape}, want {(N,)}")
    _, ref = plaintext_kmeans(x, K, ITERS, seed=SEED)
    agree = float((labels == ref).mean())
    online_mb = res.log.total_bytes("online") / 2 ** 20
    print(f"main path fit (vertical, n={N}, d={DA}+{DB}, k={K}, "
          f"{res.iters_run} iters): agreement with plaintext K-means "
          f"{agree:.5f}; online_seconds {res.online_seconds:.3f}, "
          f"loop_seconds {res.loop_seconds:.3f}, offline_dealer_seconds "
          f"{res.offline_dealer_seconds:.3f}, online {online_mb:.2f} MB in "
          f"{res.log.total_rounds('online')} rounds", flush=True)
    print(f"launches in the main path: {launches}, spmm_ell {dense_spmm} "
          f"(expected per iteration from the code: ring_matmul "
          f"{sum(c for _, c in MM_PER_ITER)}, ks_carry_share "
          f"{sum(c for _, c in KS_PER_ITER)}, spmm_ell 0); ring_matmul "
          f"operand copies {copies} (expected 0: every layout the fit "
          f"passes is read in place); {device_line}", flush=True)
    if agree < 0.98:
        fail(f"agreement {agree:.5f} < 0.98")
    if copies != 0:
        fail(f"ring_matmul copied {copies} operands on the main path")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the main path")
    return launches


def kernel_times(src: pathlib.Path, smi_line: str) -> None:
    """`--kernel-times`: ring_matmul at the dense and sparse fits' own
    layouts, esd beside addmm + norms at the phase-5 shapes, and spmm_ell
    at every shape of the sparse fit (phase 4b) and of the kernel API
    (phase 5, the drive's C^T x included), each held to its plain version
    first, for the repro_torch package under `src`. Run it on two trees in
    one call, in turns, to compare their kernels on one card. Prints one
    JSON line of the times."""
    out = {"src": str(src), "card": smi_line, "ring_matmul": {}, "esd": {},
           "spmm_ell": {}}
    for label, table, width, seed in (
            ("dense", MM_FIT_PER_ITER, DA + DB, SEED),
            ("sparse", SP_MM_FIT_PER_ITER, SP_DA + SP_DB, SEED + 1)):
        rows = time_fit_layouts(table, width, seed, label)
        per_case = {f"{m}x{kd}x{n} A {a} B {b}": rows[((m, kd, n), a, b)][0]
                    for (m, kd, n), a, b, _ in table}
        out["ring_matmul"][label] = {
            "per_iteration_ms": sum(c * rows[(sh, a, b)][0]
                                    for sh, a, b, c in table),
            "bound_ms": sum(c * max(rows[(sh, a, b)][2])
                            for sh, a, b, c in table),
            "cases_ms": per_case}
    for (d, k), (_, x, init) in lloyd_data(
            np.random.default_rng(API_SEED)).items():
        mu = x[torch.as_tensor(init, device=x.device)].clone()
        ms, _, bound, lib_ms, err = check_time_esd(x, mu, plain=False)
        out["esd"][f"{d}x{k}"] = {"ms": ms, "library_ms": lib_ms,
                                  "bound_ms": max(bound), "max_abs_err": err}
    x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                      SP_DA + SP_DB, SP_K, SP_SPARSITY)
    cases = [("spmm_ell", label, args) for label, args in fit_spmm_cases(x)]
    del x
    data = api_data()
    cases += api_spmm_cases(data)
    for name, label, args in cases:
        ms, _, bound, _, err = time_spmm(label, *args, plain=False)
        out["spmm_ell"][label] = {"ms": ms, "bound_ms": max(bound),
                                  "max_abs_err": err}
    print(json.dumps({"kernel_times": out}))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA GPU is available")
    torch.backends.cuda.matmul.allow_tf32 = False    # FP32 plain versions
    args = sys.argv[1:]
    src = ROOT / "src"
    if "--src" in args:
        src = pathlib.Path(args[args.index("--src") + 1]).resolve()
    sys.path.insert(0, str(src))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"cannot import repro_torch from {src}: {exc}")
    smi_line = setup()
    from repro_torch.kernels import spmm
    if hasattr(spmm, "NARROW_WIDTHS") \
            and spmm.NARROW_WIDTHS[-1] != ELL_DENSE_MAX_K:
        fail(f"ELL_DENSE_MAX_K {ELL_DENSE_MAX_K} is not the narrow spmm "
             f"kernel's widest Y ({spmm.NARROW_WIDTHS[-1]})")
    if "--kernel-times" in args:
        kernel_times(src, smi_line)
        return
    rows, worst = phase_kernels(np.random.default_rng(SEED))
    fit_rows = time_fit_layouts(MM_FIT_PER_ITER, DA + DB, SEED, "dense")
    time_fit_layouts(SP_MM_FIT_PER_ITER, SP_DA + SP_DB, SEED + 1, "sparse")
    sp_rows, worst["spmm_ell"] = phase_spmm(np.random.default_rng(SEED + 1))
    phase_gpu_equals_cpu()
    phase_sparse_gpu_equals_cpu(SP_K)
    phase_sparse_gpu_equals_cpu(SP_WIDE_K)
    launches = phase_main_path()
    sp_launches, sp_iter = phase_sparse_main_path()
    data = api_data()
    api_launches = phase_api_main_path(data)
    api_rows, api_worst = phase_api_kernels(data)
    worst["spmm_ell"] = max(worst["spmm_ell"], api_worst["spmm_ell_k10"])
    del data

    # per-kernel line: times and bounds summed over one vertical iteration's
    # launches at the main-path shapes (MM_PER_ITER / KS_PER_ITER)
    def per_iter(name, table):
        ms = plain = bound = by_bytes = by_ops = 0.0
        for shape, count in table:
            k_ms, p_ms, (b_ms, o_ms) = rows[name][shape]
            ms += count * k_ms
            plain += count * p_ms
            bound += count * max(b_ms, o_ms)
            by_bytes += count * b_ms
            by_ops += count * o_ms
        return ms, plain, bound, "bytes" if by_bytes >= by_ops else "operations"

    # ring_matmul: the dense iteration's 20 products at the fit's own
    # layouts, the wrapper's work included
    mm = [0.0, 0.0, 0.0, 0.0, 0.0]     # ms, plain, bound, bytes, operations
    for shape, a_kind, b_kind, count in MM_FIT_PER_ITER:
        k_ms, p_ms, (b_ms, o_ms) = fit_rows[(shape, a_kind, b_kind)]
        for i, v in enumerate((k_ms, p_ms, max(b_ms, o_ms), b_ms, o_ms)):
            mm[i] += count * v
    mm[3] = "bytes" if mm[3] >= mm[4] else "operations"
    ks = per_iter("ks_carry_share", KS_PER_ITER)
    libs = [sp_rows[s][3] for s in ("S1", "S3")]
    lib_ms = None if None in libs else 2 * sum(libs)
    kernels = [
        {"name": "ring_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/modmatmul.cu",
         "replaces": "src/repro/kernels/modmatmul.py:71",
         "launches": launches["ring_matmul"],
         "max_abs_err": worst["ring_matmul"],
         "ms": mm[0], "plain_ms": mm[1], "bound_ms": mm[2],
         "bound_by": mm[3], "library_ms": None},
        {"name": "ks_carry_share", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ksadder.cu",
         "replaces": "src/repro/kernels/ksadder.py:56",
         "launches": launches["ks_carry_share"],
         "max_abs_err": worst["ks_carry_share"],
         "ms": ks[0], "plain_ms": ks[1], "bound_ms": ks[2],
         "bound_by": ks[3], "library_ms": None},
        # per sparse iteration: the 4 launches on the phase-4b fit's own
        # ELL inputs; library: torch.sparse.mm at both main-path shapes
        # (None where it refuses int64)
        {"name": "spmm_ell", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spmm.cu",
         "replaces": "src/repro/kernels/spmm.py:80",
         "launches": sp_launches["spmm_ell"],
         "max_abs_err": worst["spmm_ell"],
         "ms": sp_iter[0], "plain_ms": sp_iter[1], "bound_ms": sp_iter[2],
         "bound_by": sp_iter[3], "library_ms": lib_ms},
    ]

    # the kernel API's kernels (phase 5): launches from its counted drive;
    # times and bounds summed over one call at each of its phase-5 shapes;
    # library: the sum of the PyTorch calls where every shape has one
    def summed(name):
        rs = api_rows[name]
        by_bytes = sum(r[2][0] for r in rs)
        by_ops = sum(r[2][1] for r in rs)
        libs = [r[3] for r in rs]
        return {"ms": sum(r[0] for r in rs), "plain_ms": sum(r[1] for r in rs),
                "bound_ms": sum(max(r[2]) for r in rs),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": None if None in libs else sum(libs)}

    for name, src, replaces in (
            ("ring_matmul_u32", "modmatmul.cu", "modmatmul.py:29"),
            ("spmm_ell_f32", "spmm.cu", "spmm.py:29"),
            ("spmm_ell_u32", "spmm.cu", "spmm.py:29"),
            ("esd", "esd.cu", "esd.py:43"),
            ("argmin_onehot", "argmin.cu", "argmin.py:28")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": api_launches[name], "max_abs_err": api_worst[name],
            **summed(name)})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
