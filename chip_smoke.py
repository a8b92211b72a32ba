"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit. It builds the hand-written kernels from `src/repro_torch/kernels/
csrc` (into the ignored `build/torch_kernels/`), then:

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the build time;
  2. holds each kernel against its plain PyTorch version on the card, with
     exact integer equality, at the main path's full-size shapes and at odd
     and wrap-heavy ones, and times both;
  3. runs the secure fit on the GPU (backend="cuda") and on the CPU
     (backend="torch") at a small size, both partitions, and requires the
     same share words, dealer counters and per-tag traffic;
  4. runs the main path — SecureKMeans.fit, vertical, d_a=18, d_b=24, k=5,
     10 iterations at n=100,000 (the paper's fraud-detection deployment
     shape) — with the launch counters set to 0 just before and read just
     after, and requires agreement >= 0.98 with plaintext K-means;
  4b. runs the sparse main path the same way — SecureKMeans.fit with
     sparse=True (Protocol 2), vertical, d_a=d_b=128, k=3, 90 % zeros,
     5 iterations at n=100,000 — requires agreement >= 0.98 and all three
     kernels launched, and times `spmm_ell` on that fit's own ELL inputs;
  5. prints one JSON line of per-kernel launches, times and bounds, the
     nvidia-smi line, and finally {"ok": true, "device": {...}}.

Phases 2 and 3 cover the sparse slice too: `spmm_ell` against its plain
version at both main-path shapes and at odd ones, and the sparse GPU fit
against the sparse CPU fit.

Any failure exits non-zero before the final line. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.
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

# Launches of each kernel shape per vertical Lloyd iteration at k=5, read
# from core/kmeans.py and core/protocol.py: S1 has 2 Beaver smatmuls
# (4 ring_mm each) + 2 local products; S3 the same over C^T X; S2's
# tournament compares (n,2), (n,1), (n,1) and S3's empty-cluster guard
# (k,), two ks_carry_share launches (one per party) per compare.
MM_PER_ITER = [((N, DA, K), 5), ((N, DB, K), 5), ((K, N, DA), 5),
               ((K, N, DB), 5)]                      # ((m, kdim, n), count)
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
    one 64-bit multiply-add per tile word and column of Y."""
    nrb, maxb, bm, bk = blocks.shape
    d_pad, k = y.shape
    used = int(counts.sum()) * bm * bk
    nbytes = 8 * (used + d_pad * k + nrb * bm * k) + 4 * (nrb * maxb + nrb)
    return (1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * used * k / INT64_MAC_PER_S)


def _fmt_bound(bound: tuple[float, float]) -> str:
    by = "bytes" if bound[0] >= bound[1] else "operations"
    return f"{max(bound):.4f} ms ({by})"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


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
    """Kernel = plain version on the card, exact equality; times."""
    from repro_torch.kernels import ksadder, modmatmul
    dev = torch.device("cuda")

    def words(shape):
        return torch.from_numpy(rng.integers(0, 1 << 64, shape, dtype=np.uint64)
                                .view(np.int64)).to(dev)

    def wrap_heavy(shape):    # every word >= 2^63: products overflow always
        top = np.uint64(0xFFFFFFFFFFFFFFFF)
        x = top - rng.integers(0, 1 << 62, shape, dtype=np.uint64)
        return torch.from_numpy(x.view(np.int64)).to(dev)

    rows = {"ring_matmul": {}, "ks_carry_share": {}}
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
        sets = cold_copies((a, b))
        ms = device_ms(modmatmul.ring_matmul, sets)
        plain_ms = device_ms(modmatmul.ring_matmul_plain, sets, reps=3,
                             bursts=3)
        del sets
        bound = mm_bound_ms(m, kdim, n)
        rows["ring_matmul"][(m, kdim, n)] = (ms, plain_ms, bound)
        print(f"ring_matmul ({m},{kdim})@({kdim},{n}) [{draw.__name__}]: "
              f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {_fmt_bound(bound)}", flush=True)

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


def library_spmm(blocks, idx, counts, y):
    """The one PyTorch call for the same product: the ELL tiles as a COO
    tensor (built outside the timing) times Y with `torch.sparse.mm`.
    Returns (ms or None, note)."""
    nrb, maxb, bm, bk = blocks.shape
    dev = blocks.device
    keep = torch.arange(maxb, device=dev)[None, :] < counts[:, None].long()
    r, j = keep.nonzero(as_tuple=True)
    rows = (r[:, None, None] * bm + torch.arange(bm, device=dev)[:, None]) \
        .expand(-1, bm, bk)
    cols = (idx[r, j].long()[:, None, None] * bk
            + torch.arange(bk, device=dev)[None, None, :]).expand(-1, bm, bk)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), cols.reshape(-1)]),
        blocks[r, j].reshape(-1), (nrb * bm, y.shape[0])).coalesce()
    try:
        got = torch.sparse.mm(coo, y)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"refused: {type(exc).__name__}: {str(exc)[:120]}"
    from repro_torch.kernels import spmm
    same = torch.equal(got, spmm.spmm_ell_plain(blocks, idx, counts, y))
    ms = device_ms(torch.sparse.mm, [(coo, y)], reps=5, bursts=3)
    return ms, f"ran, words {'equal' if same else 'DIFFER'}"


def time_spmm(label, blocks, idx, counts, y, library=False):
    """Kernel = plain version (exact), then kernel, plain and (optionally)
    library times and the bound. Returns (ms, plain_ms, bound, lib_ms)."""
    from repro_torch.kernels import spmm
    got = spmm.spmm_ell(blocks, idx, counts, y)
    want = spmm.spmm_ell_plain(blocks, idx, counts, y)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not torch.equal(got, want):
        fail(f"spmm_ell {label} differs from its plain version "
             f"(max abs err {err})")
    sets = cold_copies((blocks, idx, counts, y))
    ms = device_ms(spmm.spmm_ell, sets)
    plain_ms = device_ms(spmm.spmm_ell_plain, sets, reps=3, bursts=3)
    del sets
    bound = ell_bound_ms(blocks, counts, y)
    lib_ms, lib_note = library_spmm(blocks, idx, counts, y) if library \
        else (None, "")
    print(f"spmm_ell {label}: equal; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {_fmt_bound(bound)}"
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


def phase_sparse_gpu_equals_cpu():
    """The sparse GPU fit = the sparse CPU fit, word for word, with the same
    dealer counters, per-tag traffic and modelled HE seconds."""
    from repro_torch.core import ring
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    x = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, SP_K,
                      SP_SPARSITY)
    splits = {"vertical": (x[:, :SP_DA], x[:, SP_DA:]),
              "horizontal": (x[:1024], x[1024:])}
    for part, (xa, xb) in splits.items():
        res = {}
        for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
            cfg = KMeansConfig(k=SP_K, iters=2, partition=part, seed=3,
                               sparse=True, backend=backend, device=device)
            res[backend] = SecureKMeans(cfg).fit(xa, xb)
        g, c = res["cuda"], res["torch"]
        for field in ("centroids", "assignment"):
            for i in (0, 1):
                gw = ring.to_u64_numpy(getattr(g, field)[i])
                cw = ring.to_u64_numpy(getattr(c, field)[i])
                if not np.array_equal(gw, cw):
                    fail(f"sparse {part}: GPU and CPU {field} s{i} differ")
        for attr in ("n_matmul", "n_mul", "n_bin"):
            if getattr(g.dealer, attr) != getattr(c.dealer, attr):
                fail(f"sparse {part}: dealer {attr} differs")
        for phase in ("online", "offline"):
            if g.log.by_tag(phase) != c.log.by_tag(phase):
                fail(f"sparse {part}: {phase} CommLog differs: "
                     f"{g.log.by_tag(phase)} vs {c.log.by_tag(phase)}")
        if g.he_seconds != c.he_seconds:
            fail(f"sparse {part}: he_seconds {g.he_seconds} vs "
                 f"{c.he_seconds}")
        print(f"sparse GPU fit = CPU fit ({part}, n=2048, d={SP_DA}+{SP_DB},"
              f" k={SP_K}, 2 iters): share words, dealer counters (matmul "
              f"{g.dealer.n_matmul}, mul {g.dealer.n_mul}, bin "
              f"{g.dealer.n_bin}), online/offline traffic per tag and "
              f"he_seconds ({g.he_seconds!r}) identical; GPU loop "
              f"{g.loop_seconds:.3f} s, CPU loop {c.loop_seconds:.3f} s",
              flush=True)


def phase_sparse_main_path():
    """The full-width sparse secure fit (Protocol 2) through the user's
    entry point, with the launch counters read around it; then spmm_ell
    timed on the fit's own ELL inputs."""
    from repro_torch.core import ring, sparse
    from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans,
                                         _encode_np, plaintext_kmeans)
    from repro_torch.kernels import ksadder, modmatmul, spmm
    x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                      SP_DA + SP_DB, SP_K, SP_SPARSITY)
    zeros = float((x == 0).mean())
    cfg = KMeansConfig(k=SP_K, iters=SP_ITERS, partition="vertical",
                       seed=SP_SEED, sparse=True)
    modmatmul.LAUNCHES = 0
    ksadder.LAUNCHES = 0
    spmm.LAUNCHES = 0
    sparse.ELL_PACK_SECONDS = 0.0
    res = SecureKMeans(cfg).fit(x[:, :SP_DA], x[:, SP_DA:])
    launches = {"spmm_ell": spmm.LAUNCHES, "ring_matmul": modmatmul.LAUNCHES,
                "ks_carry_share": ksadder.LAUNCHES}
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
          f"code: {SP_ITERS} x {SP_PER_ITER})", flush=True)
    if agree < 0.98:
        fail(f"sparse agreement {agree:.5f} < 0.98")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the sparse main path")

    # spmm_ell on this fit's own inputs: the four packed matrices of one
    # iteration, with random Y words of the shapes the fit gives them
    rng = np.random.default_rng(SP_SEED)
    dev = torch.device("cuda")
    total = [0.0, 0.0, 0.0, 0.0, 0.0]      # ms, plain, bound, bytes, ops
    for name, xs in (("X_A", x[:, :SP_DA]), ("X_B", x[:, SP_DA:])):
        csr = sparse.CSRMatrix.from_dense(_encode_np(xs, cfg.f))
        for step, mat in (("S1", csr), ("S3", csr.transpose())):
            blocks, idx, counts = mat.ell(device=dev)
            d_pad = blocks.shape[3] * -(-mat.shape[1] // blocks.shape[3])
            y = ring.from_u64_numpy(rng.integers(
                0, 1 << 64, (d_pad, SP_K), dtype=np.uint64), dev)
            label = (f"{step} on the fit's {name}{'^T' if step == 'S3' else ''}"
                     f" {tuple(blocks.shape)}, {int(counts.sum())} tiles used")
            ms, plain_ms, bound, _, _ = time_spmm(label, blocks, idx, counts,
                                                  y)
            for i, v in enumerate((ms, plain_ms, max(bound), *bound)):
                total[i] += v
    print(f"spmm_ell per sparse iteration (4 launches on the fit's data): "
          f"kernel {total[0]:.4f} ms, plain {total[1]:.4f} ms, bound "
          f"{total[2]:.4f} ms", flush=True)
    by = "bytes" if total[3] >= total[4] else "operations"
    return launches, (total[0], total[1], total[2], by)


def phase_main_path():
    """The full-width secure fit through the user's entry point, with the
    launch counters read around it."""
    from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans,
                                         plaintext_kmeans)
    from repro_torch.kernels import ksadder, modmatmul, spmm
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED)
    modmatmul.LAUNCHES = 0
    ksadder.LAUNCHES = 0
    spmm.LAUNCHES = 0
    res = SecureKMeans(cfg).fit(x[:, :DA], x[:, DA:])
    launches = {"ring_matmul": modmatmul.LAUNCHES,
                "ks_carry_share": ksadder.LAUNCHES}
    dense_spmm = spmm.LAUNCHES
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
          f"{sum(c for _, c in KS_PER_ITER)}, spmm_ell 0)", flush=True)
    if agree < 0.98:
        fail(f"agreement {agree:.5f} < 0.98")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the main path")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA GPU is available")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {exc}")
    smi_line = setup()
    rows, worst = phase_kernels(np.random.default_rng(SEED))
    sp_rows, worst["spmm_ell"] = phase_spmm(np.random.default_rng(SEED + 1))
    phase_gpu_equals_cpu()
    phase_sparse_gpu_equals_cpu()
    launches = phase_main_path()
    sp_launches, sp_iter = phase_sparse_main_path()

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

    mm = per_iter("ring_matmul", MM_PER_ITER)
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
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
