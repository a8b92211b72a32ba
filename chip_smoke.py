"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit. It builds the hand-written kernels from `src/repro_torch/kernels/
csrc` (into the ignored `build/torch_kernels/`), then:

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions and the build time;
  2. holds each kernel against its plain PyTorch version on the card, with
     exact integer equality, at the main path's full-size shapes and at odd
     and wrap-heavy ones (ring_matmul also at phase 10's widths and operand
     layouts, at a ragged n, which loads its wide variants before any timed
     wall), and times ks_carry_share and spmm_ell there, and the secure
     reciprocal's Newton loop (`kernels/newton.py`) at the benchmark
     cells' (k, iters), beside its plain chain and a latency estimate;
     ring_matmul is timed at the operand layouts the dense and sparse fits
     really pass (transposed and sliced views, read in place, and the
     contiguous ones), the wrapper's work included;
  3. runs the secure fit on the GPU (backend="cuda") and on the CPU
     (backend="torch") at a small size, both partitions, and requires the
     same share words, dealer counters, per-tag traffic and he_seconds; on
     the GPU with the on-demand, the pooled and the streamed dealer
     (`offline=`) for the dense fit and the sparse one at k=3; and the
     minibatch fit (batch_size 700 of 2048 rows, dense k=5 and sparse k=3,
     pooled and streamed, pipeline on and off) held to the CPU one; then
     secure scoring: `predict` and `score` (the scoring program and the
     eager protocol), both partitions, dense and sparse, a bank-fed
     full-batch and minibatch fit (`plan_fit`, `TripleBank`,
     `fit(dealer=)`) and a `ScoringService` drain with pipeline on and
     off, each on the card held to the CPU word for word; and the host
     ring backend (backend="numpy", device="cpu") on the dense and sparse
     vertical fits, held word for word to the card's fits, with the
     seconds of both;
  4. runs the main path — SecureKMeans.fit, vertical, d_a=18, d_b=24, k=5,
     10 iterations at n=100,000 (the paper's fraud-detection deployment
     shape) — with the launch counters set to 0 just before and read just
     after, and requires agreement >= 0.98 with plaintext K-means and no
     ring_matmul operand copy (`modmatmul.COPIES`); it prints the device
     launches ring_matmul made (products and zero kernels); then the same
     fit with offline="pooled" and "streamed" (the offline planner, the
     pooled / streaming dealer and the S1/S3 programs), each from cold
     caches and held word for word to the on-demand fit, printing their
     loop, online, dealer and plan seconds, pool bytes, the streaming
     worker's gen and wait seconds, and the kernels their loops launched
     per iteration, which must equal the on-demand fit's;
  4b. runs the sparse main path the same way — SecureKMeans.fit with
     sparse=True (Protocol 2), vertical, d_a=d_b=128, k=3, 90 % zeros,
     5 iterations at n=100,000 — requires agreement >= 0.98 and all three
     kernels launched, then the pooled and streamed fits as in phase 4, and
     times `spmm_ell` on that fit's own ELL inputs;
  4c. runs minibatch Lloyd (`batch_size`, the SlotDealer, the batch and
     finalize programs and the pipelined executor) at the widths of phases
     4 and 4b, each fit from cold caches with the launch counters read
     around it and its planning's launches taken out: dense n=100,000 in
     batches of 25,000, pooled, pipeline on, off, off, on (word for word
     equal, agreement >= 0.98); batch_size = n, equal to phase 4's pooled fit with
     its launches per iteration; streamed, equal to pooled, its peak pool
     and its peak device memory less the data and the assignment under
     (window + largest group) x largest slot; the streamed fit at
     n=400,000 (3 iterations) under the same bound; sparse n=100,000 in
     batches of 25,000, pipeline on, off, off, on (equal, agreement
     >= 0.98), printing the four online times;
  6. (run after 4c, before 5) the paper's Sec 5.6 serving deployment at
     phase 4's widths, the launch counters read around each scoring run:
     6a plan_fit, a
     TripleBank provisioned under phase 4's seed and fit(dealer=...),
     equal to phase 4's pooled fit with its launches per iteration; 6b
     `score` of the 100,000 rows against that model in one program call,
     on demand and from a bank (the same words; labels the nearest revealed
     centroid wherever the margin exceeds 1e-6, scores within 1e-3 of the
     plaintext squared distance, except the rows the protocol's local
     truncation wraps, which must be few as the distances predict, each
     wrapped score off by a multiple of 2^24); 6c the ScoringService (ladder 32, 128,
     512; banks sized so nothing replenishes) over 2,000 ragged requests
     of Poisson(48) rows, pipeline on, off, off, on, each turn from a
     fresh bank and answering identically, printing rows/s, calls,
     pad overhead, p50/p99 latency and the warm-up seconds; 6d the same
     on phase 4b's sparse model with 200 requests (spmm_ell launched, ELL
     packing seconds printed); 6e the fraud pipeline at n=100,000
     (`run_secure_fraud`, pooled), the secure Jaccard within 0.05 of the
     plaintext joint one;
  7. (run after 6, before 5) durability and the wire, each path with the
     launch counters read around it: 7a `python -m repro_torch.launch.
     two_party` at n=100,000, d=42 (21 + 21), k=5, 10 iterations, seed 5:
     party A on the card, party B a CPU wire peer over TCP on 127.0.0.1;
     A's words, dealer counters and CommLog per tag and phase equal the
     in-process fit's on the card, the wire's payload bytes and rounds
     equal the CommLog's online traffic, B never initialized CUDA, and A's
     loop launched what the in-process loop did; 7b A with
     `--offline pooled --checkpoint-dir D --die-at-iter 4` exits with
     KILL_EXIT_CODE, and a resumed A against a fresh B, under 1 % drops,
     duplicates and corruption each way with keyed frames, ends with the
     words of an uninterrupted pooled fit on the card, its loop launching
     6 iterations' kernels; 7c phase 4c's sparse minibatch fit (pipeline
     off) with a checkpoint after every batch, stopped from `after_save`
     after its 6th published step (mid-iteration) and resumed, equal to
     phase 4c's sequential fit, the two runs' loops launching what it
     launched; 7d a `ScoringServer` (a process of its own, this script with
     `--scoring-server`) in front of a `ScoringService` of phase 6's model
     with a `ServeCheckpointer`, 200 Poisson(48)-row requests (seed 11)
     from a `ScoringClient` through a `FaultyTransport` (keyed), the server
     killed after its 100th journaled response and restarted on the same
     port: every response equals an uninterrupted in-process service's,
     each rid scored once, the bank's consumed counts equal; it prints
     each part's seconds, traffic, restart seconds and retries (the
     server's replays are its tracer's `serve.replay` instants);
  8. (run after 7) observability, the serving launcher and the
     supervisor: 8a phase 4's on-demand fit, phase 4b's sparse pooled fit
     and phase 4c's dense pooled minibatch fit (batch 25,000, pipeline
     on) with the port's tracer on, each equal word for word to its
     untraced fit (the on-demand one launching what phase 4's did), with
     the code's span counts (those of a CPU fit of the configuration),
     `repro_fit_iteration_seconds` grown by the iterations and a Chrome
     trace that loads, printing each fit's flame summary and its step
     spans against loop_seconds, traced against untraced; 8b
     `launch/serve_kmeans.serve()` at the fraud deployment's widths over
     2,000 Poisson(48)-row requests: the registry's online traffic equals
     phase 4's, the serve gauges count the stream, the bank gauges read
     the bank's own counts, no NaN in the exposition; 8c `python -m
     repro_torch.launch.serve_kmeans --supervised` at those widths, the
     server killed after 50 journaled responses of 100 (6c's stream):
     one crash (rc 17) and one restart, every rid answered once with the
     words of the in-process service `serve_wire` builds, /health 503
     until READY and 200 after, /metrics after the restart with phase
     4's online traffic, a parent without CUDA, and the client's and the
     surviving server's traces merged on the client's trace ids; 8d phase
     7a's two-party command at 2 iterations with `--trace-out` on both
     parties: A's wire.exchange spans carry its session's payload bytes
     and rounds, B handled every request A sent, B without CUDA, both
     parties on the merged timeline; scratch files go to the ignored
     `build/phase8/` and are removed;
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
  9. (run after 5) the LM substrate, no kernel of the table on its path:
     9a every reduced config on the card against the CPU, one CPU-drawn
     tree carried to both (`params_to_numpy` / `params_from_numpy`):
     forward, lm_loss and one train step in bf16 and in f32 (but for
     seamless, whose encoder casts to bf16), three serve_step positions;
     9b granite-moe-3b-a800m at full width (32 layers, d=1536, 40 experts
     top-8 padded to 48, per-example dispatch, 3.98e9 parameters):
     `serve()` (batch 4, prompt 32, 64 tokens), serve_step against the
     teacher-forced forward over 8 positions (capacity 8, within 0.15,
     argmax equal), one serve_step and one train step under torch.profiler
     (device ms, launches, idle share), `run()` for 20 steps at batch 4 x
     256 tokens (losses finite, the last five below the first; p50/p95 and
     peak memory); 9c examples/train_lm_torch.py's granite-100m killed at
     step 25, resumed from its step-20 `CheckpointStore` step and held to
     an uninterrupted run within rtol 1e-4, and 5 compressed steps; it
     prints one `LM {...}` line; scratch in the ignored `build/phase9/`;
 10. (run after 9) the kmeans-fraud cell (configs/kmeans_fraud.py: d =
     1024 = 512 + 512, k = 16) as the single-launch online iteration
     (launch/kmeans_step.py `online_iteration_fn`, backend="cuda"): 10a
     dense at n = 524,288 (the full n's 52.65 GB offline list leaves no
     room on the card), blobs from a seed, the offline list from a
     TrustedDealer; the launch counters set to 0 just before the iteration
     and read just after; its words equal the S1 -> S3 pair of
     `fit_programs` fed the same list, `fit_iteration_fn` (centroids and
     assignment) and FUSE_BEAVER off; the centroids within 1e-2 of one
     plaintext Lloyd step, label agreement >= 0.98; no ring_matmul
     operand copied (`modmatmul.COPIES`) and one zero kernel before each
     product its plan splits along K (`ZERO_LAUNCHES`); ring_matmul and
     ks_carry_share held to their plain versions and timed at each shape
     and operand layout the iteration gave them, against their bounds;
     the roofline's one-chip step (launch/roofline.py's data-sheet
     constants over the counted FLOPs and bytes) beside the wall; 10b
     sparse at the full n = 1,048,576 with Protocol 2's 8 result shares
     drawn from a seed, fused = the split pair, the same copy and zero
     kernel counts, ring_matmul and ks_carry_share held to their plain
     versions and timed at each of its shapes and layouts; 10c
     `python -m repro_torch.launch.dryrun --kmeans`, `--arch
     granite-moe-3b-a800m --shape train_4k --mesh single`, the same arch's
     decode_32k, `python -m repro_torch.launch.roofline --arch
     kmeans-fraud` and `python -m repro_torch.launch.dryrun --tp-ratios`
     (every reduced config's train_4k at global batch 2 on a fake (2, 4)
     mesh), each a CPU process
     started when the phase starts: exit 0, no error record, no
     `collective_error`, no CUDA context, the kmeans-fraud cell's
     collectives on both meshes and the roofline's three terms printed
     (a float collective term), their records formatted by
     benchmarks/report.py, and each arch's replication ratio printed and
     at most its bound (1.10, or the JAX package's own ratio where that
     is higher); 10d
     `launch/mesh.py:make_dev_mesh()` on the card, a reduced config's tree
     placed by `param_shardings` with every local shape and word its
     global one. It prints one `KMEANS_CELL {...}` line and its seconds;
     scratch in the ignored `build/phase10/`;
 11. prints one JSON line of per-kernel launches (the fit path's, and for
     the fit kernels the scoring path's as `scoring_launches`, phase 7's
     as `durability_launches`, phase 8's in-process and party-A
     launches as `observability_launches` and phase 10a's as
     `kmeans_cell_launches`), times and bounds (ring_matmul's also per
     iteration of 10a and 10b as `kmeans_cell` and `kmeans_cell_sparse`),
     the nvidia-smi line, and finally {"ok": true, "device": {...}}.

Phases 2 and 3 cover the sparse slice too: `spmm_ell` against its plain
version at both main-path shapes and at odd ones, and the sparse GPU fit
against the sparse CPU fit at k=3 and at k=10. Every spmm_ell call is one
launch for any width of y (`spmm.plan`).

Every float32 plain version runs with torch.backends.cuda.matmul.
allow_tf32 = False (set here), so it is full FP32 like the kernels.

Any failure exits non-zero before the final line. Without a GPU, or outside
a checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernel-times [--src DIR]

times only ring_matmul at the fits' own operand layouts and at the
kmeans-fraud cell's (10a's 20 products at n = 524,288 and 10b's 4 at n =
1,048,576, on fresh words, no dealer; plus the long-K wide launch at 132,
264 and 528 blocks, the cost of its atomicAdd meeting), esd beside addmm +
norms, and spmm_ell at every shape of the sparse fit and the kernel API
(phase 4b's four products, f32 / u32 / u64 k=10 S1 and S3, and the Lloyd
drive's C^T x at its three widths), each held to its plain version first,
for the repro_torch package under DIR (default: this checkout's src/), and
prints one JSON line.
Run on two trees in one call, in turns (A, B, B, A), it compares their
kernels on one card.

    python3 chip_smoke.py --cell

runs only the build and phase 10.

    python3 chip_smoke.py --cell-walls [--src DIR]

builds 10a's data and dealer list once and calls its iteration four times
in a row, each synchronized (the first cold: kernels load at their first
launch), for the repro_torch under DIR, and prints their walls as one JSON
line. Run on two trees in one call, it compares their iterations.

    python3 chip_smoke.py --scoring-server DIR PORT DIE_AFTER

is phase 7d's scoring server process; the smoke starts it itself.
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
    # the kmeans-fraud cell's wide variants (phase 10) at its widths and
    # operand layouts, at a ragged n; this also loads them before any
    # timed wall (a kernel's first launch in a process loads it)
    for (m, kdim, n), a_t, b_t in (
            ((KF_K, 4099, KF_D_A), False, False),
            ((KF_K, 4099, KF_D_A), True, False),
            ((4097, KF_D_A, KF_K), False, False),
            ((4097, KF_D_A, KF_K), False, True)):
        for draw in (words, wrap_heavy):
            a = draw((kdim, m)).T if a_t else draw((m, kdim))
            b = draw((n, kdim)).T if b_t else draw((kdim, n))
            got = modmatmul.ring_matmul(a, b)
            want = modmatmul.ring_matmul_plain(a.contiguous(),
                                               b.contiguous())
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if not torch.equal(got, want):
                fail(f"ring_matmul {m}x{kdim}x{n} (A^T {a_t}, B^T {b_t}, "
                     f"{draw.__name__}) differs from its plain version "
                     f"(max abs err {err})")
            worst["ring_matmul"] = max(worst["ring_matmul"], err)
        print(f"ring_matmul ({m},{kdim})@({kdim},{n}) A^T {a_t} B^T {b_t}, "
              f"the cell's widths: equal", flush=True)

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
    phase_newton(words)
    return rows, worst


# (k, iters) of S3's Newton loop in the benchmark's cells: fraud-deploy (k =
# 5, n = 6,362,620) and kmeans-fraud (k = 16, n = 2^19); iters = 0 launches
# once and copies x0: the launch's floor
NEWTON_CASES = ((5, 29), (16, 25), (5, 0), (16, 0), (4099, 45))
NEWTON_DEP_CYCLES = 40   # estimated dependent-chain cycles of one product


def newton_bound_ms(iters: int) -> float:
    """Latency bound of the loop: 2 * iters Beaver products, each waiting on
    the one before, at NEWTON_DEP_CYCLES cycles of the SM's top clock."""
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    return 1e3 * 2 * iters * NEWTON_DEP_CYCLES / clock


def phase_newton(words) -> None:
    """The reciprocal's Newton loop: kernel = plain version, word for word,
    and its time at the cells' (k, iters), with the plain chain's."""
    from repro_torch.core import ring
    from repro_torch.core.sharing import AShare
    from repro_torch.core.triples import MulTriple
    from repro_torch.kernels import newton

    def share(k):
        return AShare(words((k,)), words((k,)))

    for k, iters in NEWTON_CASES:
        dp, x0 = share(k), share(k)
        triples = [MulTriple(share(k), share(k), share(k))
                   for _ in range(2 * iters)]

        def kernel():
            return newton.newton_recip(dp, x0, triples, f=ring.F,
                                       iters=iters)

        def plain():
            return newton.newton_recip_plain(dp, x0, triples, f=ring.F,
                                             iters=iters)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got.s0, want.s0)
                and torch.equal(got.s1, want.s1)):
            fail(f"newton_recip k={k} iters={iters} differs from its plain "
                 f"version")
        ms = device_ms(kernel, [()])
        plain_ms = device_ms(plain, [()], reps=5, bursts=3)
        print(f"newton_recip k={k} iters={iters}: equal; kernel "
              f"{1e3 * ms:.2f} us, plain {1e3 * plain_ms:.2f} us, latency "
              f"bound {1e3 * newton_bound_ms(iters):.2f} us (estimate)",
              flush=True)


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


def same_fit(label: str, got, want, he_rel: float = 0.0) -> None:
    """Fail unless two fits agree word for word: centroid and assignment
    shares, dealer counters, CommLog bytes and rounds per tag and phase,
    and the modelled he_seconds (bit for bit, or within `he_rel` relative
    where the two add the same float terms in another order)."""
    from repro_torch.core import ring
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            gw = ring.to_u64_numpy(getattr(got, field)[i])
            ww = ring.to_u64_numpy(getattr(want, field)[i])
            if not np.array_equal(gw, ww):
                fail(f"{label}: {field} s{i} words differ")
    for attr in ("n_matmul", "n_mul", "n_bin"):
        if getattr(got.dealer, attr) != getattr(want.dealer, attr):
            fail(f"{label}: dealer {attr} {getattr(got.dealer, attr)} vs "
                 f"{getattr(want.dealer, attr)}")
    for phase in ("online", "offline"):
        if got.log.by_tag(phase) != want.log.by_tag(phase):
            fail(f"{label}: {phase} CommLog differs: "
                 f"{got.log.by_tag(phase)} vs {want.log.by_tag(phase)}")
    if abs(got.he_seconds - want.he_seconds) > he_rel * abs(want.he_seconds):
        fail(f"{label}: he_seconds {got.he_seconds!r} vs "
             f"{want.he_seconds!r}")
    if got.iters_run != want.iters_run:
        fail(f"{label}: {got.iters_run} iterations vs {want.iters_run}")


def gpu_fits_equal_cpu(label: str, xa, xb, offline_modes, **cfg_kw) -> dict:
    """The CPU fit (torch backend, on demand) and the GPU fit (cuda
    backend) in each of `offline_modes`, each GPU fit held to the CPU one
    word for word. Returns {mode: (GPU result, its kernel launches)} and
    prints one line."""
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    cpu = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                    **cfg_kw)).fit(xa, xb)
    out = {}
    for mode in offline_modes:
        before = _launch_counters()
        res = SecureKMeans(KMeansConfig(offline=mode, **cfg_kw)).fit(xa, xb)
        after = _launch_counters()
        out[mode] = (res, {n: after[n] - before[n] for n in after})
        same_fit(f"{label}, GPU {mode} vs CPU on demand", res, cpu)
    g = out[offline_modes[0]][0]
    loops = ", ".join(f"{m} {r.loop_seconds:.3f} s"
                      for m, (r, _) in out.items())
    print(f"GPU fit = CPU fit ({label}): GPU {', '.join(offline_modes)} "
          f"fits each equal the CPU on-demand fit in share words, dealer "
          f"counters (matmul {g.dealer.n_matmul}, mul {g.dealer.n_mul}, bin "
          f"{g.dealer.n_bin}), online/offline traffic per tag and "
          f"he_seconds ({g.he_seconds!r}); GPU loop {loops}, CPU loop "
          f"{cpu.loop_seconds:.3f} s", flush=True)
    return out


OFFLINE_MODES = ("on_demand", "pooled", "streamed")


def phase_gpu_equals_cpu():
    """The GPU fit (cuda backend) = the CPU fit (torch backend), word for
    word, with the same dealer counters and per-tag traffic; on the GPU
    with the on-demand, the pooled and the streamed dealer."""
    x = _blobs(np.random.default_rng(1), 2048, DA + DB, K)
    splits = {"vertical": (x[:, :DA], x[:, DA:]),
              "horizontal": (x[:1024], x[1024:])}
    for part, (xa, xb) in splits.items():
        gpu_fits_equal_cpu(f"{part}, n=2048, k={K}, 2 iters", xa, xb,
                           OFFLINE_MODES, k=K, iters=2, partition=part,
                           seed=3)


def phase_sparse_gpu_equals_cpu(k: int, offline_modes=("on_demand",)):
    """The sparse GPU fit = the sparse CPU fit, word for word, with the same
    dealer counters, per-tag traffic and modelled HE seconds; spmm_ell
    makes one launch a product at any k (4 an iteration, vertical)."""
    from repro_torch.kernels import spmm
    x = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, k,
                      SP_SPARSITY)
    splits = {"vertical": (x[:, :SP_DA], x[:, SP_DA:]),
              "horizontal": (x[:1024], x[1024:])}
    for part, (xa, xb) in splits.items():
        res = gpu_fits_equal_cpu(
            f"sparse {part}, n=2048, d={SP_DA}+{SP_DB}, k={k}, 2 iters",
            xa, xb, offline_modes, k=k, iters=2, partition=part, seed=3,
            sparse=True)
        g, launches = res["on_demand"]
        want = SP_PER_ITER["spmm_ell"] * g.iters_run
        if part == "vertical" and launches["spmm_ell"] != want:
            fail(f"sparse vertical fit, k={k}: {launches['spmm_ell']} "
                 f"spmm_ell launches, {want} expected (4 an iteration, one "
                 f"a product)")
        print(f"  spmm_ell launches of the on-demand GPU fit: "
              f"{launches['spmm_ell']} in {g.iters_run} iterations",
              flush=True)
        del res


def _launch_counters() -> dict:
    from repro_torch.kernels import ksadder, modmatmul, spmm
    return {"ring_matmul": modmatmul.LAUNCHES,
            "ks_carry_share": ksadder.LAUNCHES, "spmm_ell": spmm.LAUNCHES}


def _zero_launch_counters() -> None:
    from repro_torch.kernels import ksadder, modmatmul, spmm
    modmatmul.LAUNCHES = 0
    modmatmul.COPIES = 0
    modmatmul.ZERO_LAUNCHES = 0
    ksadder.LAUNCHES = 0
    spmm.LAUNCHES = 0


def _cold_caches() -> None:
    from repro_torch.core import kmeans as KM
    from repro_torch.launch import kmeans_step as KS
    KM.clear_plan_cache()
    KS.clear_program_cache()


def fit_record(res):
    """What `same_fit` compares of a fit, without its dealer's pool, and
    its loop seconds."""
    from types import SimpleNamespace
    d = res.dealer
    return SimpleNamespace(
        centroids=res.centroids, assignment=res.assignment, log=res.log,
        he_seconds=res.he_seconds, iters_run=res.iters_run,
        loop_seconds=res.loop_seconds,
        dealer=SimpleNamespace(n_matmul=d.n_matmul, n_mul=d.n_mul,
                               n_bin=d.n_bin))


def phase_offline_fits(label: str, cfg, xa, xb, ref,
                       ref_launches: dict) -> tuple:
    """The main-path fit `cfg` again with offline="pooled" and "streamed",
    each from cold plan and program caches, held word for word to the
    on-demand fit `ref`. Prints each fit's loop, online, dealer and plan
    seconds, its pool bytes (the streaming dealer's peak), the streaming
    worker's gen and wait seconds, and the kernels its loop launched per
    iteration: the fit's launches less those of the planning alone (the
    dry-run trace and the programs' recording), which must equal the
    on-demand fit's. Returns ({mode: per-iteration launches}, the pooled
    fit's `fit_record`)."""
    import dataclasses
    from repro_torch.core import sparse
    from repro_torch.core.kmeans import SecureKMeans
    from repro_torch.launch import kmeans_step as KS

    totals = {}
    pooled = None
    for mode in ("pooled", "streamed"):
        _cold_caches()
        _zero_launch_counters()
        sparse.ELL_PACK_SECONDS = 0.0
        res = SecureKMeans(dataclasses.replace(cfg, offline=mode)).fit(xa, xb)
        totals[mode] = _launch_counters()
        same_fit(f"{label} {mode} vs on demand", res, ref)
        if mode == "pooled":
            pooled = fit_record(res)
        d = res.dealer
        extra = (f", worker gen_seconds {d.gen_seconds:.3f}, wait_seconds "
                 f"{d.wait_seconds:.3f}, tranches of {d.group} iteration(s)"
                 if mode == "streamed" else "")
        pack = (f", ELL packing and upload enqueue "
                f"{sparse.ELL_PACK_SECONDS:.3f} s (the planning trace's "
                f"included)" if cfg.sparse else "")
        print(f"{label} fit, offline={mode}: equal to the on-demand fit word "
              f"for word (share words, dealer counters, traffic per tag and "
              f"phase, he_seconds); loop_seconds {res.loop_seconds:.3f}, "
              f"online_seconds {res.online_seconds:.3f}, "
              f"offline_dealer_seconds {res.offline_dealer_seconds:.3f} "
              f"(of which offline_plan_seconds "
              f"{res.offline_plan_seconds:.3f}), pool "
              f"{'peak ' if mode == 'streamed' else ''}"
              f"{d.pool_bytes / 1e9:.3f} GB{extra}{pack}", flush=True)
        del res, d
        torch.cuda.empty_cache()
    _cold_caches()
    _zero_launch_counters()
    sparse.ELL_PACK_SECONDS = 0.0
    t0 = time.perf_counter()
    SecureKMeans(cfg).plan_offline(xa.shape, xb.shape)
    KS.fit_programs(cfg.partition, cfg.sparse, xa.shape, xb.shape, cfg.k,
                    backend=cfg.backend, device=cfg.device)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    planning = _launch_counters()
    _cold_caches()
    per_iter = {}
    for mode, total in totals.items():
        loop = {n: total[n] - planning[n] for n in total}
        if loop != ref_launches:
            fail(f"{label} {mode}: the loop launched {loop}, the on-demand "
                 f"fit {ref_launches}")
        per_iter[mode] = {n: v / ref.iters_run for n, v in loop.items()}
    print(f"{label}: kernels launched per iteration by the pooled and the "
          f"streamed loop {per_iter['pooled']} = the on-demand fit's "
          f"{ {n: v / ref.iters_run for n, v in ref_launches.items()} }; the "
          f"planning alone (trace and program recording, {plan_s:.3f} s) "
          f"launched {planning}"
          + (f", ELL packing {sparse.ELL_PACK_SECONDS:.3f} s"
             if cfg.sparse else ""), flush=True)
    return per_iter, pooled


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
    _zero_launch_counters()
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
          f"ELL packing and upload enqueue {pack_s:.3f} s (host, inside "
          f"the loop)",
          flush=True)
    print(f"launches in the sparse main path: {launches} (expected from the "
          f"code: {SP_ITERS} x {SP_PER_ITER}); ring_matmul operand copies "
          f"{copies}; {device_line}", flush=True)
    if agree < 0.98:
        fail(f"sparse agreement {agree:.5f} < 0.98")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the sparse main path")
    _, sp_pooled = phase_offline_fits(
        f"sparse main path (vertical, n={SP_N}, d={SP_DA}+{SP_DB}, k={SP_K})",
        cfg, x[:, :SP_DA], x[:, SP_DA:], res, launches)
    del res

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
    return launches, (total[0], total[1], total[2], by), sp_pooled


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
    _zero_launch_counters()
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
    per_iter, pooled = phase_offline_fits(
        f"main path (vertical, n={N}, d={DA}+{DB}, k={K})", cfg,
        x[:, :DA], x[:, DA:], res, {**launches, "spmm_ell": dense_spmm})
    return launches, per_iter["pooled"], pooled, \
        (fit_record(res), {**launches, "spmm_ell": dense_spmm})


# ---------------------------------------------------------------------------
# minibatch Lloyd (phase 3's small fits and phase 4c)
# ---------------------------------------------------------------------------

def phase_minibatch_gpu_equals_cpu():
    """The minibatch GPU fit = the minibatch CPU fit, word for word (shares,
    dealer counters, traffic per tag and phase, he_seconds bit for bit),
    both partitions, dense (k=5) and sparse (k=3), pooled and streamed,
    pipeline on and off, at a batch size that leaves a remainder."""
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    dense = _blobs(np.random.default_rng(1), 2048, DA + DB, K)
    sp = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, SP_K,
                       SP_SPARSITY)
    cases = [("dense", dense, DA, K, False), ("sparse", sp, SP_DA, SP_K, True)]
    for name, x, da, k, sparse in cases:
        for part in ("vertical", "horizontal"):
            xa, xb = (x[:, :da], x[:, da:]) if part == "vertical" \
                else (x[:1024], x[1024:])
            for pipeline in (True, False):
                kw = dict(k=k, iters=2, partition=part, seed=3, sparse=sparse,
                          batch_size=700, pipeline=pipeline)
                cpu = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                                offline="pooled", **kw)) \
                    .fit(xa, xb)
                loops = []
                for mode in ("pooled", "streamed"):
                    res = SecureKMeans(KMeansConfig(offline=mode, **kw)) \
                        .fit(xa, xb)
                    same_fit(f"minibatch {name} {part} pipeline={pipeline}, "
                             f"GPU {mode} vs CPU", res, cpu)
                    loops.append(f"{mode} {res.loop_seconds:.3f} s")
                print(f"minibatch GPU fit = CPU fit ({name} {part}, n=2048, "
                      f"k={k}, batch_size 700, pipeline={pipeline}): GPU "
                      f"pooled and streamed equal the CPU fit word for word "
                      f"(he_seconds {cpu.he_seconds!r}); GPU loop "
                      f"{', '.join(loops)}, CPU loop {cpu.loop_seconds:.3f} s",
                      flush=True)


MB_BATCH = 25_000      # phase 4c: 4 batches an iteration at n = 100,000
MB_BIG_N = 400_000     # the residency check's n, at MB_BIG_ITERS iterations
MB_BIG_ITERS = 3


def _minibatch_planning_launches(cfg, shape_a, shape_b) -> dict:
    """The launches of a minibatch fit's planning alone, from cold caches:
    the stage and finalize traces and the batch and finalize programs'
    recording."""
    from repro_torch.core.kmeans import SecureKMeans
    from repro_torch.launch import kmeans_step as KS
    _cold_caches()
    _zero_launch_counters()
    bounds = SecureKMeans(cfg)._minibatch_slot_plans(shape_a, shape_b)[0]
    for (alo, ahi), (blo, bhi) in bounds:
        KS.fit_batch_programs(cfg.partition, cfg.sparse,
                              (ahi - alo, shape_a[1]), (bhi - blo, shape_b[1]),
                              cfg.k, backend=cfg.backend, device=cfg.device)
    n = shape_a[0] if cfg.partition == "vertical" else shape_a[0] + shape_b[0]
    d = shape_a[1] + shape_b[1] if cfg.partition == "vertical" else shape_a[1]
    KS.finalize_program(cfg.k, d, n, backend=cfg.backend, device=cfg.device)
    torch.cuda.synchronize()
    out = _launch_counters()
    _cold_caches()
    return out


def minibatch_fit(label: str, cfg, xa, xb) -> tuple:
    """One minibatch fit from cold caches, its launch counters set to 0
    just before and read just after, less its planning's launches. Prints
    its seconds, pool bytes, worker seconds and per-iteration launches.
    Returns (result, loop launches, peak device bytes the fit allocated
    above what was allocated before it)."""
    from repro_torch.core import sparse
    from repro_torch.core.kmeans import SecureKMeans
    planning = _minibatch_planning_launches(cfg, xa.shape, xb.shape)
    _cold_caches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_launch_counters()
    sparse.ELL_PACK_SECONDS = 0.0
    res = SecureKMeans(cfg).fit(xa, xb)
    total = _launch_counters()
    peak = torch.cuda.max_memory_allocated() - base
    loop = {n: total[n] - planning[n] for n in total}
    d = res.dealer
    extra = (f", worker gen_seconds {d.gen_seconds:.3f}, wait_seconds "
             f"{d.wait_seconds:.3f}" if cfg.offline == "streamed" else "")
    pack = (f", ELL packing and upload enqueue "
            f"{sparse.ELL_PACK_SECONDS:.3f} s (the planning trace's "
            f"included)" if cfg.sparse else "")
    per_iter = {n: v / res.iters_run for n, v in loop.items()}
    print(f"{label}: {res.iters_run} iters; loop_seconds "
          f"{res.loop_seconds:.3f}, online_seconds {res.online_seconds:.3f}, "
          f"offline_dealer_seconds {res.offline_dealer_seconds:.3f} (of which "
          f"offline_plan_seconds {res.offline_plan_seconds:.3f}), pool "
          f"{'peak ' if cfg.offline == 'streamed' else ''}"
          f"{d.pool_bytes / 1e9:.4f} GB{extra}{pack}; peak device memory "
          f"{peak / 1e9:.3f} GB; kernels per iteration of the loop "
          f"{per_iter} (the planning alone launched {planning})", flush=True)
    return res, loop, peak


def _agreement(res, x, k: int, iters: int, seed: int) -> float:
    from repro_torch.core.kmeans import plaintext_kmeans
    cent = res.centroids_plain()
    labels = res.labels_plain()
    if cent.shape != (k, x.shape[1]) or not np.isfinite(cent).all():
        fail(f"minibatch centroids not finite of shape {(k, x.shape[1])}")
    if labels.shape != (x.shape[0],):
        fail(f"minibatch labels of shape {labels.shape}")
    _, ref = plaintext_kmeans(x, k, iters, seed=seed)
    return float((labels == ref).mean())


def residency_bound(dealer) -> int:
    """(window + largest generation group) x the largest slot's bytes: the
    streamed SlotDealer's peak may not exceed it, whatever n is. The groups
    and the window follow the dealer's rules from its plans and the module's
    constants (consecutive slots merged up to GROUP_TRANCHE_BYTES; a window
    of SLOT_WINDOW slots, or one group more if that is larger)."""
    from repro_torch.core import triples as T
    sizes = [8 * p.pool_words() for p in dealer.slot_plans]
    group = run = nbytes = 0
    for b in sizes:
        if run and nbytes >= T.GROUP_TRANCHE_BYTES:
            run = nbytes = 0
        run, nbytes = run + 1, nbytes + b
        group = max(group, run)
    return (max(T.SLOT_WINDOW, group + 1) + group) * max(sizes)


def resident_bytes(res, n: int, d: int) -> int:
    """The device bytes of a dense minibatch fit that grow with n: both
    parties' encoded data (n x d words) and the assignment shares, held
    twice at the end (the last iteration's per-batch parts and their
    concatenation)."""
    c = res.assignment
    return 8 * n * d + 2 * (c.s0.nbytes + c.s1.nbytes)


def pipeline_turns(tag: str, cfg, x, da: int):
    """The minibatch fit `cfg` with pipeline on, off, off, on (in turns, so
    that what the first fits warm up, such as the pinned host blocks of
    `ring.upload`, favours neither): each held word for word to the first,
    whose kernels must all have been launched by its loop and whose labels
    must agree >= 0.98 with plaintext K-means. Returns (the first fit's
    record, its loop launches, the four online seconds, the first
    sequential fit's record)."""
    import dataclasses
    first = launches = sequential = None
    online = []
    for pipeline in (True, False, False, True):
        res, loop, _ = minibatch_fit(
            f"{tag}, batch {cfg.batch_size}, {cfg.offline}, pipeline="
            f"{pipeline})", dataclasses.replace(cfg, pipeline=pipeline),
            x[:, :da], x[:, da:])
        online.append(res.online_seconds)
        if first is None:
            agree = _agreement(res, x, cfg.k, cfg.iters, cfg.seed)
            if agree < 0.98:
                fail(f"{tag}: agreement {agree:.5f} < 0.98")
            first, launches = fit_record(res), loop
        else:
            # the pipelined executor adds the exchanges' modelled HE times
            # in another order (as the JAX package does)
            same_fit(f"{tag}) pipeline={pipeline} vs the first fit", res,
                     first, he_rel=1e-12)
            if sequential is None:
                sequential = fit_record(res)
        del res
    for name, count in launches.items():
        if count <= 0 and (cfg.sparse or name != "spmm_ell"):
            fail(f"{name} was not launched by the {tag}) loop")
    print(f"{tag}, batch {cfg.batch_size}): pipeline on and off equal word "
          f"for word; agreement with plaintext K-means {agree:.5f}; "
          f"online_seconds in turns pipelined {online[0]:.3f}, sequential "
          f"{online[1]:.3f}, sequential {online[2]:.3f}, pipelined "
          f"{online[3]:.3f}", flush=True)
    return first, launches, online, sequential


def phase_minibatch_main_path(full_per_iter: dict, full_pooled) -> tuple:
    """Phase 4c: minibatch Lloyd through the user's entry point at the
    widths of phases 4 and 4b. Dense: batch_size 25,000 pooled with
    pipeline on, off, off, on (identical), batch_size = n (equal to phase 4's
    pooled fit, with its per-iteration launches), streamed (equal to
    pooled, peak pool under the residency bound), and streamed at n =
    400,000 (3 iterations) under the same bound. Sparse: batch_size 25,000
    pooled with pipeline on, off, off, on (identical). Returns the sparse
    sequential fit's record and its loop launches (phase 7c's reference)
    and the dense pipelined fit's record (phase 8a's)."""
    import dataclasses
    from repro_torch.core.kmeans import KMeansConfig
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    xa, xb = x[:, :DA], x[:, DA:]
    cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED,
                       offline="pooled", batch_size=MB_BATCH)
    tag = f"dense minibatch (vertical, n={N}, d={DA}+{DB}, k={K}"
    pipe_rec, _, _, _ = pipeline_turns(tag, cfg, x, DA)
    one, launches, _ = minibatch_fit(
        f"{tag}, batch_size = n, pooled)",
        dataclasses.replace(cfg, batch_size=N), xa, xb)
    same_fit(f"{tag}) batch_size = n vs phase 4's pooled fit", one,
             full_pooled)
    per_iter = {n: v / one.iters_run for n, v in launches.items()}
    if per_iter != full_per_iter:
        fail(f"batch_size = n: the loop launched {per_iter} an iteration, "
             f"phase 4's pooled fit {full_per_iter}")
    print(f"{tag}): batch_size = n equals phase 4's full-batch pooled fit "
          f"word for word, with its launches per iteration {per_iter}",
          flush=True)
    del one
    streamed, _, peak100 = minibatch_fit(
        f"{tag}, batch {MB_BATCH}, streamed, pipeline)",
        dataclasses.replace(cfg, offline="streamed"), xa, xb)
    same_fit(f"{tag}) streamed vs pooled", streamed, pipe_rec)
    bound = residency_bound(streamed.dealer)
    pool100 = streamed.dealer.pool_bytes
    rest100 = peak100 - resident_bytes(streamed, N, DA + DB)
    del streamed, x, xa, xb
    if pool100 > bound:
        fail(f"streamed minibatch pool peak {pool100} B > bound {bound} B")
    if rest100 > bound:
        fail(f"streamed minibatch peak device memory less the data and "
             f"assignment {rest100} B > bound {bound} B")
    big = _blobs(np.random.default_rng(SEED + 8), MB_BIG_N, DA + DB, K)
    res, _, peak400 = minibatch_fit(
        f"dense minibatch (vertical, n={MB_BIG_N}, d={DA}+{DB}, k={K}, batch "
        f"{MB_BATCH}, streamed, pipeline)",
        dataclasses.replace(cfg, offline="streamed", iters=MB_BIG_ITERS),
        big[:, :DA], big[:, DA:])
    agree = _agreement(res, big, K, MB_BIG_ITERS, SEED)
    pool400 = res.dealer.pool_bytes
    rest400 = peak400 - resident_bytes(res, MB_BIG_N, DA + DB)
    if residency_bound(res.dealer) != bound:
        fail("the residency bound depends on n")
    print(f"streamed minibatch residency: peak pool {pool100} B at n={N}, "
          f"{pool400} B at n={MB_BIG_N}, bound (window + largest group) x "
          f"largest slot = {bound} B ({bound / 1e9:.4f} GB) at both; peak "
          f"device memory {peak100} B and {peak400} B, less the data and "
          f"assignment {rest100} B and {rest400} B; n={MB_BIG_N} agreement "
          f"with plaintext K-means {agree:.5f}", flush=True)
    if pool400 > bound:
        fail(f"n={MB_BIG_N} streamed pool peak {pool400} B > bound {bound} B")
    if rest400 > bound:
        fail(f"n={MB_BIG_N} streamed peak device memory less the data and "
             f"assignment {rest400} B > bound {bound} B")
    if agree < 0.98:
        fail(f"n={MB_BIG_N} minibatch agreement {agree:.5f} < 0.98")
    del res, big

    x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                      SP_DA + SP_DB, SP_K, SP_SPARSITY)
    cfg = KMeansConfig(k=SP_K, iters=SP_ITERS, partition="vertical",
                       seed=SP_SEED, sparse=True, offline="pooled",
                       batch_size=MB_BATCH)
    _, launches, _, sequential = pipeline_turns(
        f"sparse minibatch (vertical, n={SP_N}, d={SP_DA}+{SP_DB}, k={SP_K}",
        cfg, x, SP_DA)
    return sequential, launches, pipe_rec


# ---------------------------------------------------------------------------
# secure scoring, the TripleBank and the ScoringService (phases 3 and 6)
# ---------------------------------------------------------------------------

SC_RUNGS = (32, 128, 512)   # the ScoringService's default ladder
SC_REQUESTS = 2_000         # phase 6c: ragged requests of Poisson(48) rows
SC_SPARSE_REQUESTS = 200    # phase 6d
SC_MEAN_ROWS = 48
SC_SEED = 11
# phase 3's service requests: coalesced FIFO up to the top rung, they make
# calls at every rung of SC_RUNGS (20 -> 32; 500 -> 512; 100 -> 128;
# 450 -> 512; 600 -> 512 + 88 -> 128; 30 -> 32)
SC_SMALL_SIZES = (20, 500, 100, 450, 600, 30)
# 6c/6d's replenisher turn: a shallow bank that a BankReplenisher tops up
# while the drain runs
SC_REPL = dict(copies=8, low_water=4, high_water=16)
FRAUD_N, FRAUD_SEED = 100_000, 3   # phase 6e (examples/fraud_detection.py)
FRAUD_TOL = 0.05            # secure Jaccard within this of plaintext joint


def same_words(label: str, got, want) -> None:
    """Fail unless two share pairs (AShare, or None) hold the same words."""
    from repro_torch.core import ring
    if (got is None) != (want is None):
        fail(f"{label}: one side holds no shares")
    for i in (0, 1) if got is not None else ():
        if not np.array_equal(ring.to_u64_numpy(got[i]),
                              ring.to_u64_numpy(want[i])):
            fail(f"{label}: s{i} words differ")


def same_predict(label: str, got, want) -> None:
    """Fail unless two scoring results agree word for word: assignment and
    score shares, traffic per tag and phase."""
    same_words(f"{label} assignment", got.assignment, want.assignment)
    same_words(f"{label} scores", got.scores, want.scores)
    for phase in ("online", "offline"):
        if got.log.by_tag(phase) != want.log.by_tag(phase):
            fail(f"{label}: {phase} CommLog differs: "
                 f"{got.log.by_tag(phase)} vs {want.log.by_tag(phase)}")


def _model_on_card(cfg_kw: dict, result):
    """A GPU SecureKMeans serving `result`'s centroid shares."""
    from repro_torch.core.interop import (result_from_reference,
                                          shares_to_numpy)
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    km = SecureKMeans(KMeansConfig(**cfg_kw))
    km.result_ = result_from_reference(
        {f: shares_to_numpy(getattr(result, f))
         for f in ("centroids", "assignment")}, device="cuda")
    return km


def _requests(rng, x: np.ndarray, count: int) -> list:
    """`count` consecutive ragged row blocks of x, Poisson(SC_MEAN_ROWS)
    rows each (at least one)."""
    sizes = np.maximum(1, rng.poisson(SC_MEAN_ROWS, count))
    if sizes.sum() > x.shape[0]:
        fail(f"{count} requests need {sizes.sum()} rows, {x.shape[0]} held")
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [x[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def _turn_line(label: str, svc, st: dict, held: int, pool: int) -> str:
    """One service turn's readings (ServiceStats, the bank, memory)."""
    from repro_torch.core import sparse
    host = svc.stats.host_seconds
    pack = (f", ELL packing and upload enqueue "
            f"{sparse.ELL_PACK_SECONDS:.3f} s" if svc.model.cfg.sparse
            else "")
    return (f"{label}: {st['requests']} requests, {st['rows']} rows in "
            f"{st['launches']} calls {svc.stats.rung_calls}, drain "
            f"{st['online_seconds']:.3f} s (host prepare {host['prepare']:.3f}"
            f", launch {host['launch']:.3f}, collect {host['collect']:.3f})"
            f"{pack}, {st['rows_per_s']} rows/s, pad_overhead "
            f"{st['pad_overhead']}, p50 {st['p50_ms']} ms, p99 "
            f"{st['p99_ms']} ms, queue wait p50 {st['queue_wait_p50_ms']} ms, "
            f"replenish_events {st['replenish_events']}; offline (warm) "
            f"{svc.offline_seconds:.3f} s, bank gen_seconds "
            f"{svc.bank.gen_seconds:.3f}, provisioned pool "
            f"{pool / 1e9:.4f} GB, device memory allocated after warm "
            f"{held / 1e9:.3f} GB")


def _serve_turns(label: str, km, result, reqs: list, da: int,
                 db: int) -> tuple:
    """The ScoringService on `result` over `reqs`, six turns each from a
    fresh bank. The first and the last drain a shallow bank (SC_REPL) that
    a BankReplenisher tops up meanwhile; the first one's calls per rung
    size the `provision_copies` of the four between, pipeline on, off,
    off, on with no replenishment. Every turn's responses must equal the
    first's. Returns (the launches of the first turn without a
    replenisher, the first turn's responses)."""
    from repro_torch.core import sparse
    from repro_torch.serve import ScoringService
    first = launches = None
    copies = None
    repl = dict(low_water=SC_REPL["low_water"],
                high_water=SC_REPL["high_water"])
    drains = {}
    for turn, (pipeline, topped) in enumerate((
            (True, True), (True, False), (False, False), (False, False),
            (True, False), (True, True))):
        svc = ScoringService(km, result, d_a=da, d_b=db, rungs=SC_RUNGS,
                             provision_copies=SC_REPL["copies"] if topped
                             else copies, pipeline=pipeline,
                             replenisher=repl if topped else None)
        svc.warm()
        torch.cuda.synchronize()
        pool, held = svc.bank.pool_bytes, torch.cuda.memory_allocated()
        for x in reqs:
            svc.submit(x[:, :da], x[:, da:])
        _zero_launch_counters()
        sparse.ELL_PACK_SECONDS = 0.0
        out = svc.drain()
        counted = _launch_counters()
        st = svc.stats.as_dict()
        name = (f"{label} turn {turn} (pipeline={pipeline}, "
                + ("BankReplenisher)" if topped else "no replenishment)"))
        line = _turn_line(name, svc, st, held, pool)
        svc.close()
        if st["failed_requests"] or st["requests"] != len(reqs):
            fail(f"{name}: {st}")
        if topped:
            r = svc.replenisher
            if r.errors or not r.topups:
                fail(f"{name}: the replenisher made {r.topups} top-ups, "
                     f"{r.errors} errors ({r.last_error!r})")
            line += (f"; replenisher {r.topups} top-ups of "
                     f"{r.topup_copies} calls in {r.topup_seconds:.3f} s")
            if first is None:
                first = out
                copies = max(svc.stats.rung_calls.values())
        else:
            if st["replenish_events"]:
                fail(f"{name}: {st['replenish_events']} replenishments "
                     f"with provision_copies {copies}")
            if launches is None:
                launches = counted
        for a, b in zip(out, first):
            if a.request_id != b.request_id \
                    or not np.array_equal(a.labels, b.labels) \
                    or not np.array_equal(a.scores, b.scores):
                fail(f"{name}: request {a.request_id} differs from turn 0")
        drains[turn] = st["online_seconds"]
        print(f"{line}; launches {counted}", flush=True)
        del svc
    print(f"{label}: the six turns answered every request identically; "
          f"drains with a BankReplenisher topping up {drains[0]:.3f} and "
          f"{drains[5]:.3f} s, without one (pipeline on, provision_copies "
          f"{copies}) {drains[1]:.3f} and {drains[4]:.3f} s", flush=True)
    return launches, first


def phase_scoring_gpu_equals_cpu():
    """Phase 3's scoring checks: predict and score on the card (program
    and eager), both partitions, dense and sparse, equal the CPU's word for
    word; a bank-fed full-batch and minibatch fit on the card equal the CPU
    ones; a ScoringService drain on the card, pipeline on and off, answers
    as the CPU one does."""
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.core.triples import TripleBank, TrustedDealer
    from repro_torch.serve import ScoringService
    dense = _blobs(np.random.default_rng(1), 2048, DA + DB, K)
    sp = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, SP_K,
                       SP_SPARSITY)
    for name, x, da, k, sparse in (("dense", dense, DA, K, False),
                                   ("sparse", sp, SP_DA, SP_K, True)):
        for part in ("vertical", "horizontal"):
            xa, xb = (x[:1500, :da], x[:1500, da:]) if part == "vertical" \
                else (x[:800], x[800:1500])
            qa, qb = (x[1500:, :da], x[1500:, da:]) if part == "vertical" \
                else (x[1500:1800], x[1800:])
            kw = dict(k=k, iters=2, partition=part, seed=3, sparse=sparse)
            cpu = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                            **kw))
            res = cpu.fit(xa, xb)
            gpu = _model_on_card(kw, res)
            for method in ("score", "predict"):
                for compiled in (True, False):
                    dg = TrustedDealer(seed=7, device="cuda")
                    dc = TrustedDealer(seed=7)
                    label = (f"{name} {part} {method} compiled={compiled}, "
                             f"GPU vs CPU")
                    same_predict(label, getattr(gpu, method)(
                        qa, qb, compiled=compiled, dealer=dg),
                        getattr(cpu, method)(qa, qb, compiled=compiled,
                                             dealer=dc))
                    counters = [(d.n_matmul, d.n_mul, d.n_bin,
                                 d.log.by_tag("offline")) for d in (dg, dc)]
                    if counters[0] != counters[1]:
                        fail(f"{label}: dealer counters {counters}")
            same_predict(f"{name} {part} score, default dealer, GPU vs CPU",
                         gpu.score(qa, qb), cpu.score(qa, qb))
            print(f"GPU scoring = CPU scoring ({name} {part}, {len(qa)}+"
                  f"{len(qb) if part == 'horizontal' else 0} rows, k={k}): "
                  f"predict and score, program and eager, share words, "
                  f"dealer counters and traffic equal", flush=True)
            for batch_size in (None, 700):
                fits = {}
                for dev, extra in (("cuda", {}), ("cpu", dict(
                        backend="torch", device="cpu"))):
                    km = SecureKMeans(KMeansConfig(
                        offline="pooled", batch_size=batch_size, **kw,
                        **extra))
                    key, plan, _ = km.plan_fit(xa.shape, xb.shape)
                    bank = TripleBank(seed=3, device=dev)
                    bank.provision(key, plan, workers=2)
                    fits[dev] = km.fit(xa, xb, dealer=bank.dealer(key))
                same_fit(f"{name} {part} bank-fed fit batch_size="
                         f"{batch_size}, GPU vs CPU", fits["cuda"],
                         fits["cpu"])
                del fits
            print(f"GPU bank-fed fit = CPU bank-fed fit ({name} {part}, "
                  f"full batch and batch_size 700)", flush=True)
            if part != "vertical":
                continue
            bounds = np.cumsum((0,) + SC_SMALL_SIZES)
            for pipeline in (True, False):
                outs, calls = [], []
                for model in (gpu, cpu):
                    svc = ScoringService(model, d_a=da, d_b=x.shape[1] - da,
                                         rungs=SC_RUNGS, pipeline=pipeline,
                                         provision_copies=3)
                    for lo, hi in zip(bounds[:-1], bounds[1:]):
                        svc.submit(x[lo:hi, :da], x[lo:hi, da:])
                    outs.append(svc.drain())
                    calls.append(svc.stats.rung_calls)
                if calls[0] != calls[1] or sorted(calls[0]) != list(SC_RUNGS):
                    fail(f"{name} service pipeline={pipeline}: calls per "
                         f"rung {calls[0]} on the card, {calls[1]} on the "
                         f"CPU; every rung of {SC_RUNGS} must be called")
                for a, b in zip(*outs):
                    if a.error is not None or b.error is not None \
                            or not np.array_equal(a.labels, b.labels) \
                            or not np.array_equal(a.scores, b.scores):
                        fail(f"{name} service pipeline={pipeline}: request "
                             f"{a.request_id} differs between GPU and CPU")
            print(f"GPU ScoringService = CPU ScoringService ({name} vertical, "
                  f"requests of {SC_SMALL_SIZES} rows, calls per rung "
                  f"{calls[0]}, pipeline on and off)", flush=True)


TRUNC_F = 20               # ring.F: the fixed-point scale of the scores


def phase_numpy_backend(smi_line: str) -> None:
    """Phase 3's dense and sparse vertical fits (n=2048, 2 iterations) on
    the host ring backend (backend="numpy", device="cpu") held word for
    word to the card's fits (backend="cuda", on demand): share words,
    dealer counters, CommLog per tag and phase, he_seconds. Prints each
    fit's wall and loop seconds: at n=2048 both fits are bound by launches
    and Python, so the seconds are a record, not a comparison."""
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    dense = _blobs(np.random.default_rng(1), 2048, DA + DB, K)
    sp = _one_hot_like(np.random.default_rng(4), 2048, SP_DA + SP_DB, SP_K,
                       SP_SPARSITY)
    for name, x, da, k, sparse in (("dense", dense, DA, K, False),
                                   ("sparse", sp, SP_DA, SP_K, True)):
        kw = dict(k=k, iters=2, partition="vertical", seed=3, sparse=sparse)
        fits, walls = {}, {}
        for backend, device in (("cuda", "cuda"), ("numpy", "cpu")):
            t0 = time.perf_counter()
            fits[backend] = SecureKMeans(KMeansConfig(
                backend=backend, device=device, **kw)).fit(x[:, :da],
                                                           x[:, da:])
            torch.cuda.synchronize()
            walls[backend] = time.perf_counter() - t0
        label = f"numpy backend, {name} vertical, n=2048, k={k}, 2 iters"
        same_fit(label, fits["numpy"], fits["cuda"])
        n, g = fits["numpy"], fits["cuda"]
        print(f"{label}: host fit = card fit in share words, dealer "
              f"counters (matmul {n.dealer.n_matmul}, mul {n.dealer.n_mul}, "
              f"bin {n.dealer.n_bin}), traffic per tag and he_seconds "
              f"({n.he_seconds!r}); numpy fit {walls['numpy']:.3f} s (loop "
              f"{n.loop_seconds:.3f} s), cuda fit {walls['cuda']:.3f} s "
              f"(loop {g.loop_seconds:.3f} s) | {smi_line}", flush=True)


def truncation_check(x, mu, labels, scores) -> dict:
    """One scoring call against plaintext. The distances D' = ||mu||^2 -
    2 x.mu are truncated from scale 2f to f by the two parties locally
    (SecureML), which fails with probability |D'| 2^(2f) / 2^64 an
    element, moving the value by a multiple of 2^(64-2f) = 2^24. A loser
    wrapped down takes the label and shows in the score; the winner
    wrapped down shows in the score; the winner wrapped up hands the
    label to the runner-up, whose score is right: a mislabel with no
    visible wrap. Labels are counted where the nearest centroid wins by
    more than 1e-6. Returns the counts and the expected wraps of all
    elements and of the winners alone."""
    dist = ((x[:, None, :] - mu[None]) ** 2).sum(2)
    part = np.partition(dist, 1, axis=1)
    clear = part[:, 1] - part[:, 0] > 1e-6
    nearest = dist.argmin(1)
    wrong = clear & (labels != nearest)
    err = scores - dist[np.arange(len(x)), labels]
    wrap = 2.0 ** (64 - 2 * TRUNC_F)
    k = np.round(err / wrap)
    wrapped = (k != 0) & (np.abs(err - k * wrap) <= 1e-3)
    p_wrap = np.abs((mu ** 2).sum(1)[None] - 2 * x @ mu.T) \
        * 2.0 ** (2 * TRUNC_F - 64)
    return dict(wrong=int(wrong.sum()), wrapped=int(wrapped.sum()),
                other=int((~wrapped & (np.abs(err) > 1e-3)).sum()),
                hit=int((wrong | wrapped).sum()),
                silent=int((wrong & ~wrapped).sum()),
                expected=float(p_wrap.sum()),
                expected_winner=float(p_wrap[np.arange(len(x)),
                                             nearest].sum()))


def poisson_limit(mean: float) -> float:
    """A count of rare independent events with this mean exceeds this
    limit with odds of 1e-3 or less (Poisson tail, means up to ~500)."""
    return mean + 3 * mean ** 0.5 + 3


def phase_scoring(full_per_iter: dict, full_pooled, sp_pooled) -> dict:
    """Phase 6, the paper's Sec 5.6 serving deployment at phase 4's widths:
    6a the bank-fed fit, 6b bulk scoring of n = 100,000, 6c the
    ScoringService over 2,000 ragged requests, 6d the sparse service, 6e
    the fraud pipeline. Returns the scoring path's launches per kernel
    (6b's bank-fed call, 6c's and 6d's first drains, each counted around
    itself)."""
    from repro_torch.core.fraud import (FraudDataset, run_plaintext_fraud,
                                        run_secure_fraud)
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.core.triples import TripleBank, serve_seed
    from repro_torch.launch import kmeans_step as KS
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    xa, xb = x[:, :DA], x[:, DA:]
    cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED,
                       offline="pooled")
    km = SecureKMeans(cfg)
    tag = f"(vertical, n={N}, d={DA}+{DB}, k={K})"

    # 6a: plan_fit -> provision -> fit(dealer=bank.dealer(key))
    _cold_caches()
    t0 = time.perf_counter()
    key, plan, _ = km.plan_fit(xa.shape, xb.shape)
    KS.fit_programs("vertical", False, xa.shape, xb.shape, K,
                    backend=cfg.backend, device=cfg.device)
    plan_s = time.perf_counter() - t0
    bank = TripleBank(seed=SEED)
    bank.provision(key, plan)
    torch.cuda.synchronize()
    pool, held = bank.pool_bytes, torch.cuda.memory_allocated()
    _zero_launch_counters()
    res = km.fit(xa, xb, dealer=bank.dealer(key))
    loop = _launch_counters()
    # the fit's offline traffic is on the bank's books
    books = fit_record(res)
    books.log = res.log.copy()
    books.log.merge(bank.log, phase="offline")
    same_fit(f"6a bank-fed fit {tag} vs phase 4's pooled fit", books,
             full_pooled)
    per_iter = {n: v / res.iters_run for n, v in loop.items()}
    if per_iter != full_per_iter:
        fail(f"6a: the bank-fed loop launched {per_iter} an iteration, "
             f"phase 4's pooled fit {full_per_iter}")
    if bank.served_requests != len(plan) or bank.replenish_events:
        fail(f"6a: the bank served {bank.served_requests} of {len(plan)} "
             f"requests, {bank.replenish_events} replenishments")
    print(f"6a bank-fed fit {tag}: equal to phase 4's pooled fit word for "
          f"word; plan_fit and program recording {plan_s:.3f} s, bank "
          f"gen_seconds {bank.gen_seconds:.3f}, pool {pool / 1e9:.3f} GB "
          f"(device memory allocated {held / 1e9:.3f} GB), loop_seconds "
          f"{res.loop_seconds:.3f}, online_seconds {res.online_seconds:.3f}, "
          f"kernels per iteration {per_iter} = phase 4's", flush=True)
    del bank
    torch.cuda.empty_cache()

    # 6b: one scoring call over all n rows, on demand and from a bank
    km.plan_predict(xa.shape, xb.shape, True)
    KS.predict_program("vertical", False, xa.shape, xb.shape, K,
                       with_scores=True, backend=cfg.backend,
                       device=cfg.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_demand = km.score(xa, xb, res)
    od_s = time.perf_counter() - t0
    key, plan, _ = km.plan_predict(xa.shape, xb.shape, True)
    bank = TripleBank(seed=serve_seed(SEED))
    t0 = time.perf_counter()
    bank.provision(key, plan)
    torch.cuda.synchronize()
    prov_s = time.perf_counter() - t0
    pool = bank.pool_bytes
    _zero_launch_counters()
    t0 = time.perf_counter()
    banked = km.score(xa, xb, res, dealer=bank.dealer(key))
    bank_s = time.perf_counter() - t0
    launches = _launch_counters()
    same_words("6b banked vs on-demand assignment", banked.assignment,
               on_demand.assignment)
    same_words("6b banked vs on-demand scores", banked.scores,
               on_demand.scores)
    tc = truncation_check(x, res.centroids_plain(), banked.labels_plain(),
                          banked.scores_plain())
    print(f"6b bulk scoring {tag}: one program call on demand "
          f"{od_s:.3f} s (dealer included), from a bank {bank_s:.3f} s "
          f"(provisioned in {prov_s:.3f} s, {pool / 1e9:.3f} GB); the same "
          f"words; rows whose label is not the nearest revealed centroid "
          f"(margin > 1e-6): {tc['wrong']}, {tc['silent']} of them with no "
          f"visible wrap ({tc['expected_winner']:.2f} winner wraps "
          f"expected, limit {poisson_limit(tc['expected_winner']):.2f}); "
          f"scores off the plaintext squared distance by more than 1e-3: "
          f"{tc['wrapped']} by a multiple of 2^{64 - 2 * TRUNC_F} (a "
          f"local-truncation wrap), {tc['other']} otherwise; {tc['hit']} "
          f"rows with either ({tc['expected']:.2f} wraps expected from the "
          f"distances, limit {poisson_limit(tc['expected']):.2f}); "
          f"launches {launches}", flush=True)
    if tc["other"]:
        fail(f"6b: {tc['other']} scores are off by more than 1e-3 and not "
             f"by a truncation wrap")
    if tc["silent"] > poisson_limit(tc["expected_winner"]):
        fail(f"6b: {tc['silent']} mislabels with no visible wrap, "
             f"{tc['expected_winner']:.2f} winner wraps expected")
    if tc["hit"] > poisson_limit(tc["expected"]):
        fail(f"6b: {tc['hit']} rows with a wrong label or a wrapped score, "
             f"{tc['expected']:.2f} wraps expected")
    if launches["ring_matmul"] <= 0 or launches["ks_carry_share"] <= 0:
        fail(f"6b: the scoring call launched {launches}")
    del bank, on_demand, banked
    torch.cuda.empty_cache()

    # 6c: the ScoringService over 2,000 ragged requests
    reqs = _requests(np.random.default_rng(SC_SEED), x, SC_REQUESTS)
    print(f"6c ScoringService {tag}: ladder {SC_RUNGS}, {len(reqs)} requests "
          f"of Poisson({SC_MEAN_ROWS}) rows (seed {SC_SEED}), "
          f"{sum(len(r) for r in reqs)} rows", flush=True)
    svc_launches, _ = _serve_turns("6c service", km, res, reqs, DA, DB)
    for name in ("ring_matmul", "ks_carry_share"):
        launches[name] += svc_launches[name]
        if svc_launches[name] <= 0:
            fail(f"6c: {name} was not launched by the drain")
    del res, reqs, x, xa, xb
    torch.cuda.empty_cache()

    # 6d: the sparse service on phase 4b's model
    sx = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                       SP_DA + SP_DB, SP_K, SP_SPARSITY)
    skm = SecureKMeans(KMeansConfig(k=SP_K, iters=SP_ITERS,
                                    partition="vertical", seed=SP_SEED,
                                    sparse=True))
    reqs = _requests(np.random.default_rng(SC_SEED), sx, SC_SPARSE_REQUESTS)
    sp_launches, _ = _serve_turns(
        f"6d sparse service (vertical, d={SP_DA}+{SP_DB}, k={SP_K})", skm,
        sp_pooled, reqs, SP_DA, SP_DB)
    if sp_launches["spmm_ell"] <= 0:
        fail("6d: spmm_ell was not launched by the sparse drain")
    for name, v in sp_launches.items():
        launches[name] += v
    del sx, reqs
    torch.cuda.empty_cache()

    # 6e: the fraud pipeline
    ds = FraudDataset.synthesize(n=FRAUD_N, d_a=DA, d_b=DB, n_clusters=K,
                                 frac_outlier=0.02, seed=FRAUD_SEED)
    t0 = time.perf_counter()
    j_sec, fres = run_secure_fraud(ds, k=K, iters=ITERS, seed=FRAUD_SEED,
                                   offline="pooled")
    sec_s = time.perf_counter() - t0
    j_plain = run_plaintext_fraud(ds, k=K, iters=ITERS, seed=FRAUD_SEED)
    j_single = run_plaintext_fraud(ds, k=K, iters=ITERS, seed=FRAUD_SEED,
                                   party_a_only=True)
    print(f"6e fraud (n={FRAUD_N}, d={DA}+{DB}, k={K}, 2 % planted, seed "
          f"{FRAUD_SEED}): Jaccard secure joint {j_sec:.4f}, plaintext joint "
          f"{j_plain:.4f}, payment-company only {j_single:.4f} (the paper "
          f"reports 0.86, 0.83 and 0.62 on its data); secure fit and scoring "
          f"{sec_s:.3f} s (fit loop {fres.loop_seconds:.3f} s)", flush=True)
    if abs(j_sec - j_plain) > FRAUD_TOL:
        fail(f"6e: secure Jaccard {j_sec:.4f} is more than {FRAUD_TOL} from "
             f"the plaintext joint {j_plain:.4f}")
    print(f"scoring path launches (6b's bank-fed call and the first drains "
          f"of 6c and 6d): {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: checkpointed and resumed fits, the two-party wire, crash-safe
# scoring
# ---------------------------------------------------------------------------

# 7a/7b: `python -m repro_torch.launch.two_party` at the fraud deployment's
# width (d = 42 split 21 + 21 by the launcher, k = 5, 10 iterations)
TP_N, TP_D, TP_K, TP_ITERS, TP_SEED = 100_000, 42, 5, 10, 5
TP_DIE_AT = 4               # 7b: A dies after this iteration's checkpoint
TP_KEY = "phase-7b"         # 7b: keyed frames
TP_FAULTS = ("--fault-drop", "0.01", "--fault-dup", "0.01",
             "--fault-corrupt", "0.01")
CK_STOP_AFTER = 6           # 7c: published steps before the stop
SV_REQUESTS = 200           # 7d: Poisson(48)-row requests over the wire
SV_CRASH_AT = 100           # 7d: the server dies after this many journaled
SV_COPIES = 16              # 7d: provisioned calls per rung
SV_KEY = "phase-7d"
PHASE7_DIR = ROOT / "build" / "phase7"     # ignored; removed at the end


class _SmokeStop(Exception):
    """Raised from a checkpointer's after_save seam: the fit stops there."""


def _src_env(src: pathlib.Path) -> dict:
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(src) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    return env


def _two_party(src: pathlib.Path, args_a: list, args_b: list = (),
               b_wait: float = 120.0) -> dict:
    """Party A (`--device cuda`) and party B as two processes over TCP on
    127.0.0.1. Returns their exit codes and outputs and A's wall seconds;
    B is stopped once A has exited and `b_wait` has passed."""
    cmd = [sys.executable, "-m", "repro_torch.launch.two_party"]
    env = _src_env(src)
    t0 = time.perf_counter()
    a = subprocess.Popen(cmd + ["--role", "A", "--port", "0", "--device",
                                "cuda", *args_a], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    b = None
    try:
        line = a.stdout.readline()
        if not line.startswith("LISTENING "):
            fail(f"party A did not listen: {line}{a.stdout.read()}")
        b = subprocess.Popen(cmd + ["--role", "B", "--port",
                                    line.split()[1], *args_b],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
        a_out = line + a.communicate(timeout=600)[0]
        wall = time.perf_counter() - t0
        try:
            b_out = b.communicate(timeout=b_wait)[0]
        except subprocess.TimeoutExpired:
            b.kill()
            b_out = b.communicate()[0]
    finally:
        for p in (a, b):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return {"rc_a": a.returncode, "a": a_out, "rc_b": b.returncode,
            "b": b_out, "wall": wall}


def _wire_stats(out: str, role: str) -> dict:
    for line in out.splitlines():
        if line.startswith("WIRE_STATS "):
            d = json.loads(line[len("WIRE_STATS "):])
            if d.get("role") == role:
                return d
    fail(f"party {role} printed no WIRE_STATS line:\n{out[-2000:]}")


def _party_out(path: pathlib.Path) -> tuple:
    z = np.load(path)
    return {k: z[k] for k in z.files if k != "meta"}, \
        json.loads(bytes(z["meta"]))


def _same_out(label: str, out: dict, meta: dict, want) -> None:
    """Fail unless a two-party `--out` holds `want`'s fit words, dealer
    counters and traffic per tag and phase."""
    from repro_torch.core import ring
    for key, share in (("mu0", want.centroids.s0), ("mu1", want.centroids.s1),
                       ("c0", want.assignment.s0), ("c1", want.assignment.s1)):
        if not np.array_equal(out[key], ring.to_u64_numpy(share)):
            fail(f"{label}: {key} words differ")
    d = want.dealer
    counters = {a: int(getattr(d, a)) for a in ("n_matmul", "n_mul", "n_bin")}
    if meta["counters"] != counters:
        fail(f"{label}: dealer counters {meta['counters']} vs {counters}")
    for phase in ("online", "offline"):
        tags = {t: [int(v[0]), int(v[1])]
                for t, v in want.log.by_tag(phase).items()}
        if meta[f"fit_{phase}"] != tags:
            fail(f"{label}: {phase} CommLog {meta[f'fit_{phase}']} vs {tags}")
    if meta["iters_run"] != want.iters_run:
        fail(f"{label}: {meta['iters_run']} iterations vs {want.iters_run}")


def phase_two_party(src: pathlib.Path) -> dict:
    """7a: the fit between two processes over TCP, A on the card and B a
    wire peer on the CPU, held word for word to the in-process fit on the
    card; the wire's payload equals the CommLog's online traffic; B never
    initialized CUDA; A's loop launched what the in-process loop did.
    7b: A killed after iteration 4's checkpoint, then resumed against a
    fresh B under seeded drops, duplicates and corruption with keyed
    frames: the words of an uninterrupted pooled fit. Returns the launches
    of A's two fits (7a's and 7b's resumed)."""
    import dataclasses
    from repro_torch.checkpoint.fit import FitCheckpointer
    from repro_torch.core import faultpoints
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.launch import kmeans_step as KS
    from repro_torch.launch import two_party
    x = two_party.make_data(TP_N, TP_D, TP_K, TP_SEED)
    xa, xb = two_party.split_data(x, "vertical")
    tag = (f"(vertical, n={TP_N}, d={xa.shape[1]}+{xb.shape[1]}, k={TP_K}, "
           f"{TP_ITERS} iters, seed {TP_SEED})")
    cfg = KMeansConfig(k=TP_K, iters=TP_ITERS, seed=TP_SEED,
                       partition="vertical")
    _cold_caches()
    _zero_launch_counters()
    ref = SecureKMeans(cfg).fit(xa, xb)
    ref_launches = _launch_counters()
    ref_rec = fit_record(ref)
    online_b = ref.log.total_bytes("online")
    online_r = ref.log.total_rounds("online")
    del ref
    common = ["--n", str(TP_N), "--d", str(TP_D), "--k", str(TP_K),
              "--iters", str(TP_ITERS), "--seed", str(TP_SEED)]

    # 7a
    out = PHASE7_DIR / "7a.npz"
    run = _two_party(src, common + ["--out", str(out)])
    if run["rc_a"] != 0 or run["rc_b"] != 0:
        fail(f"7a: party A exit {run['rc_a']}, B {run['rc_b']}:\n"
             f"{run['a'][-3000:]}\n{run['b'][-3000:]}")
    words, meta = _party_out(out)
    _same_out("7a two-party fit vs the in-process fit", words, meta, ref_rec)
    b_stats = _wire_stats(run["b"], "B")
    if b_stats["cuda_initialized"]:
        fail("7a: party B initialized CUDA")
    if (meta["fit_wire_payload_bytes"], meta["fit_wire_rounds"]) \
            != (online_b, online_r):
        fail(f"7a: the wire carried {meta['fit_wire_payload_bytes']} B in "
             f"{meta['fit_wire_rounds']} rounds, the CommLog's online "
             f"traffic is {online_b} B in {online_r} rounds")
    if meta["fit_launches"] != ref_launches:
        fail(f"7a: A's fit launched {meta['fit_launches']}, the in-process "
             f"fit {ref_launches}")
    per_iter = {n: v / TP_ITERS for n, v in ref_launches.items()}
    frames = meta["wire_bytes_sent"] + meta["wire_bytes_recv"]
    print(f"7a two-party fit {tag}: A on the card, B a CPU wire peer "
          f"(CUDA never initialized); equal to the in-process fit word for "
          f"word (shares, dealer counters, CommLog per tag and phase); A's "
          f"wall {run['wall']:.3f} s, fit {meta['fit_seconds']:.3f} s; the "
          f"fit's online traffic {online_b / 2 ** 20:.2f} MB in {online_r} "
          f"rounds = the wire's payload; frames A->B "
          f"{meta['wire_bytes_sent']} B, B->A {meta['wire_bytes_recv']} B "
          f"(the fit, B's slice and a predict); the fit's payload at "
          f"{online_b / 2 ** 20 / meta['fit_seconds']:.1f} MB/s, all "
          f"frames {frames / 2 ** 20 / meta['fit_seconds']:.1f} MB/s over "
          f"the fit's seconds; kernels per iteration {per_iter} = the "
          f"in-process fit's; retries {meta['retries']}", flush=True)

    # 7b
    ck = PHASE7_DIR / "7b_ck"
    pooled = common + ["--offline", "pooled", "--checkpoint-dir", str(ck)]
    die = _two_party(src, pooled + ["--die-at-iter", str(TP_DIE_AT)],
                     b_wait=0.5)
    if die["rc_a"] != faultpoints.KILL_EXIT_CODE or "DYING" not in die["a"]:
        fail(f"7b: party A exit {die['rc_a']}, want "
             f"{faultpoints.KILL_EXIT_CODE} after DYING:\n{die['a'][-3000:]}")
    steps = FitCheckpointer(str(ck)).all_steps()
    if not steps or steps[-1] != TP_DIE_AT * 1_000_000:
        fail(f"7b: published steps {steps}, want the last at iteration "
             f"{TP_DIE_AT}")
    out = PHASE7_DIR / "7b.npz"
    run = _two_party(src, pooled + ["--resume", "--out", str(out),
                                    "--auth-key", TP_KEY, *TP_FAULTS],
                     ["--auth-key", TP_KEY, "--fault-seed", "1",
                      *TP_FAULTS])
    if run["rc_a"] != 0 or run["rc_b"] != 0:
        fail(f"7b: resumed party A exit {run['rc_a']}, B {run['rc_b']}:\n"
             f"{run['a'][-3000:]}\n{run['b'][-3000:]}")
    pcfg = dataclasses.replace(cfg, offline="pooled")
    _cold_caches()
    full = SecureKMeans(pcfg).fit(xa, xb)
    same_fit(f"7b uninterrupted pooled fit {tag} vs on demand", full,
             ref_rec)
    full_rec = fit_record(full)
    del full
    torch.cuda.empty_cache()
    words, rmeta = _party_out(out)
    _same_out("7b resumed two-party fit vs the uninterrupted pooled fit",
              words, rmeta, full_rec)
    words_7a = _party_out(PHASE7_DIR / "7a.npz")[0]
    for key in ("mu0", "mu1", "c0", "c1"):
        if not np.array_equal(words[key], words_7a[key]):
            fail(f"7b: {key} differs from 7a's")
    # the resumed A planned (trace and program recording) from cold caches
    _cold_caches()
    _zero_launch_counters()
    SecureKMeans(pcfg).plan_offline(xa.shape, xb.shape)
    KS.fit_programs("vertical", False, xa.shape, xb.shape, TP_K,
                    backend=pcfg.backend, device=pcfg.device)
    torch.cuda.synchronize()
    planning = _launch_counters()
    _cold_caches()
    loop = {n: rmeta["fit_launches"][n] - planning[n] for n in planning}
    want = {n: v * (TP_ITERS - TP_DIE_AT) for n, v in per_iter.items()}
    if loop != want:
        fail(f"7b: the resumed loop launched {loop}, {TP_ITERS - TP_DIE_AT} "
             f"iterations of the uninterrupted loop are {want}")
    bs = _wire_stats(run["b"], "B")
    print(f"7b kill and resume {tag}: A died after iteration {TP_DIE_AT}'s "
          f"checkpoint (exit {die['rc_a']}, A's wall {die['wall']:.3f} s); "
          f"resumed against a fresh B under drops, duplicates and "
          f"corruption of 1 % each way with keyed frames, it ends equal "
          f"word for word to an uninterrupted pooled fit on the card (and "
          f"to 7a); the resumed A's wall {run['wall']:.3f} s, fit "
          f"{rmeta['fit_seconds']:.3f} s, of which the dealer's restart "
          f"(planning and the pool regenerated past iteration {TP_DIE_AT}) "
          f"{rmeta['offline_dealer_seconds']:.3f} s (plan "
          f"{rmeta['offline_plan_seconds']:.3f} s); A's retries "
          f"{rmeta['retries']}, B served {bs['served']} requests; the "
          f"resumed loop launched {loop} = {TP_ITERS - TP_DIE_AT} "
          f"iterations of the uninterrupted loop (planning {planning})",
          flush=True)
    return {n: meta["fit_launches"][n] + rmeta["fit_launches"][n]
            for n in planning}


def phase_resume_sparse_minibatch(want, want_launches: dict) -> dict:
    """7c: phase 4c's sparse minibatch fit (sequential executor) with a
    checkpoint after every batch, stopped from `after_save` after its 6th
    published step, mid-iteration; resumed, it ends with the uninterrupted
    fit's words, counters and traffic, and the two runs' loops launch what
    the uninterrupted loop did. Returns the two runs' launches."""
    import shutil
    from repro_torch.checkpoint.fit import FitCheckpointer
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                      SP_DA + SP_DB, SP_K, SP_SPARSITY)
    xa, xb = x[:, :SP_DA], x[:, SP_DA:]
    cfg = KMeansConfig(k=SP_K, iters=SP_ITERS, partition="vertical",
                       seed=SP_SEED, sparse=True, offline="pooled",
                       batch_size=MB_BATCH, pipeline=False)
    tag = (f"(vertical, n={SP_N}, d={SP_DA}+{SP_DB}, k={SP_K}, batch "
           f"{MB_BATCH}, pooled, pipeline=False)")
    planning = _minibatch_planning_launches(cfg, xa.shape, xb.shape)
    d = PHASE7_DIR / "7c_ck"
    shutil.rmtree(d, ignore_errors=True)
    saved = []

    def stop(state, _path):
        saved.append(state.step)
        if len(saved) == CK_STOP_AFTER:
            raise _SmokeStop

    _cold_caches()
    _zero_launch_counters()
    t0 = time.perf_counter()
    try:
        SecureKMeans(cfg).fit(xa, xb, checkpoint=FitCheckpointer(
            str(d), every=1, batch_every=1, after_save=stop))
        fail("7c: the fit did not stop")
    except _SmokeStop:
        pass
    killed_s = time.perf_counter() - t0
    killed = {n: v - planning[n] for n, v in _launch_counters().items()}
    cut = saved[-1]
    if cut % 1_000_000 == 0:
        fail(f"7c: the stop at step {cut} is not mid-iteration")
    _cold_caches()
    _zero_launch_counters()
    t0 = time.perf_counter()
    res = SecureKMeans(cfg).fit(xa, xb, checkpoint=FitCheckpointer(str(d)),
                                resume=True)
    resumed_s = time.perf_counter() - t0
    resumed = {n: v - planning[n] for n, v in _launch_counters().items()}
    # neither package's checkpoint holds he_seconds: the resumed fit counts
    # the exchanges it ran (held to the JAX package's resume in the tests)
    same_fit(f"7c resumed sparse minibatch fit {tag} vs uninterrupted", res,
             want, he_rel=float("inf"))
    if not 0.0 < res.he_seconds < want.he_seconds:
        fail(f"7c: resumed he_seconds {res.he_seconds!r}, uninterrupted "
             f"{want.he_seconds!r}")
    both = {n: killed[n] + resumed[n] for n in killed}
    if both != want_launches:
        fail(f"7c: the stopped and the resumed loop launched {killed} + "
             f"{resumed}, the uninterrupted loop {want_launches}")
    print(f"7c mid-iteration resume {tag}: stopped after published step "
          f"{cut} (iteration {cut // 1_000_000}, batch {cut % 1_000_000}; "
          f"steps {saved}); the resumed fit equals the uninterrupted one "
          f"word for word (shares, dealer counters, CommLog per tag and "
          f"phase); stopped run {killed_s:.3f} s, resumed run "
          f"{resumed_s:.3f} s (loop {res.loop_seconds:.3f} s); he_seconds "
          f"of the resumed run's exchanges {res.he_seconds:.3f} of "
          f"{want.he_seconds:.3f}; loops launched {killed} + {resumed} = "
          f"the uninterrupted loop's {want_launches}", flush=True)
    return both


def _start_server(src: pathlib.Path, d: pathlib.Path, port: int,
                  die_after: int) -> tuple:
    """Start phase 7d's scoring server process; returns (process, its
    SERVING line's dict, seconds from spawn to serving)."""
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--scoring-server",
         str(d), str(port), str(die_after), "--src", str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_src_env(src))
    lines = []
    for line in p.stdout:
        lines.append(line)
        if line.startswith("SERVING "):
            info = json.loads(line[len("SERVING "):])
            return p, info, time.perf_counter() - t0
    p.wait()
    fail(f"7d: the scoring server exited {p.returncode} before serving:\n"
         + "".join(lines)[-3000:])


def _finish(p, timeout: float = 120.0) -> str:
    try:
        return p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        fail("7d: the scoring server did not exit")


def _json_after(out: str, prefix: str) -> dict:
    for line in out.splitlines():
        if line.startswith(prefix):
            return json.loads(line[len(prefix):])
    fail(f"7d: no {prefix.strip()} line in:\n{out[-3000:]}")


def phase_serve_crash(src: pathlib.Path, model) -> dict:
    """7d: a `ScoringServer` on a `SocketTransport`, in front of a
    `ScoringService` of phase 6's dense model (ladder 32, 128, 512) with a
    `ServeCheckpointer`, in a process of its own on the card. A
    `ScoringClient` sends 200 Poisson(48)-row requests (seed 11) through a
    `FaultyTransport` (seeded drop, dup and corrupt; keyed frames). The
    server dies (os._exit) after its 100th journaled response; a new one
    starts from the same checkpoint directory on the same port, and the
    client's retries of the same rid finish the run. Every response equals
    an uninterrupted in-process service's, no rid is scored twice, and the
    bank's consumed counts end as the uninterrupted run's. Returns the two
    servers' launches."""
    import dataclasses
    import shutil
    from repro_torch.checkpoint.serve import ServeCheckpointer
    from repro_torch.core import channel as C
    from repro_torch.core import faultpoints, ring
    from repro_torch.serve import ScoringClient, ScoringService
    d = PHASE7_DIR / "7d"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    np.savez(d / "model.npz",
             **{f"{f[0]}{i}": ring.to_u64_numpy(getattr(model, f)[i])
                for f in ("centroids", "assignment") for i in (0, 1)})
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    reqs = _requests(np.random.default_rng(SC_SEED), x, SV_REQUESTS)
    rows = sum(len(r) for r in reqs)
    del x
    km = _model_on_card(dict(k=K, iters=ITERS, partition="vertical",
                             seed=SEED), model)
    ref_svc = ScoringService(km, km.result_, d_a=DA, d_b=DB, rungs=SC_RUNGS,
                             provision_copies=SV_COPIES)
    ref = {}
    for q in reqs:                 # the wire server's schedule: one at a time
        ref_svc.submit(q[:, :DA], q[:, DA:])
        ref.update({r.request_id: r for r in ref_svc.drain()})
    ref_consumed = ref_svc.bank.consumed_counts()
    ref_svc.close()
    del ref_svc
    torch.cuda.empty_cache()

    first, info1, spawn1 = _start_server(src, d, 0, SV_CRASH_AT)
    second = None
    port = info1["port"]
    t = C.SocketTransport("connect", port=port, io_timeout_s=10.0,
                          connect_retries=3)
    ft = C.FaultyTransport(t, seed=SC_SEED, drop=0.01, dup=0.01,
                           corrupt=0.01)
    client = ScoringClient(ft, auth_key=C.session_key(SV_KEY),
                           deadline_s=20.0, max_retries=5, waves=2,
                           retry_wait_s=0.2)
    got = {}
    t_crash = outage = None   # the last answer before the crash; the gap
    try:                      # from it to the first answer after
        t0 = t_ok = time.perf_counter()
        for i, q in enumerate(reqs):
            while True:
                try:
                    got[i] = client.score(q[:, :DA], q[:, DA:], rid=i)
                    break
                except C.WireError as e:
                    if second is not None:
                        fail(f"7d: request {i} failed after the restart: {e}")
                    out1 = _finish(first)
                    if first.returncode != faultpoints.KILL_EXIT_CODE:
                        fail(f"7d: the first server exited "
                             f"{first.returncode}:\n{out1[-3000:]}")
                    second, info2, spawn2 = _start_server(src, d, port, 0)
                    t_crash = t_ok
            t_ok = time.perf_counter()
            if t_crash is not None and outage is None:
                outage = t_ok - t_crash
        wall = time.perf_counter() - t0
        client.bye()
        out2 = _finish(second) if second is not None else ""
    finally:
        ft.close()
        for p in (first, second):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    if second is None:
        fail("7d: the first server never died")
    if second.returncode != 0:
        fail(f"7d: the restarted server exited {second.returncode}:\n"
             f"{out2[-3000:]}")
    dying = _json_after(out1, "DYING ")
    stats2 = _json_after(out2, "SERVER_STATS ")
    for rid, r in ref.items():
        g = got[rid]
        if g.error is not None or g.rows != r.rows \
                or not np.array_equal(g.labels, r.labels) \
                or not np.array_equal(g.scores, r.scores):
            fail(f"7d: request {rid} differs from the uninterrupted service")
    journal, consumed = ServeCheckpointer(str(d / "serve")).load_journal()
    if sorted(journal) != list(range(SV_REQUESTS)):
        fail(f"7d: the journal holds {len(journal)} responses")
    if dying["requests"] != SV_CRASH_AT \
            or stats2["requests"] != SV_REQUESTS - SV_CRASH_AT \
            or stats2["replays"] < 1:
        fail(f"7d: the first server scored {dying['requests']}, the second "
             f"{stats2['requests']} (replays {stats2['replays']}): a rid "
             f"was scored twice or not at all")
    if consumed != ref_consumed:
        fail(f"7d: the bank consumed {consumed}, the uninterrupted service "
             f"{ref_consumed}")
    deduped = dying["dedup_replays"] + stats2["dedup_replays"]
    print(f"7d scoring over the wire with a crash (vertical, d={DA}+{DB}, "
          f"k={K}, ladder {SC_RUNGS}, {SV_REQUESTS} requests of "
          f"Poisson({SC_MEAN_ROWS}) rows, {rows} rows, seed {SC_SEED}; "
          f"client frames dropped, duplicated and corrupted 1 % each, "
          f"keyed): the server died after its {SV_CRASH_AT}th journaled "
          f"response and a new one took the port; every response equals "
          f"the uninterrupted in-process service's, each rid scored once "
          f"({dying['requests']} + {stats2['requests']}, "
          f"{stats2['replays']} replayed from the journal), the bank's "
          f"consumed counts equal; {rows / wall:.0f} rows/s over the wire "
          f"({wall:.3f} s, {rows / (wall - outage):.0f} rows/s without the "
          f"{outage:.3f} s outage); restart: process start to serving "
          f"{spawn2:.3f} s, of which bank load, realignment and warm "
          f"{info2['start_seconds']:.3f} s (first start {spawn1:.3f} s, "
          f"provisioning and warm {info1['start_seconds']:.3f} s); client "
          f"retries {client.chan.retries}, waves {client.wave_retries}, "
          f"reconnects {client.chan.reconnects}; faults "
          f"{dataclasses.asdict(ft.faults)}; duplicates deduped by the "
          f"servers {deduped}, corrupt frames dropped "
          f"{dying['crc_drops'] + stats2['crc_drops']}", flush=True)
    return {n: dying["launches"][n] + stats2["launches"][n]
            for n in stats2["launches"]}


def scoring_server(argv: list) -> None:
    """`--scoring-server DIR PORT DIE_AFTER [--src SRC]`: phase 7d's server
    process. Serves phase 6's dense model (DIR/model.npz) through a
    `ScoringServer` on 127.0.0.1:PORT (0: any free port) with a
    `ServeCheckpointer` in DIR/serve; with DIE_AFTER > 0 it exits with
    KILL_EXIT_CODE right after that many journaled responses. Prints
    `SERVING {json}` once ready and `SERVER_STATS {json}` after the
    client's BYE; its `replays` are the tracer's `serve.replay` instants
    (rids answered from the published responses)."""
    import os
    d, port, die_after = pathlib.Path(argv[0]), int(argv[1]), int(argv[2])
    t0 = time.perf_counter()
    from repro_torch.checkpoint.serve import ServeCheckpointer
    from repro_torch.core import channel as C
    from repro_torch.core import faultpoints
    from repro_torch.core.interop import result_from_reference
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.obs import trace as _trace
    from repro_torch.serve import ScoringServer, ScoringService
    tracer = _trace.configure(enabled=True, process="server")
    z = np.load(d / "model.npz")
    km = SecureKMeans(KMeansConfig(k=K, iters=ITERS, partition="vertical",
                                   seed=SEED))
    km.result_ = result_from_reference(
        {"centroids": (z["c0"], z["c1"]), "assignment": (z["a0"], z["a1"])},
        device="cuda")
    held = {}

    def stats() -> dict:
        svc, server = held["svc"], held.get("server")
        r = server.responder if server is not None else None
        return {"requests": svc.stats.requests,
                "replays": tracer.span_counts().get("serve.replay", 0),
                "dedup_replays": r.dedup_replays if r else 0,
                "crc_drops": r.crc_drops if r else 0,
                "launches": _launch_counters()}

    def die(total: int, _path) -> None:
        if die_after and total >= die_after:
            print("DYING " + json.dumps(stats()), flush=True)
            os._exit(faultpoints.KILL_EXIT_CODE)

    ck = ServeCheckpointer(str(d / "serve"), after_record=die)
    restarted = ck.has_bank()
    t1 = time.perf_counter()
    svc = held["svc"] = ScoringService(
        km, km.result_, d_a=DA, d_b=DB, rungs=SC_RUNGS,
        provision_copies=SV_COPIES, checkpointer=ck)
    svc.warm()
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t1
    t = C.SocketTransport("listen", port=port, io_timeout_s=60.0)
    server = held["server"] = ScoringServer(
        svc, t, auth_key=C.session_key(SV_KEY), idle_timeout_s=120.0)
    _zero_launch_counters()
    print("SERVING " + json.dumps({
        "port": t.port, "restarted": restarted, "start_seconds": start_s,
        "process_seconds": time.perf_counter() - t0}), flush=True)
    server.serve_forever()
    t.close()
    print("SERVER_STATS " + json.dumps(stats()), flush=True)


def phase_durability(src: pathlib.Path, model, sp_seq,
                     sp_seq_launches: dict) -> dict:
    """Phase 7 (7a-7d). Returns the launches per fit kernel of its paths:
    the two-party fits' (7a, 7b's resumed run), 7c's stopped and resumed
    runs and the 7d servers'."""
    import shutil
    shutil.rmtree(PHASE7_DIR, ignore_errors=True)
    PHASE7_DIR.mkdir(parents=True)
    try:
        out = phase_two_party(src)
        for part in (phase_resume_sparse_minibatch(sp_seq, sp_seq_launches),
                     phase_serve_crash(src, model)):
            for name, v in part.items():
                out[name] += v
    finally:
        shutil.rmtree(PHASE7_DIR, ignore_errors=True)
    print(f"phase 7 launches (7a and 7b's A, 7c, 7d's servers): {out}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: observability, the serving launcher and the supervisor
# ---------------------------------------------------------------------------

PHASE8_DIR = ROOT / "build" / "phase8"     # ignored; removed at the end
OB_COPIES = 200        # 8b: provisioned calls per rung, sized as phase 6c
                       # sizes its banks (~197 calls at the 512 rung)
OB_SUP_REQUESTS = 100  # 8c: the first requests of 6c's stream
OB_DIE_AFTER = 50      # 8c: the first server dies after this many
                       # journaled responses
OB_WIRE_ITERS = 2      # 8d: phase 7a's command cut to 2 iterations
OB_CPU_N = 512         # 8a: the CPU fits the span counts are held to
OB_CPU_BATCH = 128     # 8a: 4 batches, as phase 4c's n / MB_BATCH


def _recorded(tracer) -> list:
    """The tracer's events in the order they were recorded (a span records
    when it closes)."""
    with tracer._lock:
        return [dict(e) for e in tracer._events]


def _seconds(events, names) -> float:
    return sum(e.get("dur", 0) for e in events if e["name"] in names) / 1e6


def _hist_count(name: str) -> int:
    from repro_torch.obs import metrics as _metrics
    return _metrics.get_registry().snapshot().get(name, {"count": 0})[
        "count"]


def _traced_fit(label: str, cfg, xa, xb) -> tuple:
    """One fit from cold caches with the port's global tracer on and empty
    and the launch counters at 0. Exports the trace to PHASE8_DIR and
    loads it back. Returns (result, launches, span counts, events in
    record order, fit iterations the histogram observed)."""
    from repro_torch.core.kmeans import SecureKMeans
    from repro_torch.obs import trace as _trace
    tracer = _trace.get_tracer()
    tracer.reset()
    h0 = _hist_count("repro_fit_iteration_seconds")
    _cold_caches()
    _zero_launch_counters()
    res = SecureKMeans(cfg).fit(xa, xb)
    launches = _launch_counters()
    path = PHASE8_DIR / f"8a_{label}.json"
    tracer.export_chrome(str(path))
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    if not spans:
        fail(f"8a {label}: the exported trace holds no span")
    return (res, launches, tracer.span_counts(), _recorded(tracer),
            _hist_count("repro_fit_iteration_seconds") - h0)


def _cpu_span_counts(cfg, xa, xb) -> tuple:
    """The span counts and record-ordered events of the same fit on the
    CPU, from cold caches."""
    import dataclasses
    from repro_torch.core.kmeans import SecureKMeans
    from repro_torch.obs import trace as _trace
    tracer = _trace.get_tracer()
    tracer.reset()
    _cold_caches()
    SecureKMeans(dataclasses.replace(cfg, backend="torch", device="cpu")) \
        .fit(xa, xb)
    _cold_caches()
    return tracer.span_counts(), _recorded(tracer)


def _fit_line(label: str, res, untraced_loop: float, events, steps,
              tracer_summary: str) -> None:
    step_s = _seconds(events, steps)
    print(f"8a {label}: loop_seconds traced {res.loop_seconds:.3f} against "
          f"untraced {untraced_loop:.3f}; the step spans ({', '.join(steps)}) "
          f"sum to {step_s:.3f} s of the traced loop's "
          f"{res.loop_seconds:.3f} s (host time: a span around queued "
          f"kernels measures their enqueue)\n" + "\n".join(
              "    " + line for line in tracer_summary.splitlines()),
          flush=True)


def phase_traced_fits(dense_ref, dense_launches: dict, sp_pooled,
                      mb_pooled) -> dict:
    """8a: phase 4's on-demand fit, phase 4b's sparse pooled fit and phase
    4c's dense pooled minibatch fit (batch 25,000, pipeline on) with the
    port's global tracer on: each equals its untraced fit word for word,
    the on-demand fit launches what phase 4's did, the span counts are the
    code's (and a CPU fit's), the iteration histogram grows by the
    iterations, and each exported Chrome trace loads. Returns the three
    fits' launches."""
    import dataclasses
    from repro_torch.core.kmeans import KMeansConfig
    from repro_torch.obs import trace as _trace
    tracer = _trace.configure(enabled=True, process="chip_smoke")
    total = {n: 0 for n in dense_launches}

    def add(launches):
        for n in total:
            total[n] += launches[n]

    try:
        # dense, on demand
        x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
        cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED)
        res, launches, counts, events, hist = _traced_fit(
            "dense_on_demand", cfg, x[:, :DA], x[:, DA:])
        same_fit("8a traced dense on-demand fit vs phase 4's", res,
                 dense_ref)
        if launches != dense_launches:
            fail(f"8a dense: the traced fit launched {launches}, phase 4's "
                 f"{dense_launches}")
        want = {"fit": 1, "fit.s1_distances": ITERS, "fit.s2_argmin": ITERS,
                "fit.s3_update": ITERS}
        if {n: counts.get(n, 0) for n in want} != want or hist != ITERS:
            fail(f"8a dense: spans {counts}, histogram +{hist}")
        add(launches)
        steps = ("fit.s1_distances", "fit.s2_argmin", "fit.s3_update")
        split = {n: _seconds(events, (n,)) for n in steps}
        print(f"8a dense on-demand fit (n={N}, d={DA}+{DB}, k={K}, {ITERS} "
              f"iters), traced: equal word for word to phase 4's, kernels "
              f"{launches} = phase 4's; spans {counts}; "
              f"repro_fit_iteration_seconds +{hist}; step split "
              + ", ".join(f"{n} {v:.3f} s" for n, v in split.items()),
              flush=True)
        _fit_line("dense on demand", res, dense_ref.loop_seconds, events,
                  steps, tracer.flame_summary(top=6))
        del res, x

        # sparse, pooled
        x = _one_hot_like(np.random.default_rng(SP_SEED + 7), SP_N,
                          SP_DA + SP_DB, SP_K, SP_SPARSITY)
        cfg = KMeansConfig(k=SP_K, iters=SP_ITERS, partition="vertical",
                           seed=SP_SEED, sparse=True, offline="pooled")
        res, launches, counts, events, hist = _traced_fit(
            "sparse_pooled", cfg, x[:, :SP_DA], x[:, SP_DA:])
        same_fit("8a traced sparse pooled fit vs phase 4b's", res, sp_pooled)
        steps = ("fit.s1_exchange", "fit.s1_launch", "fit.s2_callback",
                 "fit.s3_launch")
        if any(counts.get(n, 0) != SP_ITERS for n in steps) \
                or hist != SP_ITERS:
            fail(f"8a sparse: spans {counts}, histogram +{hist}")
        summary = tracer.flame_summary(top=6)
        small = _one_hot_like(np.random.default_rng(SP_SEED + 7), OB_CPU_N,
                              SP_DA + SP_DB, SP_K, SP_SPARSITY)
        cpu_counts, _ = _cpu_span_counts(cfg, small[:, :SP_DA],
                                         small[:, SP_DA:])
        if cpu_counts != counts:
            fail(f"8a sparse: spans {counts}, the CPU fit at n={OB_CPU_N} "
                 f"{cpu_counts}")
        t_loop = min(e["ts"] for e in events if e["name"] in steps)
        in_loop = sum(1 for e in events
                      if e["name"] == "he.exchange" and e["ts"] >= t_loop)
        add(launches)
        print(f"8a sparse pooled fit (n={SP_N}, d={SP_DA}+{SP_DB}, k={SP_K}, "
              f"{SP_ITERS} iters), traced: equal word for word to phase "
              f"4b's pooled fit; spans {counts} = the CPU fit's at "
              f"n={OB_CPU_N}; he.exchange {counts['he.exchange']} in all, "
              f"{in_loop / SP_ITERS:g} an iteration in the loop (the rest "
              f"the planning trace's); kernels {launches} (planning "
              f"included)", flush=True)
        _fit_line("sparse pooled", res, sp_pooled.loop_seconds, events,
                  steps, summary)
        del res, x, small

        # dense, pooled minibatch, pipelined
        x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
        cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED,
                           offline="pooled", batch_size=MB_BATCH,
                           pipeline=True)
        res, launches, counts, events, hist = _traced_fit(
            "minibatch", cfg, x[:, :DA], x[:, DA:])
        same_fit("8a traced minibatch fit vs phase 4c's", res, mb_pooled,
                 he_rel=1e-12)
        summary = tracer.flame_summary(top=6)
        small = _blobs(np.random.default_rng(SEED + 7), OB_CPU_N, DA + DB, K)
        cpu_counts, cpu_events = _cpu_span_counts(
            dataclasses.replace(cfg, batch_size=OB_CPU_BATCH),
            small[:, :DA], small[:, DA:])

        def schedule(evs):
            return [(e["name"], e["args"]["task"]) for e in evs
                    if e["name"].startswith("pipeline.")]

        pipe = {n: c for n, c in counts.items() if n.startswith("pipeline.")}
        if schedule(events) != schedule(cpu_events) \
                or pipe != {n: c for n, c in cpu_counts.items()
                            if n.startswith("pipeline.")} \
                or hist != ITERS:
            fail(f"8a minibatch: pipeline spans {pipe}, the CPU fit's with "
                 f"{N // MB_BATCH} batches {cpu_counts}; histogram +{hist}")
        # run_pipeline is single-threaded: the overlap is the order, batch
        # t+1's pre between batch t's launch and its post
        order = schedule(events)
        for i, (name, task) in enumerate(order):
            if name == "pipeline.pre" and task > 0:
                # the nearest earlier launch or post of batch t-1 (batches
                # count from 0 in each iteration) must be its launch
                last = next(n for n, tk in reversed(order[:i])
                            if tk == task - 1 and n in ("pipeline.launch",
                                                        "pipeline.post"))
                if last != "pipeline.launch":
                    fail(f"8a minibatch: pre of batch {task} ran outside "
                         f"batch {task - 1}'s launch-to-post window")
        lanes = {e["tid"] for e in events if e["name"].startswith("pipe")}
        add(launches)
        print(f"8a dense pooled minibatch fit (batch {MB_BATCH}, pipeline), "
              f"traced: equal word for word to phase 4c's; pipeline spans "
              f"{pipe} in the CPU fit's order with the same batches; every "
              f"batch t+1's pre between batch t's launch and post, on "
              f"{len(lanes)} thread lane (run_pipeline is single-threaded); "
              f"kernels {launches} (planning included)", flush=True)
        _fit_line("minibatch", res, mb_pooled.loop_seconds, events,
                  tuple(pipe), summary)
        del res, x
    finally:
        _trace.configure(enabled=False)
        tracer.reset()
    return total


def _prom_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    fail(f"no series {series} in the exposition")


def phase_serve_in_process(dense_ref) -> dict:
    """8b: `repro_torch.launch.serve_kmeans.serve()` at the fraud
    deployment's widths over 6c's stream shape: the registry's online
    comm gauges equal phase 4's fit's totals, the serve gauges count the
    stream, the bank gauges agree with the service's calls, the exposition
    has no NaN. Returns its launches."""
    from repro_torch.launch import serve_kmeans
    from repro_torch.obs import metrics as _metrics
    from repro_torch.obs import trace as _trace
    _metrics.get_registry().reset()
    _cold_caches()
    _zero_launch_counters()
    trace_path = PHASE8_DIR / "8b.json"
    try:
        out = serve_kmeans.serve(
            n_train=N, d_a=DA, d_b=DB, k=K, iters=ITERS, rungs=SC_RUNGS,
            requests=SC_REQUESTS, mean_batch=SC_MEAN_ROWS,
            provision_copies=OB_COPIES, stats_interval=1.0,
            trace_out=str(trace_path))
    finally:
        _trace.configure(enabled=False)
        _trace.get_tracer().reset()
    launches = _launch_counters()
    reg = _metrics.get_registry()
    text = reg.render_prometheus()
    snap = reg.snapshot()
    rows = int(np.maximum(1, np.random.default_rng(1).poisson(
        SC_MEAN_ROWS, SC_REQUESTS)).sum())
    comm = (snap['repro_comm_bytes_total{phase="online"}'],
            snap['repro_comm_rounds_total{phase="online"}'])
    want = (dense_ref.log.total_bytes("online"),
            dense_ref.log.total_rounds("online"))
    if comm != want:
        fail(f"8b: the registry's online traffic {comm}, phase 4's {want}")
    if "NaN" in text.split():
        fail("8b: the exposition holds NaN")
    if (snap["repro_serve_requests"], snap["repro_serve_rows"]) \
            != (SC_REQUESTS, rows) or out["rows"] != rows:
        fail(f"8b: served {snap['repro_serve_requests']} requests of "
             f"{snap['repro_serve_rows']} rows, want {SC_REQUESTS} of {rows}")
    # the bank the gauges read: their callbacks close over it
    fn = reg.gauge("repro_bank_served_requests_total")._fn
    bank = fn.__closure__[0].cell_contents
    own = {"repro_bank_served_requests_total": bank.served_requests,
           "repro_bank_consumed_requests_total":
           sum(bank.consumed_counts().values()),
           "repro_bank_replenish_events_total": bank.replenish_events,
           **{f'repro_bank_stock_copies{{key="{k}"}}': bank.stock_copies(k)
              for k in bank.keys()}}
    gauges = {k: snap[k] for k in own}
    if gauges != own or bank.replenish_events != out["replenish_events"]:
        fail(f"8b: bank gauges {gauges}, the bank's counts {own}")
    stock = sum(v for k, v in own.items() if "stock" in k)
    served = own["repro_bank_served_requests_total"]
    del bank, fn
    json.loads(trace_path.read_text())
    print(f"8b serve() in process (n_train={N}, d={DA}+{DB}, k={K}, {ITERS} "
          f"iters, ladder {SC_RUNGS}, {SC_REQUESTS} requests of "
          f"Poisson({SC_MEAN_ROWS}) rows = {rows} rows, provision_copies "
          f"{OB_COPIES}): registry online traffic {int(comm[0])} B in "
          f"{int(comm[1])} "
          f"rounds = phase 4's fit; repro_serve_requests "
          f"{int(snap['repro_serve_requests'])}, rows "
          f"{int(snap['repro_serve_rows'])}; "
          f"bank gauges = the bank's own counts ({served} requests served, "
          f"{stock} calls left in stock of {len(SC_RUNGS) * OB_COPIES} after "
          f"{out['launches']} calls, replenish events "
          f"{out['replenish_events']}); no NaN in {len(text.splitlines())} "
          f"exposition lines; {out['rows_per_s']} rows/s, p50 "
          f"{out['p50_ms']} ms, p99 {out['p99_ms']} ms, jaccard_stream "
          f"{out['jaccard_stream']}; fit {out['fit_s']} s, warm "
          f"{out['warm_s']} s, drain {out['drain_s']} s; kernels "
          f"{launches}", flush=True)
    return launches


def _http(url: str) -> tuple:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError:
        return None, ""


def phase_supervised(src: pathlib.Path, dense_ref) -> None:
    """8c: `python -m repro_torch.launch.serve_kmeans --supervised` on the
    card, the first server killed after OB_DIE_AFTER journaled responses:
    the supervisor restarts it once; every one of the first OB_SUP_REQUESTS
    requests of 6c's stream is answered once, equal to an in-process
    service built as `serve_wire` builds it; /health answers 503 before
    READY and 200 after; /metrics after the restart has phase 4's online
    traffic; the parent never initialized CUDA; the client's and the
    surviving server's traces merge on the client's trace ids."""
    import queue
    import re
    import threading
    from repro_torch.core import channel as C
    from repro_torch.core.fraud import FraudDataset
    from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
    from repro_torch.obs import trace as _trace
    from repro_torch.serve import ScoringClient, ScoringService
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    # the first OB_SUP_REQUESTS of 6c's stream (Poisson draws in sequence)
    reqs = _requests(np.random.default_rng(SC_SEED), x, OB_SUP_REQUESTS)
    rows = sum(len(q) for q in reqs)
    del x
    # the reference: the model and service serve_wire builds (seed 0)
    ds = FraudDataset.synthesize(n=N, d_a=DA, d_b=DB, n_clusters=K, seed=0)
    km = SecureKMeans(KMeansConfig(k=K, iters=ITERS, seed=0,
                                   offline="pooled"))
    res = km.fit(ds.x_a, ds.x_b)
    del ds
    svc = ScoringService(km, res, rungs=SC_RUNGS, with_scores=True, d_a=DA,
                         d_b=DB, provision_copies=8)
    ref = {}
    for i, q in enumerate(reqs):
        svc.submit(q[:, :DA], q[:, DA:])
        (r,) = svc.drain()
        ref[i] = r
    svc.close()
    del svc, km, res
    torch.cuda.empty_cache()

    import shutil
    d = PHASE8_DIR / "8c"
    shutil.rmtree(d, ignore_errors=True)
    strace, ctrace = PHASE8_DIR / "8c_server.json", PHASE8_DIR / "8c_client.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_kmeans",
           "--supervised", "--serve-port", "0", "--metrics-port", "0",
           "--serve-checkpoint-dir", str(d), "--die-after-responses",
           str(OB_DIE_AFTER), "--n-train", str(N), "--d-a", str(DA),
           "--d-b", str(DB), "--k", str(K), "--iters", str(ITERS),
           "--rungs", ",".join(map(str, SC_RUNGS)), "--trace-out",
           str(strace)]
    sup = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env=_src_env(src))
    lines: queue.Queue = queue.Queue()
    out_lines = []

    def read():
        for line in sup.stdout:
            out_lines.append(line)
            lines.put(line)
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    health = []              # /health's status codes, 50 ms apart
    state = {"mport": None, "stop": False}
    t_spawn = time.perf_counter()

    def poll():
        while not state["stop"]:
            if state["mport"] is not None:
                code, _ = _http(f"http://127.0.0.1:{state['mport']}/health")
                if code is not None:
                    health.append(code)
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()

    def wait_for(pattern: str, timeout: float = 300.0):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                fail(f"8c: the supervisor exited {sup.wait()}:\n"
                     + "".join(out_lines)[-3000:])
            m = re.search(r"METRICS (\d+)", line)
            if m:
                state["mport"] = int(m.group(1))
            m = re.search(pattern, line)
            if m:
                return m
        fail(f"8c: no {pattern!r} line in {timeout} s:\n"
             + "".join(out_lines)[-3000:])

    try:
        port = int(wait_for(r"SERVING (\d+)").group(1))
        ready_s = time.perf_counter() - t_spawn
        tracer = _trace.Tracer(enabled=True, process="client")
        t = C.SocketTransport("connect", port=port, io_timeout_s=10.0,
                              connect_retries=3)
        client = ScoringClient(t, deadline_s=15.0, try_timeout_s=0.5,
                               waves=40, retry_wait_s=1.0, tracer=tracer)
        got = {}
        gaps = []
        t0 = t_last = time.perf_counter()
        for i, q in enumerate(reqs):
            got[i] = client.score(q[:, :DA], q[:, DA:], rid=i)
            now = time.perf_counter()
            gaps.append(now - t_last)
            t_last = now
        wall = time.perf_counter() - t0
        m_text = _http(f"http://127.0.0.1:{state['mport']}/metrics")[1]
        client.bye()
        t.close()
        reader.join(timeout=180)
        sup.wait(timeout=60)
    finally:
        state["stop"] = True
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    out = "".join(out_lines)
    if sup.returncode != 0:
        fail(f"8c: the supervisor exited {sup.returncode}:\n{out[-3000:]}")
    if "restart 1 after rc=17" not in out or \
            "SUPERVISOR terminal: clean exit (rc=0, restarts=1)" not in out:
        fail(f"8c: want one crash (rc 17) and one restart:\n{out[-3000:]}")
    stats = json.loads(out.split("SUPERVISOR_STATS ")[1].splitlines()[0])
    if stats["cuda_initialized"]:
        fail("8c: the supervising parent initialized CUDA")
    for i, r in ref.items():
        g = got[i]
        if g.error is not None or g.request_id != i \
                or not np.array_equal(g.labels, r.labels) \
                or not np.array_equal(g.scores, r.scores):
            fail(f"8c: request {i} differs from the in-process service")
    # the first incarnation's probes, in order: 503 STARTING while it
    # warmed, then 200 READY (its SERVING line follows READY)
    first_ok = health.index(200) if 200 in health else len(health)
    if first_ok in (0, len(health)) or set(health[:first_ok]) != {503}:
        fail(f"8c: /health answered {health[:20]}... before and at READY, "
             f"want 503 until 200")
    comm = (_prom_value(m_text, 'repro_comm_bytes_total{phase="online"}'),
            _prom_value(m_text, 'repro_comm_rounds_total{phase="online"}'))
    want = (dense_ref.log.total_bytes("online"),
            dense_ref.log.total_rounds("online"))
    if comm != want:
        fail(f"8c: /metrics after the restart has online traffic {comm}, "
             f"phase 4's fit {want}")
    tracer.export_chrome(str(ctrace))
    merged = _trace.merge_traces([str(ctrace), str(strace)])
    evs = merged["traceEvents"]
    client_ids = {e["args"]["trace"] for e in evs
                  if e["pid"] == 1 and e["name"] == "client.score"}
    served = [e for e in evs if e["pid"] == 2
              and e["name"] == "serve.request"]
    replayed = sorted(e["args"]["rid"] for e in evs if e["pid"] == 2
                      and e["name"] == "serve.replay")
    if len(client_ids) != OB_SUP_REQUESTS \
            or any(e["args"].get("trace") not in client_ids for e in served):
        fail("8c: a server request span carries no client trace id")
    if sorted(e["args"]["rid"] for e in served) \
            != list(range(OB_DIE_AFTER, OB_SUP_REQUESTS)) \
            or replayed != [OB_DIE_AFTER - 1]:
        fail(f"8c: the surviving server's request spans cover "
             f"{sorted(e['args']['rid'] for e in served)}, replays "
             f"{replayed}")
    ev = {}
    for kind, ts, inc in stats["events"]:
        ev.setdefault((kind, inc), ts)
    spawn_ready = [ev[("ready", i)] - ev[("spawn", i)] for i in (0, 1)]
    outage = max(gaps)
    print(f"8c supervised wire server (n_train={N}, d={DA}+{DB}, k={K}, "
          f"{ITERS} iters, ladder {SC_RUNGS}; {OB_SUP_REQUESTS} requests of "
          f"6c's stream, {rows} rows): the server died after its "
          f"{OB_DIE_AFTER}th journaled response (rc 17), the supervisor "
          f"restarted it once; every response equals the in-process "
          f"service's, each rid answered once ({len(served)} request spans "
          f"in the surviving server, rid {replayed} replayed from the "
          f"journal, every span under a client trace id); /health 503 "
          f"before the first READY ({first_ok} probes, 50 ms apart) and "
          f"200 after; /metrics after the restart: online "
          f"traffic {int(comm[0])} B in {int(comm[1])} rounds = phase 4's; "
          f"the parent never initialized CUDA; spawn to ready "
          f"{spawn_ready[0]:.3f} s first, {spawn_ready[1]:.3f} s restarted "
          f"(death to ready {stats['restart_latencies'][0]:.3f} s); first "
          f"SERVING {ready_s:.3f} s after the supervisor's spawn; outage "
          f"{outage:.3f} s; {rows / wall:.0f} rows/s over the run "
          f"({wall:.3f} s), {rows / (wall - outage):.0f} without the outage",
          flush=True)


def phase_two_party_traced(src: pathlib.Path) -> dict:
    """8d: phase 7a's two-party command at OB_WIRE_ITERS iterations with
    `--trace-out` on both parties: A's wire.exchange spans carry exactly
    its session's payload bytes and rounds, B handled every request A
    sent, B never initialized CUDA, the merged timeline has both pids.
    Returns A's fit launches."""
    import re
    from repro_torch.obs import trace as _trace
    fa, fb = PHASE8_DIR / "8d_a.json", PHASE8_DIR / "8d_b.json"
    common = ["--n", str(TP_N), "--d", str(TP_D), "--k", str(TP_K),
              "--iters", str(OB_WIRE_ITERS), "--seed", str(TP_SEED)]
    run = _two_party(src, common + ["--out", str(PHASE8_DIR / "8d.npz"),
                                    "--trace-out", str(fa)],
                     ["--trace-out", str(fb)])
    if run["rc_a"] != 0 or run["rc_b"] != 0:
        fail(f"8d: party A exit {run['rc_a']}, B {run['rc_b']}:\n"
             f"{run['a'][-3000:]}\n{run['b'][-3000:]}")
    if _wire_stats(run["b"], "B")["cuda_initialized"]:
        fail("8d: party B initialized CUDA")
    m = re.search(r"wire (\d+) payload bytes / (\d+) rounds", run["a"])
    if m is None:
        fail(f"8d: party A printed no wire totals:\n{run['a'][-3000:]}")
    payload, rounds = int(m.group(1)), int(m.group(2))
    merged = _trace.merge_traces([str(fa), str(fb)])
    evs = [e for e in merged["traceEvents"] if e["ph"] != "M"]
    count = {}
    for e in evs:
        count[(e["pid"], e["name"])] = count.get((e["pid"], e["name"]), 0) + 1
    ex = [e for e in evs if e["pid"] == 1 and e["name"] == "wire.exchange"]
    ex_bytes = sum(e["args"]["nbytes"] for e in ex)
    ex_rounds = sum(e["args"]["rounds"] for e in ex)
    if (ex_bytes, ex_rounds) != (payload, rounds):
        fail(f"8d: A's wire.exchange spans carry {ex_bytes} B in "
             f"{ex_rounds} rounds, its session {payload} B in {rounds}")
    if count.get((2, "wire.handle")) != count.get((1, "wire.request")):
        fail(f"8d: B handled {count.get((2, 'wire.handle'))} requests, A "
             f"sent {count.get((1, 'wire.request'))}")
    if {e["pid"] for e in evs} != {1, 2}:
        fail("8d: the merged timeline lacks a party")
    meta = _party_out(PHASE8_DIR / "8d.npz")[1]
    print(f"8d two-party fit with --trace-out (n={TP_N}, d={TP_D}, k={TP_K}, "
          f"{OB_WIRE_ITERS} iters): A's {len(ex)} wire.exchange spans carry "
          f"its session's {payload} B in {rounds} rounds (the CommLog's "
          f"online traffic of the fit and the predict); A sent "
          f"{count[(1, 'wire.request')]} requests, B handled "
          f"{count[(2, 'wire.handle')]}; B never initialized CUDA; the "
          f"merged timeline has both parties ({len(evs)} events); A's wall "
          f"{run['wall']:.3f} s, fit {meta['fit_seconds']:.3f} s; kernels "
          f"{meta['fit_launches']}", flush=True)
    return meta["fit_launches"]


def phase_observability(src: pathlib.Path, dense: tuple, sp_pooled,
                        mb_pooled) -> dict:
    """Phase 8 (8a-8d). Returns the launches per fit kernel of its
    in-process paths (8a's traced fits, 8b's serve()) and 8d's party A;
    8c's server processes count their own and are not read."""
    import shutil
    dense_ref, dense_launches = dense
    shutil.rmtree(PHASE8_DIR, ignore_errors=True)
    PHASE8_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        out = phase_traced_fits(dense_ref, dense_launches, sp_pooled,
                                mb_pooled)
        for part in (phase_serve_in_process(dense_ref),
                     phase_two_party_traced(src)):
            for name in out:
                out[name] += part.get(name, 0)
        phase_supervised(src, dense_ref)
    finally:
        shutil.rmtree(PHASE8_DIR, ignore_errors=True)
    print(f"phase 8 launches (8a, 8b, 8d's A): {out}; phase 8 took "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the LM substrate (models, decode, training, CheckpointStore)
# ---------------------------------------------------------------------------

PHASE9_DIR = ROOT / "build" / "phase9"     # ignored; removed at the end
LM_FULL_ARCH = "granite-moe-3b-a800m"      # 9b: 32L d=1536, 40e top-8
LM_SERVE = dict(batch=4, prompt_len=32, gen=64)
# run()'s default lr (3e-4, 100 warmup steps) moves each weight by 6.9e-4 in
# 20 steps in all: the losses stay within the batch-to-batch spread
# (11.25-11.35 on an H100, the last five above the first); at 3e-3 the
# loss falls by ~0.2 in 20 steps
LM_TRAIN = dict(steps=20, batch=4, seq=256, lr=3e-3)
LM_DECODE_T = 8                            # 9b: serve_step vs forward
LM_RESUME = dict(steps=30, ckpt_every=10, batch=8, seq=256, keep=2)
LM_PREEMPT_AT = 25                         # 9c: resumes from step 20
# bf16 models, GPU against CPU: the relative L2 error of hidden states and
# logits within 0.05 (tests/test_models.py's MoE-vs-dense value), the loss
# within rtol 1e-3; f32 models within rtol 1e-4 (the resume test's); the
# first AdamW step's parameters within 2 lr_1 plus one ulp (Adam's first
# step is lr_1 sign(g), so the devices differ only where a gradient's sign
# does); decode against forward within 0.15 with the argmax equal
LM_REL_L2 = 0.05
LM_LOSS_RTOL = 1e-3
LM_F32_RTOL = 1e-4
LM_DECODE_TOL = 0.15


def _rel_l2(want: torch.Tensor, got: torch.Tensor) -> float:
    w, g = want.double().cpu(), got.double().cpu()
    return float((g - w).norm() / max(float(w.norm()), 1e-30))


def _lm_batch(cfg, device, f32: bool = False, b: int = 2, t: int = 32,
              seed: int = 0) -> dict:
    """tests/test_models.py's batch (f32: input embeddings, not tokens)."""
    rng = np.random.default_rng(seed)
    act = torch.float32 if f32 else torch.bfloat16
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t)))}
    if f32:
        batch["embeds"] = torch.from_numpy(
            rng.normal(0, 1, (b, t, cfg.d_model))).to(act)
        del batch["tokens"]
    if cfg.enc_dec:
        batch["enc_inputs"] = torch.from_numpy(
            rng.normal(0, 1, (b, t, cfg.d_model))).to(torch.bfloat16)
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (b, cfg.n_patches, cfg.d_model))).to(act)
    return {k: v.to(device) for k, v in batch.items()}


def _lm_step(cfg, params, batch):
    from repro_torch.training.adamw import AdamWConfig
    from repro_torch.training.train_step import init_state, make_train_step
    opt = AdamWConfig()
    return make_train_step(cfg, opt)(params, init_state(params, opt), batch)


def _first_step_close(label, want: dict, got: dict, eps: float) -> None:
    from repro_torch.models.tree import flatten_with_path
    from repro_torch.training.adamw import AdamWConfig
    lr1 = AdamWConfig().lr * 2 / AdamWConfig().warmup_steps
    for (path, w), (_, g) in zip(flatten_with_path(want),
                                 flatten_with_path(got)):
        w, g = w.double().cpu(), g.double().cpu()
        bound = 2 * lr1 * (1 + 1e-3) + eps * w.abs()
        if not bool(((g - w).abs() <= bound).all()):
            fail(f"{label}: updated {path} off by "
                 f"{float((g - w).abs().max()):.3g}")


def lm_gpu_equals_cpu(arch: str) -> dict:
    """9a for one reduced config: one CPU-drawn tree on both devices
    (params_to_numpy / params_from_numpy); forward, lm_loss, one train
    step (bf16; and f32, but for seamless, whose encoder casts its input to
    bf16), three serve_step positions. Returns the worst errors."""
    from repro_torch.configs.base import all_archs
    from repro_torch.models import lm
    from repro_torch.models.tree import tree_map
    from repro_torch.serving.decode import init_cache, serve_step
    cfg = all_archs()[arch].reduced
    tree = lm.params_to_numpy(lm.init_params(cfg, 0, device="cpu"))
    out = {}
    for f32 in (False, True):
        if f32 and cfg.enc_dec:
            continue
        p = {}
        for dev in ("cpu", "cuda"):
            p[dev] = lm.params_from_numpy(tree, dev)
            if f32:
                p[dev] = tree_map(lambda t: t.float(), p[dev])
                p[dev]["head"] = p[dev]["head"].to(torch.bfloat16)
        b = {dev: _lm_batch(cfg, dev, f32=f32) for dev in ("cpu", "cuda")}
        tag = "f32" if f32 else "bf16"
        with torch.no_grad():
            h = {dev: lm.forward(p[dev], cfg, tokens=b[dev].get("tokens"),
                                 embeds=b[dev].get("embeds"),
                                 enc_inputs=b[dev].get("enc_inputs"),
                                 patch_embeds=b[dev].get("patch_embeds"))
                 for dev in ("cpu", "cuda")}
            loss = {dev: float(lm.lm_loss(p[dev], cfg, b[dev]))
                    for dev in ("cpu", "cuda")}
        step = {dev: _lm_step(cfg, p[dev], b[dev]) for dev in ("cpu", "cuda")}
        rtol = LM_F32_RTOL if f32 else LM_LOSS_RTOL
        err_h = _rel_l2(h["cpu"], h["cuda"])
        if f32:
            if not within(h["cuda"].cpu(), h["cpu"], rtol=2e-3, atol=2e-3):
                fail(f"9a {arch} f32: forward differs by "
                     f"{max_abs_err(h['cuda'].cpu(), h['cpu']):.3g}")
        elif err_h > LM_REL_L2:
            fail(f"9a {arch}: forward relative L2 error {err_h:.4f}")
        for name, a, g in (
                ("lm_loss", loss["cpu"], loss["cuda"]),
                ("step loss", float(step["cpu"][2]["loss"]),
                 float(step["cuda"][2]["loss"]))):
            if abs(g - a) > rtol * abs(a):
                fail(f"9a {arch} {tag}: {name} {g} on the card, {a} on "
                     "the CPU")
        gn = [float(step[d][2]["grad_norm"]) for d in ("cpu", "cuda")]
        if not np.isfinite(gn).all() or (
                f32 and abs(gn[1] - gn[0]) > rtol * gn[0]):
            fail(f"9a {arch} {tag}: grad_norm {gn[1]} on the card, {gn[0]} "
                 "on the CPU")
        _first_step_close(f"9a {arch} {tag}", step["cpu"][0], step["cuda"][0],
                          2.0 ** -23 if f32 else 2.0 ** -7)
        out[tag] = {"hidden_rel_l2": err_h,
                    "loss_rel": abs(loss["cuda"] - loss["cpu"]) / loss["cpu"],
                    "grad_norm_rel": abs(gn[1] - gn[0]) / gn[0]}
        del step
    # three decode positions (bf16)
    p = {dev: lm.params_from_numpy(tree, dev) for dev in ("cpu", "cuda")}
    enc_len = 8 if cfg.enc_dec else 0
    cache = {dev: init_cache(cfg, 2, 8, enc_len=enc_len, device=dev)
             for dev in ("cpu", "cuda")}
    toks = _lm_batch(cfg, "cpu", t=3, seed=3)["tokens"]
    worst = 0.0
    for pos in range(3):
        logits = {}
        for dev in ("cpu", "cuda"):
            logits[dev], cache[dev] = serve_step(
                p[dev], cfg, cache[dev], toks[:, pos:pos + 1].to(dev), pos)
        worst = max(worst, _rel_l2(logits["cpu"], logits["cuda"]))
    if worst > LM_REL_L2:
        fail(f"9a {arch}: serve_step logits relative L2 error {worst:.4f}")
    out["decode_rel_l2"] = worst
    return out


def lm_decode_matches_forward(cfg, params) -> float:
    """9b: serve_step over LM_DECODE_T positions against the teacher-forced
    forward at full width (capacity_factor 8: no drops), within 0.15 and
    the argmax equal, as tests/test_models.py holds it at reduced width."""
    from repro_torch.models.lm import forward
    from repro_torch.serving.decode import init_cache, serve_step
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LM_DECODE_T))).to("cuda")
    with torch.no_grad():
        hidden = forward(params, cfg, tokens=tokens, remat=False)
        want = (hidden[:, -1].to(torch.bfloat16) @ params["head"]).float()
    cache = init_cache(cfg, 1, LM_DECODE_T, device="cuda")
    for pos in range(LM_DECODE_T):
        got, cache = serve_step(params, cfg, cache, tokens[:, pos:pos + 1],
                                pos)
    err = max_abs_err(got, want)
    if not within(got, want, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL) \
            or int(got.argmax(-1)[0]) != int(want.argmax(-1)[0]):
        fail(f"9b: serve_step vs forward at full width: max abs error "
             f"{err:.4f}, argmax {int(got.argmax(-1)[0])} vs "
             f"{int(want.argmax(-1)[0])}")
    return err


def device_share(fn) -> dict:
    """fn() once under torch.profiler (after a warm call): wall ms, the
    device's kernel ms and launches, the idle share of the wall, and the
    five kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_ms": busy, "launches": len(kernels),
            "idle_share": max(0.0, 1 - busy / wall) if kernels else None,
            "top_kernels_ms": [[n[:60], ms] for n, ms in top]}


def lm_profiles(cfg, params) -> dict:
    """9b: one serve_step (batch LM_SERVE["batch"], 32 cached positions)
    and one train step (LM_TRAIN's batch and sequence) at full width,
    each under device_share."""
    from repro_torch.serving.decode import init_cache, serve_step
    from repro_torch.training.adamw import AdamWConfig
    from repro_torch.training.train_step import init_state, make_train_step
    b = LM_SERVE["batch"]
    cache = init_cache(cfg, b, LM_SERVE["prompt_len"] + LM_SERVE["gen"],
                       device="cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    out = {"serve_step": device_share(
        lambda: serve_step(params, cfg, cache, tok, LM_SERVE["prompt_len"]))}
    del cache
    opt = AdamWConfig(lr=LM_TRAIN["lr"])
    step = make_train_step(cfg, opt)
    state = init_state(params, opt)
    batch = _lm_batch(cfg, "cuda", b=LM_TRAIN["batch"], t=LM_TRAIN["seq"])
    out["train_step"] = device_share(lambda: step(params, state, batch))
    return out


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_lm() -> dict:
    """Phase 9 (9a-9c): the LM substrate on the card. Returns the LM line."""
    import dataclasses
    import shutil
    from repro_torch.configs.base import all_archs
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import run
    t0 = time.perf_counter()
    # what earlier phases still hold: 9b's peak memory includes it
    line = {"gpu_vs_cpu": {},
            "resident_gb_at_start": torch.cuda.memory_allocated() / 1e9}
    for arch in sorted(all_archs()):                                  # 9a
        line["gpu_vs_cpu"][arch] = lm_gpu_equals_cpu(arch)
    line["9a_s"] = time.perf_counter() - t0
    print(f"9a: every reduced config GPU = CPU ({line['9a_s']:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()

    full = all_archs()[LM_FULL_ARCH].config                           # 9b
    t1 = time.perf_counter()
    sv = serve(LM_FULL_ARCH, reduced=False, verbose=False, device="cuda",
               **LM_SERVE)
    if not sv["finite"] or sv["tokens"].shape != (LM_SERVE["batch"],
                                                  LM_SERVE["gen"]):
        fail(f"9b: serve at full width: finite {sv['finite']}, tokens "
             f"{sv['tokens'].shape}")
    line["serve"] = {k: sv[k] for k in ("prefill_s", "decode_s",
                                        "decode_tok_per_s", "finite")}
    torch.cuda.empty_cache()
    from repro_torch.models.lm import init_params
    params = init_params(full, 0, device="cuda")
    line["decode_vs_forward_max_abs"] = lm_decode_matches_forward(
        dataclasses.replace(full, capacity_factor=8.0), params)
    line["profile"] = lm_profiles(full, params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = run(LM_FULL_ARCH, reduced=False, verbose=False, device="cuda",
             **LM_TRAIN)
    losses = tr["losses"]
    if not np.isfinite(losses).all() or np.mean(losses[-5:]) >= losses[0]:
        fail(f"9b: training at full width: losses {losses}")
    line["train"] = {"first_loss": losses[0],
                     "last5_mean_loss": float(np.mean(losses[-5:])),
                     "p50_ms": tr["p50_ms"], "p95_ms": tr["p95_ms"],
                     "max_memory_gb": torch.cuda.max_memory_allocated()
                     / 1e9}
    line["9b_s"] = time.perf_counter() - t1
    print(f"9b: {LM_FULL_ARCH} ({full.param_count():,} parameters) "
          f"served, decoded = forward, trained ({line['9b_s']:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()

    t2 = time.perf_counter()                                          # 9c
    arch = _load_example("train_lm_torch").register()
    shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    ckpt = str(PHASE9_DIR / "ckpt")
    try:
        cut = run(arch, ckpt_dir=ckpt, simulate_preemption_at=LM_PREEMPT_AT,
                  verbose=False, device="cuda", **LM_RESUME)
        resumed = run(arch, ckpt_dir=ckpt, verbose=False, device="cuda",
                      **LM_RESUME)
    finally:
        shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    whole = run(arch, verbose=False, device="cuda",
                **{k: v for k, v in LM_RESUME.items() if k != "keep"})
    want_from = (LM_PREEMPT_AT // LM_RESUME["ckpt_every"]) \
        * LM_RESUME["ckpt_every"]
    if cut.get("preempted_at") != LM_PREEMPT_AT \
            or resumed["resumed_from"] != want_from:
        fail(f"9c: preempted at {cut.get('preempted_at')}, resumed from "
             f"{resumed['resumed_from']}")
    a, b = resumed["final_loss"], whole["final_loss"]
    if abs(a - b) > 1e-4 * abs(b):
        fail(f"9c: resumed final loss {a} against uninterrupted {b}")
    comp = run(arch, steps=5, batch=LM_RESUME["batch"],
               seq=LM_RESUME["seq"], compress=True, verbose=False,
               device="cuda")
    if not np.isfinite(comp["losses"]).all():
        fail(f"9c: --compress losses {comp['losses']}")
    line["resume"] = {"resumed_from": resumed["resumed_from"],
                      "final_loss": a, "uninterrupted_final_loss": b,
                      "bit_equal": a == b, "p50_ms": whole["p50_ms"],
                      "compress_losses": comp["losses"]}
    line["9c_s"] = time.perf_counter() - t2
    line["phase_s"] = time.perf_counter() - t0
    print(f"9c: resumed from step {resumed['resumed_from']} = uninterrupted"
          f" ({a} vs {b}); compressed steps finite ({line['9c_s']:.1f} s)",
          flush=True)
    print("LM " + json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------
# phase 10: the kmeans-fraud cell and the multi-device plans
# ---------------------------------------------------------------------------

# configs/kmeans_fraud.py FULL (d = 1024, k = 16, d_a = 512, paper Fig 4
# scale) as the single-launch online iteration (launch/kmeans_step.py
# online_iteration_fn). Dense: the full n's offline list (52.65 GB) and data
# (8.59 GB) leave no room for the iteration's temporaries on an 80 GB card,
# so 10a runs half the samples with every width as published (30.6 GB
# resident). Sparse (10b): Protocol 2's results enter as inputs, 25.8 GB at
# the full n.
KF_DENSE_N = 524_288
KF_SEED = 21
KF_ATOL = 1e-2        # tests/test_launch_kmeans_step.py's bound
KF_AGREE = 0.98

# The kmeans-fraud cell's ring products (phase 10; configs/kmeans_fraud.py
# FULL: d = 1024, d_a = d_b = 512, k = 16) with the layouts its iteration
# hands ring_matmul, as MM_FIT_PER_ITER: 10a (dense, n = 524,288) C^T X and
# Beaver e @ (v + f) long-K, X @ mu^T slices and Beaver u @ f tall; 10b
# (sparse, n = 1,048,576) only the local C^T X and X @ mu^T.
KF_D, KF_D_A, KF_K, KF_FULL_N = 1024, 512, 16, 1_048_576
KF_MM_PER_ITER = [
    ((KF_K, KF_DENSE_N, KF_D_A), "row", "row", 4),
    ((KF_K, KF_DENSE_N, KF_D_A), "t", "row", 6),
    ((KF_DENSE_N, KF_D_A, KF_K), "row", "row", 4),
    ((KF_DENSE_N, KF_D_A, KF_K), "row", "t", 4),
    ((KF_DENSE_N, KF_D_A, KF_K), "row", ("mu", 0), 1),
    ((KF_DENSE_N, KF_D_A, KF_K), "row", ("mu", KF_D_A), 1)]
KF_SP_MM_PER_ITER = [
    ((KF_K, KF_FULL_N, KF_D_A), "t", "row", 2),
    ((KF_FULL_N, KF_D_A, KF_K), "row", ("mu", 0), 1),
    ((KF_FULL_N, KF_D_A, KF_K), "row", ("mu", KF_D_A), 1)]
LONGW_PROBE_BLOCKS = (264, 1056, 2112)  # --kernel-times: the meeting's cost
PHASE10_DIR = ROOT / "build" / "phase10"    # ignored; removed at the end
# 10c: the dry run and roofline as users run them, each a CPU process
KF_PLAN_CMDS = {
    "dryrun_kmeans": ["-m", "repro_torch.launch.dryrun", "--kmeans"],
    "dryrun_moe_train": ["-m", "repro_torch.launch.dryrun", "--arch",
                         "granite-moe-3b-a800m", "--shape", "train_4k",
                         "--mesh", "single"],
    "dryrun_moe_decode": ["-m", "repro_torch.launch.dryrun", "--arch",
                          "granite-moe-3b-a800m", "--shape", "decode_32k",
                          "--mesh", "single"],
    "roofline_kmeans": ["-m", "repro_torch.launch.roofline", "--arch",
                        "kmeans-fraud"],
    # every reduced config's train step on a fake (2, 4) mesh: the work a
    # device repeats over 'model', against its bound (exit 1 above it)
    "dryrun_tp_ratios": ["-m", "repro_torch.launch.dryrun", "--tp-ratios",
                         "--shape", "train_4k", "--batches", "2"]}


def kf_data(gen, n: int, d: int, k: int, sparsity: float = 0.0):
    """Encoded blobs on the card from `gen`: (x_enc (n, d) ring words,
    labels). Centers uniform in [-1, 1), noise 0.3: at d = 1024 the blobs
    are ~26 apart against a radius of ~10, and D' = |mu|^2 - 2 x.mu stays
    near 2^49 at scale 2^40, where the protocol's local truncation wraps
    about one word in 2^15 (a center range of [-5, 5) would wrap 25 times
    as often). With sparsity, each cluster keeps a fixed random
    (1 - sparsity) share of the columns and zeros the rest (as phase 4b's
    data)."""
    from repro_torch.core import ring
    dev = torch.device("cuda")
    centers = (torch.rand((k, d), generator=gen, device=dev,
                          dtype=torch.float64) * 2 - 1).to(torch.float32)
    if sparsity:
        keep = torch.rand((k, d), generator=gen, device=dev) >= sparsity
        centers = centers * keep
    lab = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev) * 0.3
    x += centers[lab]
    if sparsity:
        x *= keep[lab]
    enc = ring.encode(x)
    del x
    return enc, lab


def kf_first_of_each(lab: torch.Tensor, k: int) -> torch.Tensor:
    """The index of the first point of each of the k blobs."""
    first = [(lab == c).nonzero()[:1, 0] for c in range(k)]
    if any(f.numel() == 0 for f in first):
        fail(f"a blob of the {k} is empty")
    return torch.cat(first)


def kf_shares(gen, words: torch.Tensor):
    """Two additive shares of `words`: a random word mask and the rest."""
    r = torch.randint(-2 ** 63, 2 ** 63 - 1, tuple(words.shape),
                      generator=gen, dtype=torch.int64, device=words.device)
    return r, words - r


class _CellSpy:
    """Records the operand shapes and layouts ring_matmul and
    ks_carry_share are called with, for the per-shape timing; counts
    nothing (the wrappers count their launches)."""

    def __enter__(self):
        from collections import Counter
        from repro_torch.kernels import ksadder, modmatmul
        self.mm, self.ks = Counter(), Counter()
        self._orig = (modmatmul.ring_matmul, ksadder.ks_carry_share)
        mm0, ks0 = self._orig

        def mm(a, b):
            self.mm[((a.shape[0], a.shape[1], b.shape[1]),
                     modmatmul.layout(a), modmatmul.layout(b))] += 1
            return mm0(a, b)

        def ks(*args, party0):
            self.ks[tuple(args[0].shape)] += 1
            return ks0(*args, party0=party0)
        modmatmul.ring_matmul, ksadder.ks_carry_share = mm, ks
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ksadder, modmatmul
        modmatmul.ring_matmul, ksadder.ks_carry_share = self._orig


def _layout_operand(gen, rows: int, cols: int, lay):
    """A (rows, cols) operand of random words in the layout `lay` that
    `modmatmul.layout` reported: (transposed, leading dim), or None for one
    the wrapper copies (drawn contiguous)."""
    def draw(shape):
        return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                             dtype=torch.int64, device="cuda")
    if lay is None:
        return draw((rows, cols))
    transposed, ld = lay
    if transposed:
        return draw((cols, ld))[:, :rows].T
    return draw((rows, ld))[:, :cols]


def kf_kernel_rows(spy, seed: int, label: str) -> dict:
    """Each (shape, layout) ring_matmul and each shape ks_carry_share met
    in the cell's iteration: held word for word to the plain version on
    fresh inputs of that shape and layout, then timed (L2-cold) against its
    bound. Returns {"ring_matmul": [...], "ks_carry_share": [...]} rows of
    (what, count, ms, plain_ms, (bytes ms, operations ms))."""
    from repro_torch.kernels import ksadder, modmatmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = {"ring_matmul": [], "ks_carry_share": []}
    for ((m, kdim, n), la, lb), count in sorted(spy.mm.items(),
                                                key=lambda kv: str(kv[0])):
        def make():
            return (_layout_operand(gen, m, kdim, la),
                    _layout_operand(gen, kdim, n, lb))
        a, b = make()
        if not torch.equal(modmatmul.ring_matmul(a, b),
                           modmatmul.ring_matmul_plain(a.contiguous(),
                                                       b.contiguous())):
            fail(f"{label}: ring_matmul ({m},{kdim})@({kdim},{n}) A {la} "
                 f"B {lb} differs from its plain version")
        nbytes = 8 * (m * kdim + kdim * n)
        sets = [(a, b)] + [make() for _ in range(
            min(15, -(-2 * L2_BYTES // nbytes) - 1))]
        ms = device_ms(modmatmul.ring_matmul, sets)
        plain = device_ms(modmatmul.ring_matmul_plain, sets, reps=2,
                          bursts=2)
        del sets, a, b
        bound = mm_bound_ms(m, kdim, n)
        rows["ring_matmul"].append(((m, kdim, n, la, lb), count, ms, plain,
                                    bound))
        print(f"  {label} ring_matmul ({m},{kdim})@({kdim},{n}) A {la} B "
              f"{lb}, x{count}: equal; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {_fmt_bound(bound)}", flush=True)
    for shape, count in sorted(spy.ks.items()):
        def words(s):
            return torch.randint(-2 ** 63, 2 ** 63 - 1, s, generator=gen,
                                 dtype=torch.int64, device="cuda")
        flat = [words(shape) for _ in range(6)]
        lvls = [words((len(ksadder.LEVELS), 2) + shape) for _ in range(5)]
        for party0 in (True, False):
            if not torch.equal(
                    ksadder.ks_carry_share(*flat, *lvls, party0=party0),
                    ksadder.ks_carry_share_plain(*flat, *lvls,
                                                 party0=party0)):
                fail(f"{label}: ks_carry_share {shape} party0={party0} "
                     f"differs from its plain version")
        sets = cold_copies((*flat, *lvls))
        ms = device_ms(lambda *t: ksadder.ks_carry_share(*t, party0=True),
                       sets)
        plain = device_ms(
            lambda *t: ksadder.ks_carry_share_plain(*t, party0=True), sets,
            reps=3, bursts=2)
        del sets, flat, lvls
        bound = ks_bound_ms(int(np.prod(shape, dtype=np.int64)))
        rows["ks_carry_share"].append((shape, count, ms, plain, bound))
        print(f"  {label} ks_carry_share {shape}, x{count}: equal; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{_fmt_bound(bound)}", flush=True)
    for name, rs in rows.items():
        if not rs:
            continue
        tot = [sum(r[1] * r[2] for r in rs), sum(r[1] * r[3] for r in rs),
               sum(r[1] * max(r[4]) for r in rs)]
        print(f"  {label} {name} per iteration ({sum(r[1] for r in rs)} "
              f"launches): kernel {tot[0]:.4f} ms, plain {tot[1]:.4f} ms, "
              f"bound {tot[2]:.4f} ms", flush=True)
    return rows


def kf_mm_in_place(label: str, spy, copies: int, zeros: int) -> None:
    """The cell's ring products copied no operand (`modmatmul.COPIES`) and
    launched one zero kernel for each product that its plan splits along K
    (`modmatmul.ZERO_LAUNCHES`), counted over the main path's run."""
    from repro_torch.kernels import modmatmul
    planned = {}
    for ((m, kdim, n), la, lb), count in spy.mm.items():
        p = modmatmul.plan(m, kdim, n, la is not None and la[0],
                           lb is not None and lb[0])
        planned[p.variant] = planned.get(p.variant, 0) + count
        zeros -= count * p.zeroed
    if copies or zeros:
        fail(f"{label}: ring_matmul copied {copies} operands and launched "
             f"{zeros} zero kernels more than planned")
    print(f"{label}: ring_matmul read every operand in place, launches by "
          f"variant {planned}, a zero kernel before each split one",
          flush=True)


def _same_words(label: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            fail(f"{label}: output {i} differs "
                 f"({int((g != w).sum())} of {g.numel()} words)")


def kf_roofline_ms(n: int, d: int, k: int, d_a: int,
                   sparse: bool) -> dict:
    """launch/roofline.py's one-chip step for the iteration: its FLOPs and
    bytes counted on meta tensors over the H100 data-sheet constants (the
    FLOPs are int64 ring products: over the ring rate, RING_OPS)."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import kmeans_step as KS
    fn, args = KS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                      device="meta")
    cost = dryrun.count_cost(fn, *args)
    compute = 1e3 * cost["flops"] / roofline.RING_OPS
    memory = 1e3 * cost["bytes"] / roofline.HBM_BW
    return {"flops": cost["flops"], "bytes": cost["bytes"],
            "compute_ms": compute, "memory_ms": memory,
            "step_ms": max(compute, memory)}


def kf_dense_cell(n: int) -> dict:
    """10a: the dense kmeans-fraud iteration at n, backend="cuda"."""
    from repro_torch.configs.kmeans_fraud import FULL
    from repro_torch.core import protocol, ring
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.kernels import modmatmul
    from repro_torch.launch import kmeans_step as KS
    d, k, d_a = FULL.d, FULL.k, FULL.d_a
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(KF_SEED)
    enc, lab = kf_data(gen, n, d, k)
    xa, xb = enc[:, :d_a].contiguous(), enc[:, d_a:].contiguous()
    # the start: one point of each blob (no two starts share a blob, so no
    # point is near-equidistant to two of them)
    mu_enc = enc[kf_first_of_each(lab, k)]
    del enc
    mu0, mu1 = kf_shares(gen, mu_enc)
    requests = KS.record_offline_shapes(n, d, k, d_a)
    t1 = time.perf_counter()
    dealer = TrustedDealer(seed=KF_SEED, device="cuda")
    flat = KS.materialize_offline(requests, dealer)
    torch.cuda.synchronize()
    dealer_s = time.perf_counter() - t1
    offline_gb = sum(t.numel() for t in flat) * 8 / 1e9
    print(f"10a: n={n}, d={d} ({d_a} + {d - d_a}), k={k}: data "
          f"{t1 - t0:.1f} s; {len(requests)} offline requests, "
          f"{offline_gb:.2f} GB of words, dealer {dealer_s:.1f} s "
          f"(host numpy, uploaded)", flush=True)

    fn, args = KS.online_iteration_fn(n, d, k, d_a, backend="cuda",
                                      device="cuda")
    if len(args) != 4 + len(flat):
        fail(f"10a: online_iteration_fn takes {len(args)} arguments, "
             f"{4 + len(flat)} expected")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counters()                       # the cell's main path
    t2 = time.perf_counter()
    fused = fn(xa, xb, mu0, mu1, *flat)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = _launch_counters()
    mm_meeting = (modmatmul.COPIES, modmatmul.ZERO_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name in ("ring_matmul", "ks_carry_share"):
        if not launches[name]:
            fail(f"10a: the iteration launched no {name}")
    print(f"10a: online_iteration_fn (S1 + S3, one dealer): "
          f"{wall * 1e3:.1f} ms synchronized; launches {launches}; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)

    progs = KS.fit_programs("vertical", False, (n, d_a), (n, d - d_a), k,
                            backend="cuda", device="cuda")
    if progs.s1_requests + progs.s3_requests != requests:
        fail("10a: the fused schedule is not S1's followed by S3's")
    cut = len(KS.offline_tensor_specs(progs.s1_requests, n))
    c = progs.s1(xa, xb, mu0, mu1, *flat[:cut])
    split = progs.s3(xa, xb, mu0, mu1, *c, *flat[cut:])
    _same_words("10a: fused vs the S1 -> S3 pair", fused, split)
    del split
    KS.clear_program_cache()

    fit_fn, _, fit_req = KS.fit_iteration_fn(n, d, k, d_a, backend="cuda",
                                             device="cuda")
    if fit_req != requests:
        fail("10a: fit_iteration_fn's schedule differs")
    with _CellSpy() as spy:
        out = fit_fn(xa, xb, mu0, mu1, *flat)
    kf_mm_in_place("10a", spy, *mm_meeting)
    _same_words("10a: fit_iteration_fn centroids", out[:2], fused)
    _same_words("10a: fit_iteration_fn assignment", out[2:], c)
    del out
    protocol.FUSE_BEAVER = False
    try:
        off = fn(xa, xb, mu0, mu1, *flat)
    finally:
        protocol.FUSE_BEAVER = True
    _same_words("10a: FUSE_BEAVER off vs on", off, fused)
    del off, flat, dealer
    print("10a: fused = S1 -> S3 = fit_iteration_fn (centroids and "
          "assignment), FUSE_BEAVER off = on, word for word", flush=True)

    # one plaintext Lloyd step from the same start on the same encoded data
    x = ring.decode(torch.cat([xa, xb], 1))
    start = ring.decode(mu_enc)
    dist = (start * start).sum(1)[None, :] - 2 * x @ start.T
    plain_lab = dist.argmin(1)
    del dist
    sums = torch.zeros((k, d), dtype=torch.float64, device="cuda")
    sums.index_add_(0, plain_lab, x)
    cnt = torch.bincount(plain_lab, minlength=k).to(torch.float64)
    want = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None],
                       start)
    del x, sums
    got = ring.decode(fused[0] + fused[1])
    err = float((got - want).abs().max())
    secure_lab = (c[0] + c[1]).argmax(1)
    agree = float((secure_lab == plain_lab).double().mean())
    if not err <= KF_ATOL or agree < KF_AGREE:
        fail(f"10a: centroids within {err} of a plaintext Lloyd step "
             f"(bound {KF_ATOL}), label agreement {agree:.5f} "
             f"(bound {KF_AGREE})")
    print(f"10a: centroids within {err:.3g} of one plaintext Lloyd step "
          f"(bound {KF_ATOL}); label agreement {agree:.5f}; "
          f"{int((cnt > 0).sum())} of {k} clusters non-empty", flush=True)
    del c, fused, xa, xb, mu0, mu1
    torch.cuda.empty_cache()

    rows = kf_kernel_rows(spy, KF_SEED + 1, "10a")
    roof = kf_roofline_ms(n, d, k, d_a, sparse=False)
    print(f"10a: roofline one-chip step {roof['step_ms']:.3f} ms "
          f"({roof['flops']:.4g} FLOPs -> {roof['compute_ms']:.3f} ms, "
          f"{roof['bytes']:.4g} bytes -> {roof['memory_ms']:.3f} ms; "
          f"data-sheet constants) against a measured "
          f"{wall * 1e3:.1f} ms", flush=True)
    return {"n": n, "wall_s": wall, "dealer_s": dealer_s,
            "offline_gb": offline_gb, "peak_gb": peak_gb,
            "launches": launches, "max_abs_err": err, "agreement": agree,
            "rows": rows, "roofline": roof}


def kf_sparse_cell() -> dict:
    """10b: the sparse kmeans-fraud iteration at the full n: the 8
    Protocol-2 result shares are words drawn from the seed (Protocol 2
    itself does not run at this size)."""
    from repro_torch.configs.kmeans_fraud import FULL
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.kernels import modmatmul
    from repro_torch.launch import kmeans_step as KS
    n, d, k, d_a = FULL.n, FULL.d, FULL.k, FULL.d_a
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(KF_SEED + 2)
    enc, lab = kf_data(gen, n, d, k, sparsity=FULL.sparsity)
    xa, xb = enc[:, :d_a].contiguous(), enc[:, d_a:].contiguous()
    mu0, mu1 = kf_shares(gen, enc[kf_first_of_each(lab, k)])
    del enc, lab
    he = [torch.randint(-2 ** 63, 2 ** 63 - 1, s, generator=gen,
                        dtype=torch.int64, device="cuda")
          for s in [(n, k), (n, k), (k, d_a), (k, d - d_a)] for _ in (0, 1)]
    requests = KS.record_offline_shapes(n, d, k, d_a, sparse=True)
    t1 = time.perf_counter()
    flat = KS.materialize_offline(requests, TrustedDealer(seed=KF_SEED + 2,
                                                          device="cuda"))
    torch.cuda.synchronize()
    dealer_s = time.perf_counter() - t1
    offline_gb = sum(t.numel() for t in flat) * 8 / 1e9
    print(f"10b: n={n}, d={d}, k={k}, {FULL.sparsity:.0%} zeros: data "
          f"{t1 - t0:.1f} s; {len(requests)} offline requests, "
          f"{offline_gb:.2f} GB of words, dealer {dealer_s:.1f} s",
          flush=True)
    fn, _ = KS.online_iteration_fn(n, d, k, d_a, sparse=True,
                                   backend="cuda", device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counters()
    t2 = time.perf_counter()
    with _CellSpy() as spy:
        fused = fn(xa, xb, mu0, mu1, *he, *flat)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = _launch_counters()
    kf_mm_in_place("10b", spy, modmatmul.COPIES, modmatmul.ZERO_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not launches["ks_carry_share"]:
        fail("10b: the iteration launched no ks_carry_share")
    progs = KS.fit_programs("vertical", True, (n, d_a), (n, d - d_a), k,
                            backend="cuda", device="cuda")
    if progs.s1_requests + progs.s3_requests != requests:
        fail("10b: the fused schedule is not S1's followed by S3's")
    cut = len(KS.offline_tensor_specs(progs.s1_requests, n))
    c = progs.s1(xa, xb, mu0, mu1, *he[:4], *flat[:cut])
    split = progs.s3(xa, xb, mu0, mu1, *c, *he[4:], *flat[cut:])
    _same_words("10b: fused vs the S1 -> S3 pair", fused, split)
    KS.clear_program_cache()
    print(f"10b: online_iteration_fn {wall * 1e3:.1f} ms synchronized; "
          f"launches {launches}; peak device memory {peak_gb:.2f} GB; "
          f"fused = S1 -> S3 word for word", flush=True)
    del fused, split, c, flat, he, xa, xb, mu0, mu1
    torch.cuda.empty_cache()
    rows = kf_kernel_rows(spy, KF_SEED + 3, "10b")
    return {"n": n, "wall_s": wall, "dealer_s": dealer_s,
            "offline_gb": offline_gb, "peak_gb": peak_gb,
            "launches": launches, "rows": rows}


def kf_walls(calls: int = 4) -> list:
    """`--cell-walls`: 10a's iteration (dense, n = 524,288, one dealer's
    list) called `calls` times in a row for the repro_torch under --src,
    each synchronized; the first is cold (a kernel's first launch in a
    process loads it, and the allocator grows), the rest warm. Run on two
    trees in one call to compare their iterations on one card. Returns the
    walls in ms."""
    from repro_torch.configs.kmeans_fraud import FULL
    from repro_torch.core.triples import TrustedDealer
    from repro_torch.launch import kmeans_step as KS
    n, d, k, d_a = KF_DENSE_N, FULL.d, FULL.k, FULL.d_a
    gen = torch.Generator(device="cuda")
    gen.manual_seed(KF_SEED)
    enc, lab = kf_data(gen, n, d, k)
    xa, xb = enc[:, :d_a].contiguous(), enc[:, d_a:].contiguous()
    mu0, mu1 = kf_shares(gen, enc[kf_first_of_each(lab, k)])
    del enc, lab
    flat = KS.materialize_offline(KS.record_offline_shapes(n, d, k, d_a),
                                  TrustedDealer(seed=KF_SEED, device="cuda"))
    fn, _ = KS.online_iteration_fn(n, d, k, d_a, backend="cuda",
                                   device="cuda")
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(xa, xb, mu0, mu1, *flat)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        del out
    print(json.dumps({"cell_walls_ms": walls}), flush=True)
    return walls


def kf_plans_start(src: pathlib.Path) -> dict:
    """10c: start the dry run and the roofline, each its own CPU process,
    writing into the ignored build/phase10/."""
    import shutil
    shutil.rmtree(PHASE10_DIR, ignore_errors=True)
    PHASE10_DIR.mkdir(parents=True)
    env = {**__import__("os").environ, "PYTHONPATH": str(src)}
    procs = {}
    for name, cmd in KF_PLAN_CMDS.items():
        out = PHASE10_DIR / f"{name}.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, *cmd, "--out", str(out)], cwd=str(ROOT),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def kf_plans_check(procs: dict) -> dict:
    """10c: each process exits 0 with no error record and no
    `collective_error`, never created a CUDA context, and its records
    format through benchmarks/report.py. Prints the kmeans-fraud cell's
    collectives on each mesh and the roofline's three terms; fails where
    the collective term is missing. Returns those."""
    from benchmarks.report import dryrun_table, roofline_table
    summary = {}
    for name, (path, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"10c: {name} did not finish in 600 s")
        last = log.strip().splitlines()[-1] if log.strip() else ""
        if proc.returncode != 0 or "cuda_initialized=False" not in last:
            fail(f"10c: {name} exited {proc.returncode}: {log[-2000:]}")
        recs = json.loads(path.read_text())
        bad = [r for r in recs if r.get("status") == "error"
               or "collective_error" in r]
        if bad or not recs:
            fail(f"10c: {name}: {len(recs)} records, errors {bad}")
        if name == "dryrun_tp_ratios":
            summary["tp_ratios"] = kf_tp_ratios(recs, last)
            continue
        table = (roofline_table if name.startswith("roofline")
                 else dryrun_table)(str(path))
        print(f"10c: {name}: {last}", flush=True)
        print(table, flush=True)
        for r in recs:
            if r.get("arch") != "kmeans-fraud":
                continue
            if name.startswith("roofline"):
                if not isinstance(r.get("collective_s"), float):
                    fail(f"10c: the kmeans-fraud roofline row has no "
                         f"collective term: {r}")
                terms = {k: r[f"{k}_s"] for k in ("compute", "memory",
                                                  "collective")}
                summary["roofline"] = {**terms, "dominant": r["dominant"]}
                print(f"10c: kmeans-fraud roofline terms (s, H100 "
                      f"data-sheet constants): {json.dumps(terms)}, "
                      f"dominant {r['dominant']}", flush=True)
            else:
                coll = r["collectives"]
                if coll["all-reduce"] <= 0:
                    fail(f"10c: kmeans-fraud on {r['mesh_name']}: no "
                         f"all-reduce counted: {coll}")
                summary[f"collectives_{r['mesh_name']}"] = coll
                print(f"10c: kmeans-fraud collectives on {r['mesh_name']} "
                      f"({r['mesh']}), bytes a device: {json.dumps(coll)}",
                      flush=True)
    if set(summary) != {"roofline", "collectives_single",
                        "collectives_multi", "tp_ratios"}:
        fail(f"10c: kmeans-fraud records missing: {sorted(summary)}")
    return summary


def kf_tp_ratios(recs: list, last: str) -> dict:
    """10c: `dryrun --tp-ratios`' records: every arch's reduced train_4k
    at global batch 2 on a fake (data=2, model=4) mesh, counted per device
    with its collectives, its ratio (the first device's FLOPs times 8 over
    the step's global FLOPs) at most its bound. Prints each arch's ratio;
    returns {arch: ratio}."""
    from repro_torch.launch.dryrun import tp_ratio_fails
    ratios = {}
    for r in recs:
        print(f"10c: tp ratio {r['arch']} {r['shape']} gb "
              f"{r['global_batch']} on {r['mesh']}: "
              f"{r['ratio'] or float('nan'):.4f} "
              f"(bound {r['bound']:.2f}, {r['count_basis']})", flush=True)
        if tp_ratio_fails(r):
            fail(f"10c: {r['arch']} repeats work over 'model': {r}")
        ratios[r["arch"]] = r["ratio"]
    print(f"10c: dryrun_tp_ratios: {last}", flush=True)
    return ratios


def kf_dev_mesh() -> int:
    """10d: the (1,1) device mesh on the card (a world-size-1 nccl group);
    a reduced dense config's tree placed by `param_shardings` keeps every
    local shape and word. Returns the leaves placed."""
    import torch.distributed as dist
    from repro_torch.configs.base import all_archs
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import sharding as S
    from repro_torch.models.lm import init_params
    from repro_torch.models.tree import leaves
    mesh = make_dev_mesh()
    try:
        params = init_params(all_archs()["granite-34b"].reduced, 0,
                             device="cuda")
        sh = S.param_shardings(mesh, params)
        n = 0
        for t, s in zip(leaves(params), leaves(sh)):
            local = s.place(t).to_local()
            if tuple(local.shape) != tuple(t.shape) \
                    or local.device.type != "cuda" or not torch.equal(local,
                                                                      t):
                fail(f"10d: a leaf of shape {tuple(t.shape)} placed by "
                     f"{s.spec} has local shape {tuple(local.shape)}")
            n += 1
    finally:
        dist.destroy_process_group()
    print(f"10d: dev mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on the "
          f"card: {n} leaves placed, each local shape = its global shape",
          flush=True)
    return n


def phase_kmeans_cell(src: pathlib.Path) -> dict:
    """Phase 10 (10a-10d). Returns the cell's record."""
    import shutil
    t0 = time.perf_counter()
    _cold_caches()
    torch.cuda.empty_cache()
    procs = kf_plans_start(src)
    try:
        dense = kf_dense_cell(KF_DENSE_N)
        torch.cuda.empty_cache()
        sparse = kf_sparse_cell()
        torch.cuda.empty_cache()
        plans = kf_plans_check(procs)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(PHASE10_DIR, ignore_errors=True)
    leaves_placed = kf_dev_mesh()
    seconds = time.perf_counter() - t0
    print(f"phase 10: {seconds:.1f} s", flush=True)
    cell = {"dense": {k: v for k, v in dense.items() if k != "rows"},
            "sparse": {k: v for k, v in sparse.items() if k != "rows"},
            "dev_mesh_leaves": leaves_placed, "plans": plans,
            "seconds": seconds}
    print("KMEANS_CELL " + json.dumps(cell, default=str), flush=True)
    return {"dense": dense, "sparse": sparse, "seconds": seconds}


def longw_blocks_probe() -> dict:
    """The long-K wide launch at 10a's (16, n) @ (n, 512), A transposed,
    with its K split over each of LONGW_PROBE_BLOCKS blocks (two fit an SM
    at once; the plan takes 8 an SM, in four waves): every block adds its
    8192 sums to C by atomicAdd, so the time that more blocks add is the
    meeting's cost. Each held to the plain
    version. Returns {blocks: ms}; {} when the tree under test plans the
    shape to another variant (a parent commit)."""
    from repro_torch.kernels import modmatmul
    (m, kdim, n), a_kind, b_kind, _ = KF_MM_PER_ITER[1]
    if modmatmul.plan(m, kdim, n, True, False).variant != "longw":
        return {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(KF_SEED + 5)
    a = fit_operand(gen, m, kdim, a_kind, KF_D)
    b = fit_operand(gen, kdim, n, b_kind, KF_D)
    want = modmatmul.ring_matmul_plain(a.contiguous(), b)
    plan = modmatmul.plan
    out = {}
    try:
        for blocks in LONGW_PROBE_BLOCKS:
            modmatmul.plan = lambda *args, **kw: plan(*args, **kw)._replace(
                blocks=blocks)
            if not torch.equal(modmatmul.ring_matmul(a, b), want):
                fail(f"ring_matmul long-K wide at {blocks} blocks differs "
                     f"from its plain version")
            out[blocks] = device_ms(modmatmul.ring_matmul, [(a, b)])
    finally:
        modmatmul.plan = plan
    print(f"ring_matmul ({m},{kdim})@({kdim},{n}) A {a_kind}, long-K wide "
          f"at {', '.join(f'{k} blocks {v:.4f} ms' for k, v in out.items())}",
          flush=True)
    return out


def kernel_times(src: pathlib.Path, smi_line: str) -> None:
    """`--kernel-times`: ring_matmul at the dense and sparse fits' own
    layouts and at the kmeans-fraud cell's (10a and 10b, fresh words, no
    dealer), with the long-K wide launch at three block counts, esd beside
    addmm + norms at the phase-5 shapes, and spmm_ell at every shape of the
    sparse fit (phase 4b) and of the kernel API (phase 5, the drive's C^T x
    included), each held to its plain version first, for the repro_torch
    package under `src`. Run it on two trees in
    one call, in turns, to compare their kernels on one card. Prints one
    JSON line of the times."""
    from repro_torch.configs.kmeans_fraud import FULL
    if (FULL.d, FULL.d_a, FULL.k, FULL.n) != (KF_D, KF_D_A, KF_K, KF_FULL_N):
        fail(f"KF_MM_PER_ITER's widths are not configs/kmeans_fraud.py "
             f"FULL's ({FULL.d}, {FULL.d_a}, {FULL.k}, {FULL.n})")
    out = {"src": str(src), "card": smi_line, "ring_matmul": {}, "esd": {},
           "spmm_ell": {}}
    for label, table, width, seed in (
            ("dense", MM_FIT_PER_ITER, DA + DB, SEED),
            ("sparse", SP_MM_FIT_PER_ITER, SP_DA + SP_DB, SEED + 1),
            ("cell_10a", KF_MM_PER_ITER, KF_D, KF_SEED + 1),
            ("cell_10b", KF_SP_MM_PER_ITER, KF_D, KF_SEED + 3)):
        rows = time_fit_layouts(table, width, seed, label)
        per_case = {f"{m}x{kd}x{n} A {a} B {b}": rows[((m, kd, n), a, b)][0]
                    for (m, kd, n), a, b, _ in table}
        out["ring_matmul"][label] = {
            "per_iteration_ms": sum(c * rows[(sh, a, b)][0]
                                    for sh, a, b, c in table),
            "bound_ms": sum(c * max(rows[(sh, a, b)][2])
                            for sh, a, b, c in table),
            "cases_ms": per_case}
        torch.cuda.empty_cache()
    out["ring_matmul"]["longw_blocks_ms"] = longw_blocks_probe()
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
    if "--scoring-server" in args:
        i = args.index("--scoring-server")
        scoring_server(args[i + 1:i + 4])
        return
    smi_line = setup()
    from repro_torch.kernels import spmm
    if hasattr(spmm, "NARROW_WIDTHS") \
            and spmm.NARROW_WIDTHS[-1] != ELL_DENSE_MAX_K:
        fail(f"ELL_DENSE_MAX_K {ELL_DENSE_MAX_K} is not the narrow spmm "
             f"kernel's widest Y ({spmm.NARROW_WIDTHS[-1]})")
    if "--kernel-times" in args:
        kernel_times(src, smi_line)
        return
    if "--cell" in args:
        phase_kmeans_cell(src)
        print(smi_line)
        return
    if "--cell-walls" in args:
        kf_walls()
        print(smi_line)
        return
    rows, worst = phase_kernels(np.random.default_rng(SEED))
    fit_rows = time_fit_layouts(MM_FIT_PER_ITER, DA + DB, SEED, "dense")
    time_fit_layouts(SP_MM_FIT_PER_ITER, SP_DA + SP_DB, SEED + 1, "sparse")
    sp_rows, worst["spmm_ell"] = phase_spmm(np.random.default_rng(SEED + 1))
    phase_gpu_equals_cpu()
    phase_sparse_gpu_equals_cpu(SP_K, OFFLINE_MODES)
    phase_sparse_gpu_equals_cpu(SP_WIDE_K)
    phase_minibatch_gpu_equals_cpu()
    phase_scoring_gpu_equals_cpu()
    phase_numpy_backend(smi_line)
    launches, full_per_iter, full_pooled, dense = phase_main_path()
    sp_launches, sp_iter, sp_pooled = phase_sparse_main_path()
    sp_seq, sp_seq_launches, mb_pooled = phase_minibatch_main_path(
        full_per_iter, full_pooled)
    score_launches = phase_scoring(full_per_iter, full_pooled, sp_pooled)
    torch.cuda.empty_cache()
    durable = phase_durability(src, full_pooled, sp_seq, sp_seq_launches)
    del full_pooled, sp_seq
    observed = phase_observability(src, dense, sp_pooled, mb_pooled)
    del dense, sp_pooled, mb_pooled
    torch.cuda.empty_cache()
    data = api_data()
    api_launches = phase_api_main_path(data)
    api_rows, api_worst = phase_api_kernels(data)
    worst["spmm_ell"] = max(worst["spmm_ell"], api_worst["spmm_ell_k10"])
    del data
    _cold_caches()                   # the K-means programs' device buffers
    torch.cuda.empty_cache()
    phase_lm()
    cell = phase_kmeans_cell(src)

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

    # the kmeans-fraud cell's products (PERF.md row 1c): per iteration of
    # 10a and 10b, at the layouts its iteration passed (kf_kernel_rows)
    def cell_mm(label):
        rs = cell[label]["rows"]["ring_matmul"]
        return {"ms": sum(r[1] * r[2] for r in rs),
                "plain_ms": sum(r[1] * r[3] for r in rs),
                "bound_ms": sum(r[1] * max(r[4]) for r in rs),
                "launches": sum(r[1] for r in rs)}
    ks = per_iter("ks_carry_share", KS_PER_ITER)
    libs = [sp_rows[s][3] for s in ("S1", "S3")]
    lib_ms = None if None in libs else 2 * sum(libs)
    kernels = [
        {"name": "ring_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/modmatmul.cu",
         "replaces": "src/repro/kernels/modmatmul.py:71",
         "launches": launches["ring_matmul"],
         "scoring_launches": score_launches["ring_matmul"],
         "durability_launches": durable["ring_matmul"],
         "observability_launches": observed["ring_matmul"],
         "kmeans_cell_launches": cell["dense"]["launches"]["ring_matmul"],
         "kmeans_cell": cell_mm("dense"),
         "kmeans_cell_sparse": cell_mm("sparse"),
         "max_abs_err": worst["ring_matmul"],
         "ms": mm[0], "plain_ms": mm[1], "bound_ms": mm[2],
         "bound_by": mm[3], "library_ms": None},
        {"name": "ks_carry_share", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ksadder.cu",
         "replaces": "src/repro/kernels/ksadder.py:56",
         "launches": launches["ks_carry_share"],
         "scoring_launches": score_launches["ks_carry_share"],
         "durability_launches": durable["ks_carry_share"],
         "observability_launches": observed["ks_carry_share"],
         "kmeans_cell_launches": cell["dense"]["launches"]["ks_carry_share"],
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
         "scoring_launches": score_launches["spmm_ell"],
         "durability_launches": durable["spmm_ell"],
         "observability_launches": observed["spmm_ell"],
         "kmeans_cell_launches": cell["dense"]["launches"]["spmm_ell"],
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
