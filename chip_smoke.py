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
  5. prints one JSON line of per-kernel launches, times and bounds, the
     nvidia-smi line, and finally {"ok": true, "device": {...}}.

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


def phase_main_path():
    """The full-width secure fit through the user's entry point, with the
    launch counters read around it."""
    from repro_torch.core.kmeans import (KMeansConfig, SecureKMeans,
                                         plaintext_kmeans)
    from repro_torch.kernels import ksadder, modmatmul
    x = _blobs(np.random.default_rng(SEED + 7), N, DA + DB, K)
    cfg = KMeansConfig(k=K, iters=ITERS, partition="vertical", seed=SEED)
    modmatmul.LAUNCHES = 0
    ksadder.LAUNCHES = 0
    res = SecureKMeans(cfg).fit(x[:, :DA], x[:, DA:])
    launches = {"ring_matmul": modmatmul.LAUNCHES,
                "ks_carry_share": ksadder.LAUNCHES}
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
    print(f"launches in the main path: {launches} (expected per iteration "
          f"from the code: ring_matmul {sum(c for _, c in MM_PER_ITER)}, "
          f"ks_carry_share {sum(c for _, c in KS_PER_ITER)})", flush=True)
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
    phase_gpu_equals_cpu()
    launches = phase_main_path()

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
