"""Sparsity-aware mode of the PyTorch/CUDA port (paper Sec 4.3): one-hot-
heavy features, Protocol 2 (HE x SS sparse matmul) replacing the dense
Beaver path. Compares online traffic of both modes on the same data — the
paper's headline win — and checks both against plaintext K-means.

    PYTHONPATH=src python examples/sparse_vertical_torch.py          # GPU
    PYTHONPATH=src python examples/sparse_vertical_torch.py --cpu    # CPU
"""
import argparse

import numpy as np

from repro_torch.core.channel import WAN
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans, plaintext_kmeans


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch backend on the CPU")
    args = ap.parse_args()
    rng = np.random.default_rng(11)
    n, d, k, sparsity = 3000, 256, 3, 0.9
    centers = rng.uniform(-2, 2, (k, d))
    lab = rng.integers(0, k, n)
    x = (centers[lab] + rng.normal(0, 0.3, (n, d)))
    x *= rng.random((n, d)) >= sparsity          # 90% zeros (one-hot-ish)

    half = d // 2
    where = dict(backend="torch", device="cpu") if args.cpu else {}
    out = {}
    for sparse in (False, True):
        cfg = KMeansConfig(k=k, iters=5, seed=2, sparse=sparse, **where)
        res = SecureKMeans(cfg).fit(x[:, :half], x[:, half:])
        out[sparse] = res
        mode = "Protocol-2 (HE x SS)" if sparse else "dense Beaver SS"
        b = res.log.total_bytes("online")
        print(f"{mode:22s}: online {b/2**20:8.1f} MB, "
              f"WAN est {WAN.time_s(b, res.log.total_rounds('online')) + res.he_seconds:7.1f}s, "
              f"HE cpu {res.he_seconds:6.1f}s, loop {res.loop_seconds:.2f}s "
              f"({cfg.backend} on {cfg.device})")
    agree = (out[True].labels_plain() == out[False].labels_plain()).mean()
    _, ref = plaintext_kmeans(x, k, 5, seed=2)
    print(f"assignment agreement dense vs sparse: {agree:.1%}; sparse vs "
          f"plaintext K-means: {(out[True].labels_plain() == ref).mean():.1%}")


if __name__ == "__main__":
    main()
