"""Quickstart for the PyTorch/CUDA port: two parties jointly cluster
vertically-partitioned data with the privacy-preserving K-means protocol on
the GPU, reconstruct only the result, and compare against plaintext Lloyd.

    PYTHONPATH=src python examples/quickstart_torch.py          # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --cpu    # plain PyTorch
"""
import argparse

import numpy as np

from repro_torch.core.channel import LAN, WAN
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans, plaintext_kmeans


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch backend on the CPU")
    args = ap.parse_args()
    rng = np.random.default_rng(7)
    n, d, k = 2000, 8, 4
    centers = rng.uniform(-4, 4, (k, d))
    labels = rng.integers(0, k, n)
    x = centers[labels] + rng.normal(0, 0.3, (n, d))

    # party A = payment company (first 4 features), B = merchant (last 4)
    x_a, x_b = x[:, :4], x[:, 4:]

    where = dict(backend="torch", device="cpu") if args.cpu else {}
    cfg = KMeansConfig(k=k, iters=10, partition="vertical", seed=1, **where)
    res = SecureKMeans(cfg).fit(x_a, x_b)

    _, lab_ref = plaintext_kmeans(x, k, 10, seed=1)
    agree = (res.labels_plain() == lab_ref).mean()

    print(f"samples={n} d={d} k={k}  iters={res.iters_run}  "
          f"backend={cfg.backend} device={cfg.device}")
    print(f"agreement with plaintext K-means: {agree:.1%}")
    print(f"online  : {res.online_seconds:.2f}s wall, "
          f"{res.log.total_bytes('online')/2**20:.1f} MB, "
          f"{res.log.total_rounds('online')} rounds")
    print(f"offline : dealer {res.offline_dealer_seconds:.2f}s "
          f"(OT-model {res.offline_modelled_ot_seconds:.1f}s), "
          f"{res.log.total_bytes('offline')/2**20:.1f} MB")
    for net in (LAN, WAN):
        est = res.wan_lan_estimate(net)
        print(f"{net.name}: online {est['online_s']:.1f}s, "
              f"total {est['total_s']:.1f}s")


if __name__ == "__main__":
    main()
