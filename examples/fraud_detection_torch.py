"""Paper Sec 5.6 deployment on the PyTorch/CUDA port: a payment company and
a merchant jointly detect fraudulent transactions with secure K-means;
nothing but the outlier scores is revealed. Shows the single-party vs
joint-modelling gap, then serves new transactions through the
`ScoringService` (batch ladder, TripleBank provisioned offline).

Scoring runs through the secure `SecureKMeans.score` path: each
transaction's squared distance to its assigned centroid is computed on
SHARES against the secret-shared model, and only those scores are revealed
— never the centroids or per-transaction cluster labels.

    PYTHONPATH=src python examples/fraud_detection_torch.py          # GPU
    PYTHONPATH=src python examples/fraud_detection_torch.py --cpu    # CPU
"""
import argparse

import numpy as np

from repro_torch.core.fraud import (FraudDataset, detect_outliers,
                                    fraud_scores, jaccard,
                                    run_plaintext_fraud, run_secure_fraud)
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.serve import ScoringService


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch backend on the CPU")
    args = ap.parse_args()
    where = dict(backend="torch", device="cpu") if args.cpu else {}
    # 4,000 transactions to fit on, 600 more arriving afterwards
    both = FraudDataset.synthesize(n=4600, d_a=18, d_b=24, n_clusters=5,
                                   frac_outlier=0.02, seed=3)
    ds = FraudDataset(both.x_a[:4000], both.x_b[:4000],
                      both.y_outlier[:4000])
    j_joint, res = run_secure_fraud(ds, k=5, iters=10, seed=3,
                                    offline="pooled", **where)
    j_plain = run_plaintext_fraud(ds, k=5, iters=10, seed=3)
    j_single = run_plaintext_fraud(ds, k=5, iters=10, seed=3,
                                   party_a_only=True)
    print("Jaccard vs ground-truth fraud set")
    print(f"  secure joint, secure scoring : {j_joint:.3f}")
    print(f"  plaintext joint (oracle)     : {j_plain:.3f}")
    print(f"  payment-company only         : {j_single:.3f}")
    print("(the paper reports: ours 0.86, M-Kmeans 0.83, single-party 0.62)")
    print(f"online traffic {res.log.total_bytes('online')/2**20:.1f} MB "
          f"in {res.log.total_rounds('online')} rounds")
    leaky = fraud_scores(None, res, ds, reveal_model=True)
    j_leaky = jaccard(detect_outliers(leaky, 0.02), ds.y_outlier)
    print(f"  reveal_model=True hatch      : {j_leaky:.3f} "
          "(same quality, leaks the model)")

    # serve a stream of new transactions against the fitted model
    km = SecureKMeans(KMeansConfig(k=5, iters=10, seed=3, **where))
    svc = ScoringService(km, res, d_a=18, d_b=24, provision_copies=3)
    sizes = np.random.default_rng(11).poisson(48, 12)
    lo = 4000
    for m in sizes:
        svc.submit(both.x_a[lo:lo + m], both.x_b[lo:lo + m])
        lo += m
    out = svc.drain()
    st = svc.stats.as_dict()
    print(f"service: {st['requests']} requests, {st['rows']} rows in "
          f"{st['launches']} calls (pad overhead {st['pad_overhead']}), "
          f"{st['rows_per_s']} rows/s, p50 {st['p50_ms']} ms, p99 "
          f"{st['p99_ms']} ms; offline warm-up {svc.offline_seconds:.2f} s; "
          f"first request's scores {np.round(out[0].scores[:3], 3)}")


if __name__ == "__main__":
    main()
