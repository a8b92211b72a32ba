"""Fraud detection on top of secure K-means (paper Sec 5.6).

K-means-based outlier detection: cluster jointly, score each transaction by
the squared distance to its assigned centroid, flag the top fraction as
outliers, evaluate with the Jaccard coefficient J(R, R*) = |R n R*|/|R u R*|
against ground truth.

The secure pipeline reveals ONLY the per-transaction outlier scores (the
paper's "output"): scoring runs through `SecureKMeans.score`, the batched
secure distances and argmin against the secret-shared centroids, so
neither centroids nor cluster labels are ever reconstructed.
`reveal_model=True` is an explicit escape hatch that reconstructs the model
and scores in plaintext (cheaper, leaks the model).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.kmeans import (KMeansConfig, KMeansResult, SecureKMeans,
                                     plaintext_kmeans)


def jaccard(r: np.ndarray, r_star: np.ndarray) -> float:
    a, b = set(np.flatnonzero(r)), set(np.flatnonzero(r_star))
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


def outlier_scores(x: np.ndarray, centroids: np.ndarray,
                   labels: np.ndarray) -> np.ndarray:
    return ((x - centroids[labels]) ** 2).sum(1)


def detect_outliers(scores: np.ndarray, frac: float) -> np.ndarray:
    q = np.quantile(scores, 1.0 - frac)
    return scores > q


@dataclasses.dataclass
class FraudDataset:
    """Synthetic two-party fraud data shaped like the paper's deployment:
    the payment company holds transaction and partial user features, the
    merchant behavioural features; ~frac_outlier planted frauds off the
    clusters."""

    x_a: np.ndarray
    x_b: np.ndarray
    y_outlier: np.ndarray

    @classmethod
    def synthesize(cls, n: int = 10_000, d_a: int = 18, d_b: int = 24,
                   n_clusters: int = 5, frac_outlier: float = 0.02,
                   seed: int = 0) -> "FraudDataset":
        rng = np.random.default_rng(seed)
        d = d_a + d_b
        centers = rng.uniform(-3, 3, (n_clusters, d))
        lab = rng.integers(0, n_clusters, n)
        x = centers[lab] + rng.normal(0, 0.35, (n, d))
        n_out = int(n * frac_outlier)
        out_idx = rng.choice(n, n_out, replace=False)
        # the fraud displacement lives (almost) entirely in the MERCHANT's
        # behavioural features: the payment company alone cannot see it —
        # the paper's motivation for joint modelling (Sec 5.6)
        x[out_idx, :d_a] += rng.normal(0, 0.2, (n_out, d_a))
        x[out_idx, d_a:] += rng.normal(0, 1.5, (n_out, d_b)) + 4.0 * rng.choice(
            [-1, 1], (n_out, 1))
        y = np.zeros(n, bool)
        y[out_idx] = True
        return cls(x[:, :d_a], x[:, d_a:], y)


def fraud_scores(km: SecureKMeans | None, res: KMeansResult,
                 ds: FraudDataset, reveal_model: bool = False) -> np.ndarray:
    """Per-transaction outlier scores from a fitted secure model.

    Default: the secure scoring path — `SecureKMeans.score` computes
    ||x - mu_c||^2 on shares and reveals only the scores. reveal_model=True
    reconstructs centroids AND labels in plaintext first (an explicit
    escape hatch); that branch runs no protocol, so `km` may be None."""
    if reveal_model:
        x = np.concatenate([ds.x_a, ds.x_b], 1)
        return outlier_scores(x, res.centroids_plain(), res.labels_plain())
    if km is None:
        raise ValueError("secure scoring needs the SecureKMeans instance")
    return km.score(ds.x_a, ds.x_b, res).scores_plain()


def run_secure_fraud(ds: FraudDataset, k: int = 5, iters: int = 10,
                     frac: float = 0.02, seed: int = 0, sparse: bool = False,
                     reveal_model: bool = False, **cfg_kw):
    """Joint secure pipeline -> (Jaccard vs ground truth, fit result). Only
    the outlier scores are revealed (see `fraud_scores`). `cfg_kw` goes to
    `KMeansConfig` (e.g. `offline="pooled"`, or `backend="torch",
    device="cpu"` to run on the CPU)."""
    cfg = KMeansConfig(k=k, iters=iters, partition="vertical", seed=seed,
                       sparse=sparse, **cfg_kw)
    km = SecureKMeans(cfg)
    res = km.fit(ds.x_a, ds.x_b)
    scores = fraud_scores(km, res, ds, reveal_model=reveal_model)
    pred = detect_outliers(scores, frac)
    return jaccard(pred, ds.y_outlier), res


def run_plaintext_fraud(ds: FraudDataset, k: int = 5, iters: int = 10,
                        frac: float = 0.02, seed: int = 0,
                        party_a_only: bool = False) -> float:
    """Plaintext baseline: joint features, or payment-company-only (the
    paper's single-party comparison, Sec 5.6)."""
    x = ds.x_a if party_a_only else np.concatenate([ds.x_a, ds.x_b], 1)
    mu, lab = plaintext_kmeans(x, k, iters, seed=seed)
    pred = detect_outliers(outlier_scores(x, mu, lab), frac)
    return jaccard(pred, ds.y_outlier)
