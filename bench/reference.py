"""The plain reference: Lloyd's algorithm in float64 over the benchmark's
own fixed-point words, and the comparison that decides `correct`.

Plain PyTorch. It imports nothing of the program and takes nothing that
the program made: the data words and the start are the benchmark's, and
the program's revealed outputs are read only to be judged.
"""
from __future__ import annotations

import torch

FRAC_BITS = 20
ROW_ELEMS = 1 << 26          # elements of one block of decoded rows


def decode(words: torch.Tensor, f: int = FRAC_BITS) -> torch.Tensor:
    """Two's-complement fixed-point words -> float64 reals."""
    return words.to(torch.float64) / float(1 << f)


def lloyd(xa: torch.Tensor, xb: torch.Tensor, start: torch.Tensor,
          iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`iters` Lloyd iterations over the rows [xa | xb] (words) from the
    centroids `start` (words), on their device, in blocks of rows.
    Returns (the last iteration's assignment (n,), the centroids after
    it (k, d) float64). A centroid whose cluster is empty keeps its value,
    as the protocol's guard does."""
    if iters < 1:
        raise ValueError("lloyd needs at least one iteration")
    n, d = xa.shape[0], xa.shape[1] + xb.shape[1]
    mu = decode(start)
    k = mu.shape[0]
    block = max(1, ROW_ELEMS // d)
    lab = torch.empty(n, dtype=torch.int64, device=xa.device)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float64, device=xa.device)
        counts = torch.zeros(k, dtype=torch.float64, device=xa.device)
        norms = (mu * mu).sum(1)
        for i in range(0, n, block):
            x = decode(torch.cat([xa[i:i + block], xb[i:i + block]], 1))
            part = (norms[None, :] - 2 * x @ mu.T).argmin(1)
            lab[i:i + block] = part
            sums.index_add_(0, part, x)
            counts += torch.bincount(part, minlength=k).to(torch.float64)
        mu = torch.where(counts[:, None] > 0,
                         sums / counts.clamp(min=1)[:, None], mu)
    return lab, mu


def reveal_labels(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """The assignment from its two shares of a one-hot (n, k): each row's
    cluster, or -1 where the row is not a one-hot."""
    onehot = c0 + c1
    ok = ((onehot == 0) | (onehot == 1)).all(1) & (onehot.sum(1) == 1)
    return torch.where(ok, onehot.argmax(1), -1)


def reveal_centroids(mu0: torch.Tensor, mu1: torch.Tensor) -> torch.Tensor:
    return decode(mu0 + mu1)


def _max_abs(diff: torch.Tensor) -> float:
    """The largest |entry|; infinite where one is not finite."""
    diff = diff.abs()
    return float(diff.max()) if bool(torch.isfinite(diff).all()) \
        else float("inf")


def judge(labels: torch.Tensor, centroids: torch.Tensor,
          want_labels: torch.Tensor, want_centroids: torch.Tensor,
          limits: dict) -> dict:
    """The numbers compared, each beside its limit:
    mislabel_share  the share of rows assigned another cluster than the
                    reference assigns (a row that is no one-hot counts);
    centroid_err    the largest absolute difference of a centroid
                    coordinate (not finite: infinite);
    centroid_resid  the same after each reference centroid is scaled by
                    the least-squares factor that fits it to the
                    program's: the Newton reciprocal of the counts errs
                    by a factor a cluster, a mean over the wrong rows
                    does not.
    Returns {name: {"value", "limit"}} and "correct"."""
    mislabel = float((labels != want_labels).double().mean())
    numbers = {"mislabel_share": mislabel,
               "centroid_err": _max_abs(centroids - want_centroids)}
    norm = (want_centroids * want_centroids).sum(1, keepdim=True)
    scale = (centroids * want_centroids).sum(1, keepdim=True) \
        / norm.clamp(min=1e-300)
    numbers["centroid_resid"] = _max_abs(centroids - scale * want_centroids)
    out = {name: {"value": v, "limit": float(limits[name])}
           for name, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in out.values())
    return {"numbers": out, "correct": correct}
