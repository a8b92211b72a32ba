"""Carrying shares across between this package and numpy.

Share words cross as uint64 numpy arrays — the form the JAX package's shares
take on the host — so a result of either package can be fed into the other
and compared word for word.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ring
from repro_torch.core.channel import CommLog
from repro_torch.core.kmeans import KMeansResult
from repro_torch.core.sharing import AShare


def shares_from_numpy(s0_u64, s1_u64, device="cpu") -> AShare:
    """Two uint64 share arrays -> an AShare of int64 words on `device`."""
    return AShare(ring.from_u64_numpy(s0_u64, device),
                  ring.from_u64_numpy(s1_u64, device))


def shares_to_numpy(a: AShare) -> tuple[np.ndarray, np.ndarray]:
    """An AShare (or BShare) -> its two share arrays as uint64 numpy words."""
    return ring.to_u64_numpy(a[0]), ring.to_u64_numpy(a[1])


def result_from_reference(arrays: dict, *, iters_run: int = 0,
                          device="cpu") -> KMeansResult:
    """A fit result of this package built from another fit's share words.

    `arrays` maps "centroids" and "assignment" to (s0, s1) pairs of uint64
    numpy arrays. The result carries only the shares (empty log, no dealer,
    zero timings), so `centroids_plain` / `labels_plain` reconstruct them."""
    return KMeansResult(
        centroids=shares_from_numpy(*arrays["centroids"], device=device),
        assignment=shares_from_numpy(*arrays["assignment"], device=device),
        iters_run=iters_run, log=CommLog(), dealer=None,
        online_seconds=0.0, offline_dealer_seconds=0.0,
        offline_modelled_ot_seconds=0.0)
