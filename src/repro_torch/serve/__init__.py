"""Secure scoring and serving.

Turns a fitted `SecureKMeans` model into a service: arrival batches of new
transactions are padded onto a small ladder of `predict_program`
geometries, scored against the secret-shared centroids (assignments
and/or outlier scores are the ONLY reveals), and fed correlated randomness
from a `TripleBank` provisioned offline on the model's device.
`ScoringServer` / `ScoringClient` put the service on the wire.
"""
from repro_torch.serve.service import (ERR_DEADLINE, ERR_QUEUE_FULL,
                                       BatchLadder, ScoringResponse,
                                       ScoringService, ServiceStats)
from repro_torch.serve.wire import ScoringClient, ScoringServer

__all__ = ["BatchLadder", "ScoringClient", "ScoringResponse",
           "ScoringServer", "ScoringService", "ServiceStats", "ERR_DEADLINE",
           "ERR_QUEUE_FULL"]
