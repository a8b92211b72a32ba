"""The port's ScoringService against the JAX package's (backend="xla"), and
the fraud pipeline and the normalizations beside it: the service's
responses, bank draws and traffic equal the JAX service's word for word,
pipeline on and off; padded, coalesced scoring equals direct scoring
(labels exactly, scores to the fixed-point LSB); admission control,
deadlines and the bounded retries of a poisoned request; the exactly-once
restart from a `ServeCheckpointer` (either package's directory) and the
wire frontend (`ScoringServer` / `ScoringClient`) under keyed faults. The
contracts are those of the reference's tests/test_serve.py and
tests/test_serve_plane.py."""
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint.serve import ServeCheckpointer as JServeCheckpointer
from repro.core import fraud as JF
from repro.core import kmeans as JK
from repro.core import normalize as JN
from repro.core import protocol as JP
from repro.serve import ScoringService as JScoringService
from repro_torch.checkpoint.serve import ServeCheckpointer
from repro_torch.core import channel as C
from repro_torch.core import fraud as F
from repro_torch.core import normalize as N
from repro_torch.core import protocol as P
from repro_torch.core import triples as T
from repro_torch.core.interop import result_from_reference, shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.obs import trace as _trace
from repro_torch.serve import (ERR_DEADLINE, ERR_QUEUE_FULL, BatchLadder,
                               ScoringClient, ScoringResponse, ScoringServer,
                               ScoringService)


def _blobs(n, d, k, seed, sparse_frac=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.normal(0, 0.3, (n, d))
    if sparse_frac:
        x = x * (rng.random((n, d)) >= sparse_frac)
    return x


def _split(x, partition):
    n, d = x.shape
    if partition == "vertical":
        return x[:, :d // 2], x[:, d // 2:]
    return x[:n // 2], x[n // 2:]


_FITTED = {}


def fitted(partition, sparse=False):
    """(JAX model, port model over the JAX model's shares), once each."""
    key = (partition, sparse)
    if key not in _FITTED:
        x = _blobs(96, 4, 3, 1, 0.5 if sparse else 0.0)
        a, b = _split(x, partition)
        common = dict(k=3, iters=3, partition=partition, sparse=sparse,
                      seed=5)
        jk = JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common))
        rj = jk.fit(a, b)
        tk = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                       **common))
        tk.result_ = result_from_reference({
            f: tuple(np.asarray(getattr(rj, f)[i], np.uint64)
                     for i in (0, 1)) for f in ("centroids", "assignment")})
        _FITTED[key] = (jk, tk)
    return _FITTED[key]


def _batch(partition, sparse=False, m=20, seed=9):
    xq = _blobs(m, 4, 3, seed, 0.5 if sparse else 0.0)
    return (xq, *_split(xq, partition))


SIZES = [3, 5, 9, 2, 40]              # 40 > the top rung: chunked


def _submit_all(svc, partition, sparse=False):
    reqs = []
    for i, m in enumerate(SIZES):
        _, qa, qb = _batch(partition, sparse, m=m, seed=100 + i)
        reqs.append((qa, qb))
        svc.submit(qa, qb)
    return reqs


def test_batch_ladder():
    lad = BatchLadder((32, 128))
    assert lad.rungs == (32, 128)
    assert [lad.rung_for(m) for m in (1, 32, 33, 1000)] == [32, 32, 128, 128]
    with pytest.raises(ValueError):
        BatchLadder(())
    with pytest.raises(ValueError, match="strictly increasing"):
        BatchLadder((128, 32))
    with pytest.raises(ValueError, match="strictly increasing"):
        BatchLadder((32, 32, 128))
    with pytest.raises(ValueError, match=">= 1"):
        BatchLadder((0, 32))
    assert BatchLadder().rungs == (32, 128, 512)


def test_service_arguments():
    _, tk = fitted("vertical")
    svc = ScoringService(tk, rungs=(8, 16), d_a=2, d_b=2)
    assert svc.ladder.rungs == (8, 16)
    assert svc.bank.device == torch.device("cpu")   # the model's device
    assert svc.bank.seed == T.serve_seed(tk.cfg.seed)
    with pytest.raises(ValueError, match="not both"):
        ScoringService(tk, rungs=(8,), ladder=(8,), d_a=2, d_b=2)
    with pytest.raises(ValueError, match="feature split"):
        ScoringService(tk, ladder=(8,))
    with pytest.raises(ValueError, match="fitted"):
        ScoringService(SecureKMeans(KMeansConfig(k=3, backend="torch",
                                                 device="cpu")), d_a=2, d_b=2)
    with pytest.raises(ValueError, match="replenisher"):
        ScoringService(tk, d_a=2, d_b=2, replenisher=T.BankReplenisher(
            T.TripleBank(device="cpu")))


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "seq"])
@pytest.mark.parametrize("partition,sparse", [
    ("vertical", False), ("horizontal", False), ("vertical", True)])
def test_service_equals_reference(partition, sparse, pipeline):
    """The same requests through both packages' services: the same
    responses word for word, the same bank draws, launches, padding and
    traffic."""
    jk, tk = fitted(partition, sparse)
    kw = dict(rungs=(8, 16), with_scores=True, d_a=2, d_b=2,
              provision_copies=2, pipeline=pipeline)
    js, ts = JScoringService(jk, **kw), ScoringService(tk, **kw)
    _submit_all(js, partition, sparse)
    _submit_all(ts, partition, sparse)
    out_j, out_t = js.drain(), ts.drain()
    assert [r.request_id for r in out_t] == [r.request_id for r in out_j]
    for a, b in zip(out_t, out_j):
        assert a.error is None and b.error is None and a.rows == b.rows
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.scores, b.scores)
    sj, st = js.stats.as_dict(), ts.stats.as_dict()
    for k in ("requests", "rows", "padded_rows", "launches",
              "triples_per_request", "bytes_per_request", "pad_overhead",
              "replenish_events", "failed_requests"):
        assert st[k] == sj[k], k
    assert ts.bank.consumed_counts() == js.bank.consumed_counts()
    assert ts.bank.stock() == js.bank.stock()


def test_service_pipeline_matches_sequential():
    """pipeline=True (request t+1's host work overlapping request t's
    program) returns the responses of the sequential drain."""
    _, tk = fitted("vertical")
    outs = {}
    for pipe in (True, False):
        svc = ScoringService(tk, rungs=(8, 16), d_a=2, d_b=2,
                             provision_copies=2, pipeline=pipe)
        _submit_all(svc, "vertical")
        outs[pipe] = svc.drain()
    for a, b in zip(outs[True], outs[False]):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("partition,calls", [
    ("vertical", {8: 2, 16: 3}), ("horizontal", {16: 2, 8: 1})])
def test_service_stats_calls_per_rung_and_host_seconds(partition, calls):
    """ServiceStats counts each call under the rung it was padded to (the
    JAX service's launches and padded rows agree) and times every call's
    host phases inside the drain."""
    jk, tk = fitted(partition)
    kw = dict(rungs=(8, 16), d_a=2, d_b=2, provision_copies=2)
    js, ts = JScoringService(jk, **kw), ScoringService(tk, **kw)
    _submit_all(js, partition)
    _submit_all(ts, partition)
    js.drain()
    ts.drain()
    st, sj = ts.stats.as_dict(), js.stats.as_dict()
    assert ts.stats.rung_calls == calls
    assert sum(calls.values()) == st["launches"] == sj["launches"]
    per_call = 2 if partition == "horizontal" else 1
    assert sum(r * c * per_call for r, c in calls.items()) \
        == st["padded_rows"] == sj["padded_rows"]
    host = ts.stats.host_seconds
    assert sorted(host) == ["collect", "launch", "prepare"]
    assert all(v > 0 for v in host.values())
    assert sum(host.values()) <= ts.stats.online_seconds


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_service_matches_direct_scoring(partition):
    """Ragged submits -> coalesced padded calls -> per-request outputs
    equal to scoring each request alone: labels exactly; scores to the
    fixed-point LSB (padding changes the call geometry, so the truncation
    randomness differs)."""
    _, tk = fitted(partition)
    svc = ScoringService(tk, ladder=(8, 16), d_a=2, d_b=2,
                         provision_copies=2)
    reqs = _submit_all(svc, partition)
    out = svc.drain()
    assert [r.request_id for r in out] == list(range(len(reqs)))
    assert svc.pending() == 0
    for r, (qa, qb) in zip(out, reqs):
        direct = tk.score(qa, qb, dealer=T.TrustedDealer(seed=1))
        np.testing.assert_array_equal(r.labels, direct.labels_plain())
        np.testing.assert_allclose(r.scores, direct.scores_plain(),
                                   atol=1e-4)
    st = svc.stats.as_dict()
    assert st["requests"] == len(reqs)
    assert st["rows"] == sum(qa.shape[0] + (qb.shape[0] if partition ==
                             "horizontal" else 0) for qa, qb in reqs)
    assert st["padded_rows"] >= st["rows"]
    assert st["launches"] < len(reqs) + 3       # coalescing merges
    assert st["p99_ms"] >= st["p50_ms"] > 0.0


def test_service_eager_config_equals_program_labels():
    """A config the program path cannot run (f=16) scores eagerly inside
    the drain, label for label with direct scoring."""
    x = _blobs(48, 4, 2, 3)
    tk = SecureKMeans(KMeansConfig(k=2, iters=2, seed=5, f=16,
                                   backend="torch", device="cpu"))
    tk.fit(x[:, :2], x[:, 2:])
    svc = ScoringService(tk, rungs=(8,), d_a=2, d_b=2, provision_copies=1)
    svc.submit(x[:5, :2], x[:5, 2:])
    (r,) = svc.drain()
    np.testing.assert_array_equal(
        r.labels, tk.score(x[:5, :2], x[:5, 2:]).labels_plain())


def test_queue_full_sheds_and_rid_dedups():
    _, tk = fitted("vertical")
    svc = ScoringService(tk, rungs=(8,), d_a=2, d_b=2, max_queue=2,
                         provision_copies=1)
    _, qa, qb = _batch("vertical", m=3)
    assert svc.submit(qa, qb) == 0
    assert svc.submit(qa, qb, rid=7) == 7
    assert svc.submit(qa, qb, rid=7) == 7        # duplicate: not enqueued
    shed = svc.submit(qa, qb)
    assert isinstance(shed, ScoringResponse)
    assert shed.error.startswith(ERR_QUEUE_FULL) and shed.rows == 0
    assert svc.stats.shed_requests == 1 and svc.pending() == 2
    out = svc.drain()
    assert [r.request_id for r in out] == [0, 7]
    assert svc.submit(qa, qb, rid=7) == 7        # answered: dedup
    assert svc.pending() == 0 and svc.lookup(7) is out[1]
    assert svc.stats.max_queue_depth == 2


def test_deadlines_at_dequeue_and_in_flight():
    """An expired request answers DeadlineExceeded without drawing triples;
    one that expires in flight answers it after collect."""
    _, tk = fitted("vertical")
    svc = ScoringService(tk, rungs=(8,), d_a=2, d_b=2, provision_copies=2)
    svc.warm()
    _, qa, qb = _batch("vertical", m=3)
    svc.submit(qa, qb, deadline_s=-1.0)
    served0 = svc.bank.served_requests
    (r,) = svc.drain()
    assert r.error.startswith(ERR_DEADLINE) and "at dequeue" in r.error
    assert svc.bank.served_requests == served0
    svc.submit(qa, qb, deadline_s=1e-9)
    svc._queue[0].deadline = float("inf")        # admitted, then lapses
    real = svc._split_group

    def lapse(group, *a):
        group[0].deadline = 0.0
        return real(group, *a)
    svc._split_group = lapse
    (r,) = svc.drain()
    assert r.error.startswith(ERR_DEADLINE) and "in flight" in r.error
    assert svc.stats.expired_requests == 2


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "seq"])
def test_poisoned_request_cannot_livelock_drain(pipeline):
    """A request whose geometry breaks its call resolves as an ERROR
    response after bounded retries; the requests around it score."""
    _, tk = fitted("vertical")
    svc = ScoringService(tk, rungs=(8,), d_a=2, d_b=2, max_attempts=3,
                         pipeline=pipeline)
    _, qa, qb = _batch("vertical", m=4, seed=100)
    good1 = svc.submit(qa, qb)
    # wrong feature width (submit checks only row counts); 5 + 4 rows > 8
    bad = svc.submit(np.zeros((5, 3)), np.zeros((5, 2)))
    _, qa2, qb2 = _batch("vertical", m=5, seed=101)
    good2 = svc.submit(qa2, qb2)
    responses = svc.drain()
    assert [r.request_id for r in responses] == [good1, bad, good2]
    by_id = {r.request_id: r for r in responses}
    assert by_id[bad].error is not None and by_id[bad].rows == 0
    assert by_id[good1].error is None and by_id[good1].labels.shape == (4,)
    assert by_id[good2].error is None and by_id[good2].labels.shape == (5,)
    np.testing.assert_array_equal(by_id[good2].labels,
                                  tk.score(qa2, qb2).labels_plain())
    assert svc.pending() == 0
    assert svc.stats.failed_requests == 1
    assert svc.stats.retried_groups == 2          # attempts 2 and 3
    assert svc.drain() == []


def test_background_loop_and_health():
    _, tk = fitted("vertical")
    svc = ScoringService(tk, rungs=(8,), d_a=2, d_b=2, provision_copies=1,
                         replenisher={"low_water": 1, "poll_s": 0.001})
    assert svc.health == "STARTING"
    svc.start()
    assert svc.health == "READY" and svc.replenisher.running
    _, qa, qb = _batch("vertical", m=6)
    rid = svc.submit(qa, qb)
    r = svc.response(rid, timeout=60.0)
    assert r is not None and r.error is None
    np.testing.assert_array_equal(r.labels, tk.score(qa, qb).labels_plain())
    svc.close()
    assert svc.health == "DRAINING" and not svc.replenisher.running
    assert svc.health_code() == 3 and svc.loop_errors == 0


# ---------------------------------------------------------------------------
# fraud pipeline and normalization
# ---------------------------------------------------------------------------

def test_fraud_pipeline_equals_reference():
    """run_secure_fraud at a small n: the same fit and the same revealed
    scores, hence the same Jaccard, as the JAX package's; the plaintext
    baselines are the same numpy code."""
    ds_j = JF.FraudDataset.synthesize(n=600, d_a=4, d_b=6, seed=1)
    ds_t = F.FraudDataset.synthesize(n=600, d_a=4, d_b=6, seed=1)
    for f in ("x_a", "x_b", "y_outlier"):
        np.testing.assert_array_equal(getattr(ds_t, f), getattr(ds_j, f))
    j_j, res_j = JF.run_secure_fraud(ds_j, k=5, iters=5, seed=2)
    j_t, res_t = F.run_secure_fraud(ds_t, k=5, iters=5, seed=2,
                                    backend="torch", device="cpu")
    assert j_t == j_j
    assert j_t > 0.4
    for i in (0, 1):
        np.testing.assert_array_equal(
            shares_to_numpy(res_t.centroids)[i],
            np.asarray(res_j.centroids[i], np.uint64))
    leaky_t = F.fraud_scores(None, res_t, ds_t, reveal_model=True)
    leaky_j = JF.fraud_scores(None, res_j, ds_j, reveal_model=True)
    np.testing.assert_array_equal(leaky_t, leaky_j)
    for a_only in (False, True):
        assert F.run_plaintext_fraud(ds_t, seed=2, party_a_only=a_only) \
            == JF.run_plaintext_fraud(ds_j, seed=2, party_a_only=a_only)
    with pytest.raises(ValueError, match="SecureKMeans"):
        F.fraud_scores(None, res_t, ds_t)
    assert F.jaccard(np.zeros(3, bool), np.zeros(3, bool)) == 1.0


def test_normalize_equals_reference():
    rng = np.random.default_rng(8)
    x_a = rng.normal(0, 2, (30, 5))
    x_b = rng.normal(1, 3, (20, 5))
    np.testing.assert_array_equal(N.normalize_local(x_a),
                                  JN.normalize_local(x_a))
    ctx_j = JP.make_ctx(4, backend="xla")
    ctx_t = P.make_ctx(4, backend="torch", device="cpu")
    lo_j, hi_j = JN.secure_minmax(ctx_j, x_a, x_b, np.random.default_rng(2))
    lo_t, hi_t = N.secure_minmax(ctx_t, x_a, x_b, np.random.default_rng(2))
    for got, want in ((lo_t, lo_j), (hi_t, hi_j)):
        for i in (0, 1):
            np.testing.assert_array_equal(shares_to_numpy(got)[i],
                                          np.asarray(want[i], np.uint64))
    a_t, b_t = N.normalize_horizontal(ctx_t, x_a, x_b,
                                      np.random.default_rng(3))
    a_j, b_j = JN.normalize_horizontal(ctx_j, x_a, x_b,
                                       np.random.default_rng(3))
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(b_t, b_j)
    assert ctx_t.log.by_tag("online") == ctx_j.log.by_tag("online")
    both = np.concatenate([a_t, b_t])
    np.testing.assert_allclose(both.min(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(both.max(0), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# exactly once across a restart, and over a faulty wire
# ---------------------------------------------------------------------------

PLANE = dict(rungs=(16,), with_scores=True, d_a=2, d_b=2,
             provision_copies=4)


def _plane_batches(n, rows=8):
    return [_batch("vertical", m=rows, seed=300 + i)[1:] for i in range(n)]


def _one_at_a_time(svc, batches):
    """Submit and drain each batch alone — the wire server's schedule
    (one outstanding request per sequential channel)."""
    out = {}
    for xa, xb in batches:
        svc.submit(xa, xb)
        out.update({r.request_id: r for r in svc.drain()})
    return out


def _assert_same_responses(got: dict, want: dict):
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].error is None and want[rid].error is None
        assert got[rid].rows == want[rid].rows
        np.testing.assert_array_equal(got[rid].labels, want[rid].labels)
        np.testing.assert_array_equal(got[rid].scores, want[rid].scores)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_restart_replays_and_realigns_equals_reference(tmp_path, writer):
    """A service "crashes" after three journaled drains; a restarted port
    service on the same directory replays them verbatim and, its reloaded
    bank realigned, answers the rest as the uninterrupted JAX service
    does. The directory may be the JAX package's."""
    jk, tk = fitted("vertical")
    b = _plane_batches(6)
    ref_svc = JScoringService(jk, **PLANE)
    ref = _one_at_a_time(ref_svc, b)
    d = str(tmp_path / "ck")
    first = ScoringService(tk, checkpointer=ServeCheckpointer(d), **PLANE) \
        if writer == "torch" else \
        JScoringService(jk, checkpointer=JServeCheckpointer(d), **PLANE)
    got = _one_at_a_time(first, b[:3])
    consumed = first.bank.consumed_counts()
    del first                                  # no close: a crash
    svc = ScoringService(tk, checkpointer=ServeCheckpointer(d), **PLANE)
    assert svc.bank.consumed_counts() == consumed
    for rid in got:                            # replayed, not re-scored
        r = svc.lookup(rid)
        np.testing.assert_array_equal(r.labels, got[rid].labels)
        np.testing.assert_array_equal(r.scores, got[rid].scores)
    got.update(_one_at_a_time(svc, b[3:]))
    _assert_same_responses(got, ref)
    assert svc.stats.requests == 3
    assert svc.bank.consumed_counts() == ref_svc.bank.consumed_counts()


def test_restart_never_double_draws(tmp_path):
    """The reloaded bank starts exactly where the dead one stopped: a
    request the dead service drew for but never journaled is re-scored on
    the same words; journaled ones never re-enter a drain."""
    _, tk = fitted("vertical")
    b = _plane_batches(3)
    d = str(tmp_path / "ck")
    svc = ScoringService(tk, checkpointer=ServeCheckpointer(d), **PLANE)
    got = _one_at_a_time(svc, b[:1])
    before = svc.bank.consumed_counts()
    # drawn, then lost before the journal: the restart re-draws its words
    svc.checkpointer.record = lambda *a, **k: None
    lost = _one_at_a_time(svc, b[1:2])
    svc2 = ScoringService(tk, checkpointer=ServeCheckpointer(d), **PLANE)
    assert svc2.bank.consumed_counts() == before
    assert svc2.submit(*b[0], rid=0) == 0      # journaled: deduped
    again = _one_at_a_time(svc2, b[1:2])
    _assert_same_responses(again, lost)
    assert svc2.stats.requests == 1
    after = svc2.bank.consumed_counts()
    assert all(after[k] > v for k, v in before.items())
    assert set(got) == {0}


def test_wire_chaos_keyed_exactly_once():
    """Drops, duplicates and corruption on the client's frames, keyed
    (tampered frames rejected like corrupt ones): every response equals
    the direct run's, each rid is scored once, and a retried rid is
    answered from the published responses (one `serve.replay` instant)."""
    jk, tk = fitted("vertical")
    b = _plane_batches(4)
    ref = _one_at_a_time(JScoringService(jk, **PLANE), b)
    key = C.session_key("serving-plane-test")
    ta, tb = C.LoopbackTransport.pair()
    ft = C.FaultyTransport(ta, seed=9, drop=0.15, dup=0.15, corrupt=0.2)
    svc = ScoringService(tk, **dict(PLANE, provision_copies=8))
    server = ScoringServer(svc, tb, idle_timeout_s=30.0, auth_key=key)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    client = ScoringClient(ft, auth_key=key, deadline_s=20.0,
                           tracer=_trace.Tracer())
    tracer = _trace.get_tracer()
    was = (tracer.enabled, tracer.process)
    tracer.reset()
    _trace.configure(enabled=True, process="server")
    try:
        got = {}
        for xa, xb in b:
            r = client.score(xa, xb)
            got[r.request_id] = r
        # a retry wave of an answered rid: replayed, not re-scored
        again = client.score(*b[0], rid=0)
        client.bye()
        th.join(timeout=30)
        replays = tracer.span_counts().get("serve.replay", 0)
    finally:
        _trace.configure(enabled=was[0], process=was[1])
        tracer.reset()
    assert not th.is_alive()
    _assert_same_responses(got, ref)
    np.testing.assert_array_equal(again.labels, ref[0].labels)
    assert svc.stats.requests == len(b) and replays == 1
    f = ft.faults
    assert f.dropped + f.duplicated + f.corrupted > 0
    assert server.responder.crc_drops > 0 or f.corrupted == 0
