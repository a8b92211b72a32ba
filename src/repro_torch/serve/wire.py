"""Wire frontend for the scoring service.

`ScoringServer` fronts a `ScoringService` with the `Responder`:
scoring requests arrive as `T_SCORE` blobs ({rid, deadline_s} meta +
x_a/x_b arrays) and are answered with the response blob ({rid, rows,
error} meta + labels/scores arrays). `ScoringClient` drives the matching
`ReliableChannel`.

Exactly-once across an unreliable wire AND a server crash:

* The transport layer already collapses drops/duplicates/corruption into
  "resend until the response lands" (sequence-number dedup in the
  `Responder`, CRC/MAC rejection, reconnect on sever).
* Above that, the CLIENT pins the request id: a retry *wave* (a fresh
  `ReliableChannel` request after the previous one exhausted its
  retries — e.g. the server died mid-request) re-sends the SAME rid.
  The server answers a rid it has already published from its response
  cache (`ScoringService.lookup`) without re-scoring — and with a
  `ServeCheckpointer` that cache survives the crash via the journal. A
  rid still in flight is deduped at admission and simply awaited again.

So client delivery is at-least-once, scoring effect is exactly-once, and
the response bytes are identical no matter how many times the request
crossed the wire. The frames and blobs are the JAX package's: a client of
either package talks to a server of the other.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.channel import (ReliableChannel, Responder, T_BYE,
                                      T_SCORE, Transport, WireError,
                                      _pack_blob, _unpack_blob)
from repro_torch.obs import trace as _trace
from repro_torch.serve.service import (ERR_DEADLINE, ScoringResponse,
                                       ScoringService)


def _response_blob(r: ScoringResponse) -> bytes:
    arrays = {"labels": np.asarray(r.labels, np.int64)}
    if r.scores is not None:
        arrays["scores"] = np.asarray(r.scores, np.float64)
    return _pack_blob({"rid": int(r.request_id), "rows": int(r.rows),
                       "error": r.error}, arrays)


def _response_from_blob(payload: bytes) -> ScoringResponse:
    meta, arrays = _unpack_blob(payload)
    return ScoringResponse(
        int(meta["rid"]), arrays.get("labels", np.zeros(0, np.int64)),
        arrays.get("scores"), int(meta["rows"]), meta.get("error"))


class ScoringServer:
    """Responder loop fronting a `ScoringService`.

    `serve_forever()` starts the service's background drain loop, then
    answers `T_SCORE` requests until the client says BYE (or the idle
    timeout trips). Each request is resolved in order: published response
    (replay — journal or cache), else admission (`submit(rid=rid)`, which
    dedups an in-flight rid) + `result()` wait. A shed admission returns
    the typed `QueueFull` response directly — transient by design, so a
    later retry of the same rid can be admitted. Handler errors answer as
    error responses instead of killing the loop."""

    def __init__(self, service: ScoringService, transport: Transport, *,
                 idle_timeout_s: float = 120.0,
                 auth_key: bytes | None = None,
                 result_timeout_s: float = 120.0):
        self.service = service
        self.result_timeout_s = float(result_timeout_s)
        self.responder = Responder(transport, self._handle,
                                   idle_timeout_s=idle_timeout_s,
                                   auth_key=auth_key)

    def _resolve(self, meta: dict, arrays: dict) -> ScoringResponse:
        # runs on the responder thread with the frame's trace id installed
        # as the ambient trace (core/channel.Responder), so this span, and
        # everything submit() stamps, carries the client's id
        rid = int(meta["rid"])
        with _trace.span("serve.resolve", rid=rid):
            r = self.service.lookup(rid)
            if r is not None:
                _trace.instant("serve.replay", rid=rid)
                return r                           # exactly-once replay
            sub = self.service.submit(arrays["x_a"], arrays["x_b"], rid=rid,
                                      deadline_s=meta.get("deadline_s"))
            if isinstance(sub, ScoringResponse):
                return sub                         # shed at admission
            r = self.service.response(rid, timeout=self.result_timeout_s)
            if r is None:
                return ScoringResponse(
                    rid, np.zeros(0, np.int64), None, 0,
                    error=f"{ERR_DEADLINE}: server result wait exceeded "
                    f"{self.result_timeout_s}s")
            return r

    def _handle(self, ftype: int, payload: bytes) -> bytes:
        if ftype != T_SCORE:
            return b""                             # heartbeat / bye
        try:
            meta, arrays = _unpack_blob(payload)
            return _response_blob(self._resolve(meta, arrays))
        except Exception as e:                     # noqa: BLE001 — the loop
            # must survive a malformed request; the client gets the reason
            try:
                rid = int(meta.get("rid", -1))
            except Exception:
                rid = -1
            return _response_blob(ScoringResponse(
                rid, np.zeros(0, np.int64), None, 0,
                error=f"{type(e).__name__}: {e}"))

    def serve_forever(self) -> Responder:
        self.service.start()
        try:
            self.responder.serve_forever()
        finally:
            self.service.close()
        return self.responder


class ScoringClient:
    """Client side: `score()` ships one arrival batch and blocks for its
    response. Wire failures inside one request are retried by the
    `ReliableChannel`; if a whole request *wave* fails (retries exhausted
    — typically the server dying mid-request), `score` starts a new wave
    with the SAME rid after `retry_wait_s`, up to `waves` times — riding
    the server's rid dedup, so redelivery never re-scores. Each request's
    frames carry one trace id, the same on every wave, and its
    `client.score` span on `tracer` (default: the process-global tracer)
    carries it too."""

    def __init__(self, transport: Transport, *,
                 auth_key: bytes | None = None, deadline_s: float = 30.0,
                 try_timeout_s: float = 0.5, max_retries: int = 10,
                 waves: int = 4, retry_wait_s: float = 0.5,
                 jitter_seed: int = 11,
                 tracer: _trace.Tracer | None = None):
        self.chan = ReliableChannel(transport, deadline_s=deadline_s,
                                    try_timeout_s=try_timeout_s,
                                    max_retries=max_retries,
                                    jitter_seed=jitter_seed,
                                    auth_key=auth_key)
        self.waves = max(1, int(waves))
        self.retry_wait_s = float(retry_wait_s)
        self.wave_retries = 0
        self._next_rid = 0
        # client-side spans go here; injectable so a client and a server
        # sharing one process can still export separate span files
        self.tracer = tracer if tracer is not None else _trace.get_tracer()

    def score(self, x_a, x_b, *, rid: int | None = None,
              deadline_s: float | None = None) -> ScoringResponse:
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, int(rid) + 1)
        meta: dict = {"rid": int(rid)}
        if deadline_s is not None:
            meta["deadline_s"] = float(deadline_s)
        payload = _pack_blob(meta, {"x_a": np.asarray(x_a, np.float64),
                                    "x_b": np.asarray(x_b, np.float64)})
        # one trace id per request — pinned like the rid, so every retry
        # wave carries the SAME id and the server's spans join up
        tid = _trace.new_trace_id()
        tid_raw = _trace.trace_id_to_bytes(tid)
        last: WireError | None = None
        with self.tracer.span("client.score", rid=int(rid), trace=tid):
            for wave in range(self.waves):
                if wave:
                    self.wave_retries += 1
                    self.tracer.instant("client.wave_retry", rid=int(rid),
                                        wave=wave, trace=tid)
                    time.sleep(self.retry_wait_s)
                    self.chan.t.reconnect()
                try:
                    return _response_from_blob(
                        self.chan.request(T_SCORE, payload,
                                          trace_id=tid_raw))
                except WireError as e:
                    last = e
        raise WireError(f"score rid={rid} failed after {self.waves} "
                        f"waves: {last}") from last

    def bye(self) -> None:
        self.chan.request(T_BYE, b"")
