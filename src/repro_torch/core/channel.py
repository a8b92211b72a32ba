"""Communication accounting, network cost models, AND the real wire.

Two layers live here:

* **Accounting** — `CommLog` tallies bytes/rounds keyed by (phase, tag);
  every protocol op reports its traffic, which is fully determined by
  tensor shapes. This reproduces the paper's Tables 1-2 / Figures 2-4.
* **Transport** — the seam that makes those bytes *paid* instead of
  modelled. A `Transport` moves length-prefixed frames (monotonic
  sequence number + CRC32) between two endpoints: `LoopbackTransport`
  (in-process, zero-copy — the frame bytes object itself crosses the
  queue), `SocketTransport` (TCP), and a seeded `FaultyTransport` wrapper
  that drops/delays/duplicates/corrupts frames and severs connections on
  a deterministic schedule. `ReliableChannel`/`Responder` layer
  request/response reliability on top (retries with exponential backoff +
  jitter, per-op deadlines, idempotent receive via sequence-number
  dedup, heartbeat liveness); with a session `auth_key` both replace the
  CRC with a keyed BLAKE2b MAC (constant-time verified) so tampered or
  unkeyed frames are rejected like corruption. `WireSession` plugs into
  `CommLog`:
  when a log has a wire attached, every online `send`/`merge` ships its
  byte count as real frames to the peer process and counts the tally
  from the payload bytes that actually crossed — so a two-process fit
  pays its network cost while staying bit-exact with the in-process one.

The frames are byte for byte the JAX package's, so an engine of either
package talks to a peer of the other. Nothing here touches a tensor: the
bytes an exchange ships are fixed by shapes, so the wire never waits for
the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import io
import json
import logging
import struct
import threading
import time
import zlib
from collections import defaultdict

import numpy as np

from repro_torch.core import faultpoints as _fp
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

_WIRE_LOG = logging.getLogger("repro_torch.wire")


@dataclasses.dataclass(frozen=True)
class NetModel:
    """One-way latency is rtt/2; paper quotes round-trip latency."""

    name: str
    bandwidth_bps: float
    rtt_s: float

    def time_s(self, nbytes: int, rounds: int) -> float:
        return nbytes * 8.0 / self.bandwidth_bps + rounds * self.rtt_s


# Paper Sec 5.1: LAN 10 Gbps / 0.02 ms RTT; WAN 20 Mbps / 40 ms RTT.
LAN = NetModel("LAN", 10e9, 0.02e-3)
WAN = NetModel("WAN", 20e6, 40e-3)


class CommLog:
    """Byte/round tallies keyed by (phase, tag).

    Thread-safe: the pipelined executor's background generation worker and
    the main thread may both land on one shared log, so every tally
    mutation/read holds `_lock` (defaultdict `+=` is a read-modify-write —
    not atomic even under the GIL).

    `wire`: when a `WireSession` is attached, online-phase `send`/`merge`
    traffic is SHIPPED over it as real frames before being tallied, and
    the tally comes from the session's reported payload bytes. The wire is
    deliberately NOT inherited by `copy()` (plan-cache copies and scratch
    logs must never touch the network) and `restore()` bypasses it
    (replaying a checkpoint's tallies is bookkeeping, not traffic).
    """

    def __init__(self) -> None:
        self.bytes = defaultdict(int)   # (phase, tag) -> bytes
        self.rounds = defaultdict(int)  # (phase, tag) -> rounds
        self.wire: "WireSession | None" = None
        self._lock = threading.Lock()

    def send(self, nbytes: int, *, tag: str = "misc", phase: str = "online",
             rounds: int = 1) -> None:
        nbytes, rounds = int(nbytes), int(rounds)
        if self.wire is not None and phase == "online" \
                and (nbytes or rounds):
            # pay the traffic: the tally is the payload byte count that
            # actually crossed the wire (== nbytes; WireSession asserts it)
            nbytes = self.wire.exchange(nbytes, rounds)
        with self._lock:
            self.bytes[(phase, tag)] += nbytes
            self.rounds[(phase, tag)] += rounds

    # ---- queries -------------------------------------------------------
    def total_bytes(self, phase: str | None = None) -> int:
        with self._lock:
            return sum(v for (p, _), v in self.bytes.items()
                       if phase is None or p == phase)

    def total_rounds(self, phase: str | None = None) -> int:
        with self._lock:
            return sum(v for (p, _), v in self.rounds.items()
                       if phase is None or p == phase)

    def by_tag(self, phase: str) -> dict:
        out = defaultdict(lambda: [0, 0])
        with self._lock:
            for (p, t), v in self.bytes.items():
                if p == phase:
                    out[t][0] += v
            for (p, t), v in self.rounds.items():
                if p == phase:
                    out[t][1] += v
        return {t: tuple(v) for t, v in out.items()}

    def time_estimate(self, net: NetModel, phase: str | None = None) -> float:
        return net.time_s(self.total_bytes(phase), self.total_rounds(phase))

    def merge(self, other: "CommLog", phase: str | None = None) -> None:
        """Accumulate another log's tallies (optionally one phase only).
        Used to replay the shape-determined per-iteration traffic of a
        compiled online step, whose protocol-level sends only fire at trace
        time. With a wire attached, the merged online traffic is shipped
        (one aggregate exchange of the other log's online bytes/rounds) —
        this is where a two-process fit on the compiled fast path pays its
        per-iteration network cost."""
        with other._lock:
            ob = dict(other.bytes)
            orn = dict(other.rounds)
        if self.wire is not None and phase in (None, "online"):
            nb = sum(v for (p, _), v in ob.items() if p == "online")
            nr = sum(v for (p, _), v in orn.items() if p == "online")
            if nb or nr:
                self.wire.exchange(nb, nr)
        with self._lock:
            for (p, t), v in ob.items():
                if phase is None or p == phase:
                    self.bytes[(p, t)] += v
            for (p, t), v in orn.items():
                if phase is None or p == phase:
                    self.rounds[(p, t)] += v

    def copy(self) -> "CommLog":
        """Independent tally copy — what the plan cache hands out, so one
        fit's replay merges never mutate the cached per-iteration log.
        The wire is NOT copied: a scratch/cached log never pays traffic."""
        out = CommLog()
        with self._lock:
            for k, v in self.bytes.items():
                out.bytes[k] += v
            for k, v in self.rounds.items():
                out.rounds[k] += v
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes": dict(self.bytes), "rounds": dict(self.rounds)}

    def state(self) -> dict:
        """JSON-serializable tally state (tuple keys flattened) — what a
        `FitCheckpoint` stores."""
        with self._lock:
            return {"bytes": [[p, t, v] for (p, t), v in self.bytes.items()],
                    "rounds": [[p, t, v]
                               for (p, t), v in self.rounds.items()]}

    def restore(self, state: dict) -> None:
        """Replace the tallies with a `state()` snapshot. Bypasses the
        wire: restoring a checkpoint replays bookkeeping, not traffic."""
        with self._lock:
            self.bytes.clear()
            self.rounds.clear()
            for p, t, v in state["bytes"]:
                self.bytes[(p, t)] = int(v)
            for p, t, v in state["rounds"]:
                self.rounds[(p, t)] = int(v)

    def reset(self) -> None:
        with self._lock:
            self.bytes.clear()
            self.rounds.clear()


# ===========================================================================
# Frame codec — length-prefixed, sequence-numbered, CRC32-guarded
# ===========================================================================

FRAME_MAGIC = 0x4B4D5732          # "KMW2"
_HEADER = struct.Struct(">IBQII")  # magic, ftype, seq, payload len, crc32
HEADER_BYTES = _HEADER.size        # 21
MAX_FRAME_PAYLOAD = 1 << 30

# request frame types; a response echoes the type with RESP_BIT set
T_EXCHANGE = 1     # payload: u32 reply_len + engine's half of the round
T_BLOB = 2         # payload: u32 json_len + json meta + npz raw
T_HEARTBEAT = 3    # liveness probe, empty payload both ways
T_BYE = 4          # orderly shutdown of the responder loop
T_SCORE = 5        # scoring request: blob of {rid, deadline_s} + x_a/x_b
T_RESUME = 6       # resume negotiation: JSON {op, inc, step, fp} both ways
RESP_BIT = 0x80

# optional trace-id header extension: a frame whose ftype carries
# TRACE_BIT prefixes its payload with an 8-byte request trace id, INSIDE
# the CRC/MAC coverage (the id rides the existing checksum; a flipped
# trace byte is corruption like any other). Frames without the bit are
# byte-identical to the pre-trace format — old and new endpoints interoperate
# on traceless traffic, and an old endpoint treats an unexpected
# TRACE_BIT ftype like any unknown type (responder answers empty) rather
# than mis-parsing, since the bit never collides with RESP_BIT (0x80) or
# the type space (1..5).
TRACE_BIT = 0x40
TRACE_ID_BYTES = 8

# keyed frames replace the CRC32 with a BLAKE2b MAC appended to the payload
AUTH_TAG_BYTES = 16


class FrameError(ValueError):
    """Structurally invalid frame (bad magic / impossible length)."""


class FrameCorrupt(FrameError):
    """Well-formed frame whose CRC32 does not match its payload."""


class WireError(RuntimeError):
    """Reliable-channel failure: retries exhausted or protocol violation."""


class WireTimeout(WireError):
    """A per-op deadline expired before the peer answered."""


class ResumeMismatch(WireError):
    """Resume negotiation rejected: the two parties' config fingerprints
    disagree, so no common checkpoint step can be bit-exact. Terminal —
    restarting won't help; a supervisor must NOT respawn on it."""


def _crc(ftype: int, seq: int, payload) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack(">BQ", ftype, seq)))


def session_key(passphrase: str | bytes) -> bytes:
    """Derive a 32-byte wire session key from a shared passphrase (what
    `--auth-key` feeds). Key agreement itself is out of scope — the paper's
    deployment assumes the two parties share credentials out of band."""
    raw = passphrase.encode() if isinstance(passphrase, str) else passphrase
    return hashlib.blake2b(raw, digest_size=32).digest()


def _mac(key: bytes, ftype: int, seq: int, payload: bytes) -> bytes:
    """Keyed BLAKE2b MAC over (type, seq, payload) — same coverage as the
    CRC, but unforgeable without the session key. The sequence number is
    inside the MAC, so a tampered frame can't be replayed under a
    different seq either."""
    return hashlib.blake2b(struct.pack(">BQ", ftype, seq) + payload,
                           key=key, digest_size=AUTH_TAG_BYTES).digest()


def encode_frame(ftype: int, seq: int, payload: bytes = b"", *,
                 key: bytes | None = None,
                 trace_id: bytes | None = None) -> bytes:
    """Encode one frame. With a session `key`, the CRC32 is REPLACED by a
    keyed MAC: the tag is appended to the payload and the header checksum
    field is zeroed, so keyed and unkeyed endpoints reject each other's
    frames the same way they reject corruption. With a `trace_id`
    (exactly `TRACE_ID_BYTES`), the ftype carries `TRACE_BIT` and the id
    is prepended to the payload under the same CRC/MAC coverage; without
    one the emitted bytes are identical to the pre-trace format."""
    if trace_id is not None:
        if len(trace_id) != TRACE_ID_BYTES:
            raise ValueError(f"trace_id must be {TRACE_ID_BYTES} bytes, "
                             f"got {len(trace_id)}")
        ftype |= TRACE_BIT
        payload = trace_id + payload
    if key is None:
        return _HEADER.pack(FRAME_MAGIC, ftype, seq, len(payload),
                            _crc(ftype, seq, payload)) + payload
    body = payload + _mac(key, ftype, seq, payload)
    return _HEADER.pack(FRAME_MAGIC, ftype, seq, len(body), 0) + body


def _split_trace(ftype: int, payload: bytes, seq: int):
    """Strip the TRACE_BIT extension: (base ftype, payload, trace_id)."""
    if not ftype & TRACE_BIT:
        return ftype, payload, None
    if len(payload) < TRACE_ID_BYTES:
        raise FrameCorrupt(f"TRACE_BIT frame on seq {seq} shorter than "
                           "its trace id")
    return (ftype & ~TRACE_BIT, payload[TRACE_ID_BYTES:],
            payload[:TRACE_ID_BYTES])


def decode_frame(buf: bytes, *, key: bytes | None = None,
                 with_trace: bool = False):
    """Decode ONE complete frame; raises `FrameError`/`FrameCorrupt`.
    With a session `key`, the trailing MAC is verified (constant-time)
    instead of the CRC; unkeyed or tampered frames fail exactly like
    corrupt ones and are dropped/resent by the reliability layer.

    Returns `(ftype, seq, payload)`; with `with_trace=True` returns
    `(ftype, seq, payload, trace_id | None)` — TRACE_BIT stripped from
    the ftype and the 8-byte id split off the payload. The default
    3-tuple keeps every pre-trace call site working; a traced frame
    decoded without `with_trace` surfaces its raw extended form."""
    if len(buf) < HEADER_BYTES:
        raise FrameError(f"short frame: {len(buf)} < header {HEADER_BYTES}")
    magic, ftype, seq, length, crc = _HEADER.unpack_from(buf)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    if length > MAX_FRAME_PAYLOAD or len(buf) != HEADER_BYTES + length:
        raise FrameCorrupt(
            f"length field {length} vs actual {len(buf) - HEADER_BYTES}")
    body = buf[HEADER_BYTES:]
    if key is not None:
        if length < AUTH_TAG_BYTES:
            raise FrameCorrupt(f"unauthenticated frame on seq {seq} "
                               "(no MAC tag)")
        payload, tag = body[:-AUTH_TAG_BYTES], body[-AUTH_TAG_BYTES:]
        if not hmac.compare_digest(tag, _mac(key, ftype, seq, payload)):
            raise FrameCorrupt(f"MAC mismatch on seq {seq}")
    else:
        if _crc(ftype, seq, body) != crc:
            raise FrameCorrupt(f"crc mismatch on seq {seq}")
        payload = body
    if not with_trace:
        return ftype, seq, payload
    ftype, payload, trace_id = _split_trace(ftype, payload, seq)
    return ftype, seq, payload, trace_id


class _RateLimitedWarn:
    """At most one warning line per `interval_s` per event kind — chaos
    schedules inject hundreds of corrupt frames and the point is a
    diagnosable log, not a flooded one. Suppressed occurrences are
    summarized in the next emitted line."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._state: dict[str, list] = {}   # kind -> [last_emit, muted]

    def warn(self, kind: str, msg: str) -> None:
        now = time.monotonic()
        with self._lock:
            last, muted = self._state.get(kind, (None, 0))
            if last is not None and now - last < self.interval_s:
                self._state[kind] = [last, muted + 1]
                return
            self._state[kind] = [now, 0]
        if muted:
            msg += f" (+{muted} similar suppressed)"
        _WIRE_LOG.warning(msg)


_rate_warn = _RateLimitedWarn()


class FrameDecoder:
    """Incremental frame parser over an arbitrary byte stream: `feed`
    chunks of any size (split reads welcome) and collect complete frames.
    Integrity-failed frames are dropped and counted (`crc_errors`; keyed
    decoders additionally count MAC failures in `auth_errors`); a bad
    magic means the byte stream itself desynced — unrecoverable without a
    reconnect — so it raises `FrameError`. Every drop/desync is also
    routed to the metrics registry (`repro_frame_*_total`) and surfaces
    as a rate-limited `repro_torch.wire` warning, so chaos-test noise is
    diagnosable from logs alone instead of sitting in a bare counter."""

    def __init__(self, key: bytes | None = None) -> None:
        self._buf = bytearray()
        self.key = key
        self.crc_errors = 0
        self.auth_errors = 0
        reg = _metrics.get_registry()
        self._m_crc = reg.counter("repro_frame_crc_errors_total")
        self._m_auth = reg.counter("repro_frame_auth_errors_total")
        self._m_desync = reg.counter("repro_frame_resync_events_total")

    def feed(self, data: bytes) -> list[tuple[int, int, bytes]]:
        self._buf += data
        out = []
        while len(self._buf) >= HEADER_BYTES:
            magic, _ftype, _seq, length, _crc_f = _HEADER.unpack_from(
                self._buf)
            if magic != FRAME_MAGIC:
                self._m_desync.inc()
                _rate_warn.warn("desync",
                                f"frame stream desync: bad magic "
                                f"{magic:#x} with {len(self._buf)} B "
                                "buffered; connection must reconnect")
                raise FrameError(f"bad magic {magic:#x}: stream desync")
            if length > MAX_FRAME_PAYLOAD:
                self._m_desync.inc()
                _rate_warn.warn("desync",
                                f"frame stream desync: oversized frame "
                                f"({length} B)")
                raise FrameError(f"oversized frame ({length} B)")
            end = HEADER_BYTES + length
            if len(self._buf) < end:
                break
            frame = bytes(self._buf[:end])
            del self._buf[:end]
            try:
                out.append(decode_frame(frame, key=self.key))
            except FrameCorrupt as e:
                self.crc_errors += 1
                if self.key is not None:
                    self.auth_errors += 1
                    self._m_auth.inc()
                    _rate_warn.warn("auth",
                                    f"dropped unauthenticated frame: {e}")
                else:
                    self._m_crc.inc()
                    _rate_warn.warn("crc",
                                    f"dropped corrupt frame: {e}")
        return out

    def pending(self) -> int:
        return len(self._buf)


# ===========================================================================
# Transport seam — frame movers
# ===========================================================================

@dataclasses.dataclass
class TransportStats:
    frames_sent: int = 0
    frames_recv: int = 0
    wire_bytes_sent: int = 0          # frame bytes incl. headers
    wire_bytes_recv: int = 0
    reconnects: int = 0


class Transport:
    """The seam every wire backend implements: move opaque encoded frames
    between two endpoints. Discrete-frame semantics (one `send_frame` ==
    one `recv_frame` on the peer); delivery may fail with
    `ConnectionError` (endpoint severed — `reconnect()` and retry) or
    `TimeoutError` (nothing arrived within the recv deadline). Reliability
    is NOT this layer's job — `ReliableChannel` adds it on top."""

    def __init__(self) -> None:
        self.stats = TransportStats()

    def send_frame(self, frame: bytes) -> None:
        raise NotImplementedError

    def recv_frame(self, timeout: float | None = None) -> bytes:
        raise NotImplementedError

    def reconnect(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class _LoopbackState:
    """Shared half of a loopback pair: two inboxes + liveness flag."""

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.queues = ([], [])
        self.alive = True
        self.closed = False


class LoopbackTransport(Transport):
    """In-process transport: the encoded frame bytes object itself is
    appended to the peer's inbox (zero-copy — no serialization, no
    syscalls), preserving the current single-process behavior while
    exercising the exact frame path the socket backend uses. `sever()`
    drops the connection for BOTH endpoints (fault injection);
    `reconnect()` revives it, losing any in-flight frames — like a TCP
    reset."""

    def __init__(self, state: _LoopbackState, side: int):
        super().__init__()
        self._st = state
        self._side = side

    @classmethod
    def pair(cls) -> tuple["LoopbackTransport", "LoopbackTransport"]:
        st = _LoopbackState()
        return cls(st, 0), cls(st, 1)

    def send_frame(self, frame: bytes) -> None:
        st = self._st
        with st.cond:
            if st.closed or not st.alive:
                raise ConnectionError("loopback severed")
            st.queues[1 - self._side].append(frame)
            self.stats.frames_sent += 1
            self.stats.wire_bytes_sent += len(frame)
            st.cond.notify_all()

    def recv_frame(self, timeout: float | None = None) -> bytes:
        st = self._st
        deadline = None if timeout is None else time.monotonic() + timeout
        with st.cond:
            q = st.queues[self._side]
            while not q:
                if st.closed or not st.alive:
                    raise ConnectionError("loopback severed")
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("loopback recv timed out")
                st.cond.wait(remaining)
            frame = q.pop(0)
            self.stats.frames_recv += 1
            self.stats.wire_bytes_recv += len(frame)
            return frame

    def sever(self) -> None:
        with self._st.cond:
            self._st.alive = False
            self._st.cond.notify_all()

    def reconnect(self) -> None:
        st = self._st
        with st.cond:
            if st.closed:
                raise ConnectionError("loopback closed")
            st.alive = True
            st.queues[self._side].clear()   # in-flight frames died with the
            self.stats.reconnects += 1      # old connection
            st.cond.notify_all()

    def close(self) -> None:
        with self._st.cond:
            self._st.closed = True
            self._st.alive = False
            self._st.cond.notify_all()


class SocketTransport(Transport):
    """TCP transport: length-prefixed frames over one stream socket.

    `mode="listen"` binds (port 0 picks a free port — read `.port`) and
    accepts lazily; `mode="connect"` dials with bounded retries and
    exponential backoff + seeded jitter (a peer that hasn't bound yet is
    the normal case at two-process startup). A torn connection surfaces as
    `ConnectionError`; `reconnect()` re-accepts / re-dials. A bad magic in
    the byte stream means desync — the connection is dropped rather than
    resynchronized."""

    def __init__(self, mode: str, host: str = "127.0.0.1", port: int = 0, *,
                 io_timeout_s: float = 30.0, connect_retries: int = 12,
                 backoff_s: float = 0.05, backoff_max_s: float = 2.0,
                 jitter_seed: int = 1):
        super().__init__()
        import socket as socketlib
        if mode not in ("listen", "connect"):
            raise ValueError(f"mode must be 'listen' or 'connect', "
                             f"got {mode!r}")
        self.mode = mode
        self.host = host
        self.io_timeout_s = float(io_timeout_s)
        self.connect_retries = int(connect_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._jitter = np.random.default_rng(jitter_seed)
        self._socketlib = socketlib
        self._conn = None
        self._listener = None
        if mode == "listen":
            s = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
            s.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
            s.bind((host, port))
            s.listen(1)
            self._listener = s
            self.port = s.getsockname()[1]
        else:
            self.port = int(port)

    # -- connection lifecycle -------------------------------------------
    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_max_s, self.backoff_s * (2 ** attempt))
        return base * (0.5 + float(self._jitter.random()))

    def _ensure(self) -> None:
        if self._conn is not None:
            return
        sk = self._socketlib
        if self.mode == "listen":
            self._listener.settimeout(self.io_timeout_s)
            try:
                conn, _addr = self._listener.accept()
            except TimeoutError:
                raise TimeoutError("accept timed out waiting for peer")
        else:
            last = None
            for attempt in range(self.connect_retries + 1):
                try:
                    conn = sk.create_connection(
                        (self.host, self.port), timeout=self.io_timeout_s)
                    break
                except OSError as e:
                    last = e
                    time.sleep(self._backoff(attempt))
            else:
                raise ConnectionError(
                    f"connect to {self.host}:{self.port} failed after "
                    f"{self.connect_retries + 1} attempts: {last}")
        conn.setsockopt(sk.IPPROTO_TCP, sk.TCP_NODELAY, 1)
        conn.settimeout(self.io_timeout_s)
        self._conn = conn

    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def reconnect(self) -> None:
        self._drop()
        self.stats.reconnects += 1
        # lazily re-accepted / re-dialed on the next send/recv

    def close(self) -> None:
        self._drop()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None

    # -- frame IO --------------------------------------------------------
    def send_frame(self, frame: bytes) -> None:
        self._ensure()
        try:
            self._conn.sendall(frame)
        except (OSError, ValueError) as e:
            self._drop()
            raise ConnectionError(f"send failed: {e}") from e
        self.stats.frames_sent += 1
        self.stats.wire_bytes_sent += len(frame)

    def _read_exact(self, n: int, deadline: float | None) -> bytes:
        chunks = []
        got = 0
        while got < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("recv timed out")
                self._conn.settimeout(remaining)
            try:
                chunk = self._conn.recv(min(1 << 20, n - got))
            except TimeoutError:
                raise
            except OSError as e:
                self._drop()
                raise ConnectionError(f"recv failed: {e}") from e
            if not chunk:
                self._drop()
                raise ConnectionError("peer closed the connection")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def recv_frame(self, timeout: float | None = None) -> bytes:
        self._ensure()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            header = self._read_exact(HEADER_BYTES, deadline)
            magic, _ftype, _seq, length, _crc = _HEADER.unpack_from(header)
            if magic != FRAME_MAGIC or length > MAX_FRAME_PAYLOAD:
                self._drop()
                raise ConnectionError("frame stream desync (bad magic)")
            payload = self._read_exact(length, deadline) if length else b""
        finally:
            if self._conn is not None:
                self._conn.settimeout(self.io_timeout_s)
        frame = header + payload
        self.stats.frames_recv += 1
        self.stats.wire_bytes_recv += len(frame)
        return frame


@dataclasses.dataclass
class FaultStats:
    dropped: int = 0
    duplicated: int = 0
    corrupted: int = 0
    delayed: int = 0
    severed: int = 0


class FaultyTransport(Transport):
    """Deterministic fault injector around any `Transport` (send side).

    Each outgoing frame draws its fate from a seeded PCG64 stream indexed
    by send order, so a given (seed, rates, schedule) replays the same
    fault sequence every run: `drop` (never delivered), `dup` (delivered
    twice — exercises the receiver's seq dedup), `corrupt` (one bit
    flipped — caught by CRC32), `delay_s` (+ seeded `delay_jitter_s`)
    sleeps before delivery (one-way latency; set to `rtt/2` on BOTH
    endpoints to emulate a `NetModel`), `bandwidth_bps` adds a
    size-proportional serialization sleep, and `sever_at` (an iterable of
    send indices) tears the connection down at exactly those frames.
    """

    def __init__(self, inner: Transport, *, seed: int = 0,
                 drop: float = 0.0, dup: float = 0.0, corrupt: float = 0.0,
                 delay_s: float = 0.0, delay_jitter_s: float = 0.0,
                 bandwidth_bps: float | None = None,
                 sever_at: tuple | set | list = ()):
        super().__init__()
        self.inner = inner
        self._rng = np.random.default_rng(seed)
        self.drop = float(drop)
        self.dup = float(dup)
        self.corrupt = float(corrupt)
        self.delay_s = float(delay_s)
        self.delay_jitter_s = float(delay_jitter_s)
        self.bandwidth_bps = bandwidth_bps
        self.sever_at = set(int(i) for i in sever_at)
        self.faults = FaultStats()
        self._n_sent = 0

    @classmethod
    def emulate(cls, inner: Transport, net: NetModel,
                **kw) -> "FaultyTransport":
        """Latency/bandwidth emulation of a `NetModel` with no faults:
        one-way delay rtt/2 + bytes/bandwidth per frame. Wrap BOTH
        endpoints so each direction pays its half of the RTT."""
        return cls(inner, delay_s=net.rtt_s / 2.0,
                   bandwidth_bps=net.bandwidth_bps, **kw)

    @property
    def stats(self) -> TransportStats:       # delegate wire accounting
        return self.inner.stats

    @stats.setter
    def stats(self, v) -> None:              # Transport.__init__ writes it
        pass

    def send_frame(self, frame: bytes) -> None:
        i = self._n_sent
        self._n_sent += 1
        if i in self.sever_at:
            self.faults.severed += 1
            if hasattr(self.inner, "sever"):
                self.inner.sever()
            else:
                self.inner.reconnect()
            raise ConnectionError("fault injection: connection severed")
        sleep = 0.0
        if self.delay_s or self.delay_jitter_s:
            sleep += self.delay_s \
                + self.delay_jitter_s * float(self._rng.random())
            self.faults.delayed += 1
        if self.bandwidth_bps:
            sleep += len(frame) * 8.0 / float(self.bandwidth_bps)
        if sleep > 0.0:
            time.sleep(sleep)
        if self.drop and float(self._rng.random()) < self.drop:
            self.faults.dropped += 1
            return
        out = frame
        if self.corrupt and float(self._rng.random()) < self.corrupt:
            ba = bytearray(frame)
            pos = int(self._rng.integers(len(ba)))
            ba[pos] ^= 1 << int(self._rng.integers(8))
            out = bytes(ba)
            self.faults.corrupted += 1
        self.inner.send_frame(out)
        if self.dup and float(self._rng.random()) < self.dup:
            self.inner.send_frame(out)
            self.faults.duplicated += 1

    def recv_frame(self, timeout: float | None = None) -> bytes:
        return self.inner.recv_frame(timeout)

    def sever(self) -> None:
        if hasattr(self.inner, "sever"):
            self.inner.sever()

    def reconnect(self) -> None:
        self.inner.reconnect()

    def close(self) -> None:
        self.inner.close()


# ===========================================================================
# Reliable request/response channel
# ===========================================================================

class ReliableChannel:
    """Engine side of the wire protocol: strictly sequential
    request/response with at-least-once delivery and exactly-once effect.

    Each request gets the next monotonic sequence number; the frame is
    (re)sent until the matching response arrives, with exponential backoff
    + seeded jitter between tries, a per-try `try_timeout_s`, a per-op
    `deadline_s`, and `max_retries` before `WireError`. A torn connection
    triggers `Transport.reconnect()` and a resend. Because the responder
    dedups by sequence number (answering a replayed request from its
    response cache), redelivery is safe: drops, duplicates, and corrupt
    frames all collapse to 'resend until the response lands'.

    `reconnect_wait_s` is the *park budget* for supervised deployments:
    when the connection tears (peer crashed and is being restarted), up
    to that much additional time per request is spent parked — redial
    attempts inside the park window consume neither `max_retries` nor
    the original deadline, so a peer that takes seconds to respawn and
    re-import its runtime does not kill the survivor. The park window is
    bounded: once spent, normal retry/deadline accounting resumes, so
    total peer silence is still capped at deadline + park budget."""

    def __init__(self, transport: Transport, *, deadline_s: float = 30.0,
                 try_timeout_s: float = 0.5, max_retries: int = 10,
                 backoff_s: float = 0.02, backoff_max_s: float = 0.5,
                 jitter_seed: int = 7, auth_key: bytes | None = None,
                 reconnect_wait_s: float = 0.0):
        self.t = transport
        self.auth_key = auth_key
        self.deadline_s = float(deadline_s)
        self.try_timeout_s = float(try_timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.reconnect_wait_s = float(reconnect_wait_s)
        self._jitter = np.random.default_rng(jitter_seed)
        self._seq = 0
        self.retries = 0
        self.crc_drops = 0
        self.reconnects = 0
        self.parked_s = 0.0
        reg = _metrics.get_registry()
        self._m_retries = reg.counter("repro_wire_retries_total")
        self._m_crc_drops = reg.counter("repro_wire_resp_drops_total")
        self._m_reconnects = reg.counter("repro_wire_reconnects_total")
        self._h_rtt = reg.histogram(
            "repro_wire_request_seconds",
            buckets=_metrics.log_buckets(1e-5, 30.0))
        self._h_backoff = reg.histogram(
            "repro_wire_backoff_seconds",
            buckets=_metrics.log_buckets(1e-3, 10.0))

    def request(self, ftype: int, payload: bytes = b"", *,
                deadline_s: float | None = None,
                trace_id: bytes | None = None) -> bytes:
        """Send one request and return the matching response's payload.
        One request at a time: the fit loops (the pipelined minibatch
        executor included) call in from one host thread."""
        with _trace.span("wire.request", ftype=ftype, seq=self._seq):
            return self._request(ftype, payload, deadline_s=deadline_s,
                                 trace_id=trace_id)

    def _request(self, ftype: int, payload: bytes, *,
                 deadline_s: float | None,
                 trace_id: bytes | None) -> bytes:
        seq = self._seq
        self._seq += 1
        frame = encode_frame(ftype, seq, payload, key=self.auth_key,
                             trace_id=trace_id)
        want = ftype | RESP_BIT
        t0 = time.monotonic()
        deadline = t0 + (self.deadline_s if deadline_s is None
                         else float(deadline_s))
        attempt = 0
        park_until = None    # set on first sever when a park budget exists
        while True:
            now = time.monotonic()
            if now >= deadline and (park_until is None
                                    or now >= park_until):
                raise WireTimeout(
                    f"request seq={seq} ftype={ftype} deadline expired "
                    f"after {attempt} tries"
                    + (f" (incl. {self.reconnect_wait_s}s park)"
                       if park_until is not None else ""))
            try:
                self.t.send_frame(frame)
                limit = min(max(deadline, park_until or 0.0),
                            time.monotonic() + self.try_timeout_s)
                while True:
                    remaining = limit - time.monotonic()
                    if remaining <= 0:
                        break                      # per-try timeout: resend
                    try:
                        raw = self.t.recv_frame(remaining)
                    except TimeoutError:
                        break
                    try:
                        ft, rseq, rpayload, _rtid = decode_frame(
                            raw, key=self.auth_key, with_trace=True)
                    except FrameError:
                        self.crc_drops += 1   # corrupt/forged: wait/resend
                        self._m_crc_drops.inc()
                        continue
                    if ft == want and rseq == seq:
                        self._h_rtt.observe(time.monotonic() - t0)
                        return rpayload
                    # stale duplicate response of an earlier seq: ignore
            except ConnectionError:
                self.reconnects += 1
                self._m_reconnects.inc()
                self.t.reconnect()
                if self.reconnect_wait_s > 0.0:
                    now = time.monotonic()
                    if park_until is None:
                        park_until = now + self.reconnect_wait_s
                        _WIRE_LOG.warning(
                            "peer connection lost on seq %d: parking up "
                            "to %.1fs for a restart", seq,
                            self.reconnect_wait_s)
                    if now < park_until:
                        # parked: wait out the peer restart without
                        # charging the retry budget; deadline extends to
                        # the park window (bounded), not forever
                        pause = min(self.backoff_max_s, 0.2) \
                            * (0.5 + float(self._jitter.random()))
                        self.parked_s += pause
                        _trace.instant("wire.park", seq=seq)
                        time.sleep(pause)
                        continue
            attempt += 1
            self.retries += 1
            self._m_retries.inc()
            _trace.instant("wire.retry", seq=seq, attempt=attempt)
            if attempt > self.max_retries:
                raise WireError(
                    f"request seq={seq} ftype={ftype} failed after "
                    f"{attempt} tries (retries exhausted)")
            base = min(self.backoff_max_s, self.backoff_s * (2 ** (attempt - 1)))
            pause = base * (0.5 + float(self._jitter.random()))
            self._h_backoff.observe(pause)
            time.sleep(pause)


class Responder:
    """Peer side: decode, dedup by sequence number, answer via `handler`.

    Idempotent receive: the last (seq, response) pair is cached, so a
    redelivered request — duplicate frame, or a resend after the response
    was lost — is answered from the cache WITHOUT re-invoking the handler.
    A request older than the cache is a late duplicate and is dropped.
    CRC-corrupt frames are discarded (the engine resends); with an
    `auth_key`, tampered or unkeyed frames are dropped the same way.
    Silence beyond `idle_timeout_s` raises `WireTimeout` — the engine's
    heartbeats are what keep a long offline phase alive.

    Incarnation reset: a restarted engine begins a fresh sequence space
    at 0, which the stale-duplicate rule would silently drop forever. Its
    first request is therefore a `T_RESUME` carrying an incarnation nonce;
    when the nonce differs from the last one seen, the dedup window is
    reset BEFORE the seq checks — old-incarnation responses can never be
    replayed to the new incarnation, and the new sequence space starts
    clean. Same-incarnation duplicates still replay from the cache."""

    def __init__(self, transport: Transport, handler, *,
                 idle_timeout_s: float = 120.0,
                 auth_key: bytes | None = None):
        self.t = transport
        self.handler = handler
        self.auth_key = auth_key
        self.idle_timeout_s = float(idle_timeout_s)
        self.crc_drops = 0
        self.stale_drops = 0
        self.dedup_replays = 0
        self.reconnects = 0
        self.served = 0
        self.incarnation_resets = 0
        self._last_seq = -1
        self._last_resp: bytes | None = None
        self._incarnation: str | None = None
        reg = _metrics.get_registry()
        self._m_crc_drops = reg.counter("repro_responder_crc_drops_total")
        self._m_dedup = reg.counter("repro_responder_dedup_replays_total")
        self._m_stale = reg.counter("repro_responder_stale_drops_total")

    def _reply(self, resp: bytes) -> None:
        try:
            self.t.send_frame(resp)
        except ConnectionError:
            # the engine will reconnect and resend; the dedup cache then
            # re-serves this response without re-running the handler
            self.reconnects += 1
            self.t.reconnect()

    def serve_forever(self) -> None:
        # the idle deadline bounds TOTAL peer silence — recv timeouts and
        # failed redials alike. Without the budget, a dead engine would
        # livelock this loop: recv raises ConnectionError, the lazy redial
        # inside the next recv fails with ConnectionError too, and the
        # except arm would reconnect forever, never reaching the timeout.
        last_frame = time.monotonic()
        while True:
            budget = self.idle_timeout_s - (time.monotonic() - last_frame)
            try:
                if budget <= 0:
                    raise TimeoutError
                raw = self.t.recv_frame(budget)
            except TimeoutError:
                raise WireTimeout(
                    f"peer silent for {self.idle_timeout_s}s "
                    "(no request or heartbeat)")
            except ConnectionError:
                self.reconnects += 1
                self.t.reconnect()
                continue
            last_frame = time.monotonic()
            try:
                ftype, seq, payload, trace_id = decode_frame(
                    raw, key=self.auth_key, with_trace=True)
            except FrameError:
                self.crc_drops += 1
                self._m_crc_drops.inc()
                continue
            if ftype & RESP_BIT:
                continue                           # echo of our own class
            if ftype == T_RESUME:
                inc = _resume_incarnation(payload)
                if inc is not None and inc != self._incarnation:
                    # a (re)started engine announced itself: reset the
                    # dedup window so its fresh seq space isn't mistaken
                    # for stale duplicates of the previous incarnation
                    if self._incarnation is not None:
                        self.incarnation_resets += 1
                        _WIRE_LOG.warning(
                            "peer incarnation changed (%s -> %s): "
                            "resetting dedup window at seq %d",
                            self._incarnation, inc, self._last_seq)
                    self._incarnation = inc
                    self._last_seq, self._last_resp = -1, None
            if seq == self._last_seq:
                self.dedup_replays += 1
                self._m_dedup.inc()
                self._reply(self._last_resp)
                continue
            if seq < self._last_seq:
                self.stale_drops += 1              # late duplicate
                self._m_stale.inc()
                continue
            # the frame's trace id becomes this thread's ambient trace for
            # the handler's whole downstream (spans tag themselves with it)
            # and is echoed on the response so the requester can match
            if trace_id is not None:
                _trace.set_current_trace(_trace.trace_id_from_bytes(
                    trace_id))
            try:
                with _trace.span("wire.handle", ftype=ftype, seq=seq):
                    resp_payload = self.handler(ftype, payload)
            finally:
                if trace_id is not None:
                    _trace.set_current_trace(None)
            resp = encode_frame(ftype | RESP_BIT, seq, resp_payload,
                                key=self.auth_key, trace_id=trace_id)
            self._last_seq, self._last_resp = seq, resp
            self.served += 1
            self._reply(resp)
            if ftype == T_BYE:
                return


# ===========================================================================
# Resume negotiation — T_RESUME payload helpers + peer progress marker
# ===========================================================================

def _resume_incarnation(payload: bytes) -> str | None:
    """Best-effort incarnation nonce from a T_RESUME payload (the dedup
    reset must work even when the handler later rejects the message)."""
    try:
        v = json.loads(payload.decode())
        inc = v.get("inc")
        return str(inc) if inc is not None else None
    except Exception:
        return None


class PeerProgress:
    """The data party's durable record of fit progress: the latest
    checkpoint step the engine *published* (announced via a T_RESUME
    `publish` message after each atomic checkpoint rename) plus the
    config fingerprint it was published under.

    This is party B's half of the resume negotiation: on an engine
    (re)start the `hello` answers with (step, fingerprint) so both sides
    can agree on `min(step)`. B lagging behind A (engine died between
    rename and notify) is safe — the agreed step is then merely older,
    and resuming from an older published step is still bit-exact.

    With a `path` the marker is persisted atomically (tmp + fsync +
    `os.replace`) so it survives B's own crashes; without one it lives
    in memory (single-process tests)."""

    def __init__(self, path: str | None = None):
        import os
        self._os = os
        self.path = path
        self.step = -1                      # -1 == nothing published yet
        self.fingerprint: str | None = None
        if path is not None and os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    d = json.load(f)
                self.step = int(d.get("step", -1))
                self.fingerprint = d.get("fingerprint") or None
            except (OSError, ValueError):
                _WIRE_LOG.warning("unreadable progress marker %s; "
                                  "starting from scratch", path)

    def update(self, step: int, fingerprint: str | None) -> None:
        step = int(step)
        if step < self.step:
            return                          # never move backwards
        self.step = step
        if fingerprint:
            self.fingerprint = fingerprint
        if self.path is None:
            return
        os = self._os
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"step": self.step,
                       "fingerprint": self.fingerprint}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    import os
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                              # e.g. non-POSIX; best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def handle_resume(meta: dict, progress: PeerProgress) -> dict:
    """Responder-side T_RESUME logic, shared by `serve_peer` and tests.

    `hello` (engine (re)start): reject with a typed error when both
    sides hold fingerprints that disagree — no common step can be
    bit-exact, and restarting won't fix a config mismatch; otherwise
    answer our recorded (step, fingerprint). `publish`: record the
    engine's newly published checkpoint step."""
    op = meta.get("op")
    fp = meta.get("fp") or None
    if progress.fingerprint and fp and fp != progress.fingerprint:
        return {"error": "fingerprint-mismatch",
                "ours": progress.fingerprint, "theirs": fp}
    if op == "publish":
        progress.update(int(meta.get("step", -1)), fp)
        return {"ok": 1}
    # hello: bind our fingerprint on first contact so a future restart
    # of the engine under a different config is rejected
    if fp and progress.fingerprint is None:
        progress.update(progress.step, fp)
    return {"step": progress.step, "fp": progress.fingerprint}


# ===========================================================================
# WireSession — the CommLog plug + blob/heartbeat helpers
# ===========================================================================

def _pack_blob(meta: dict, arrays: dict | None = None) -> bytes:
    j = json.dumps(meta).encode()
    raw = b""
    if arrays:
        bio = io.BytesIO()
        np.savez(bio, **arrays)
        raw = bio.getvalue()
    return struct.pack(">I", len(j)) + j + raw


def _unpack_blob(payload: bytes) -> tuple[dict, dict]:
    (jlen,) = struct.unpack_from(">I", payload)
    meta = json.loads(payload[4:4 + jlen].decode())
    arrays = {}
    raw = payload[4 + jlen:]
    if raw:
        with np.load(io.BytesIO(raw)) as z:
            arrays = {k: z[k] for k in z.files}
    return meta, arrays


class WireSession:
    """Engine-side session over a `ReliableChannel`; what `CommLog.wire`
    points at. `exchange(nbytes, rounds)` performs `rounds` sequential
    request/response round-trips whose payloads total exactly `nbytes`
    (engine ships the ceil-half, the peer echoes the floor-half) — the
    modelled traffic, paid for real: rounds cost RTTs, bytes cost
    bandwidth. `send_arrays` moves real tensors (input upload, result
    download); `heartbeat` probes liveness."""

    def __init__(self, channel: ReliableChannel,
                 incarnation: str | None = None):
        self.chan = channel
        self.payload_bytes = 0        # protocol bytes shipped (both ways)
        self.rounds = 0
        self.blobs = 0
        self.incarnation = incarnation

    # -- resume negotiation ---------------------------------------------
    def _resume_request(self, body: dict,
                        deadline_s: float | None = None) -> dict:
        payload = json.dumps(body, sort_keys=True).encode()
        resp = self.chan.request(T_RESUME, payload, deadline_s=deadline_s)
        try:
            meta = json.loads(resp.decode()) if resp else {}
        except ValueError as e:
            raise WireError(f"malformed resume response: {e}") from e
        if meta.get("error") == "fingerprint-mismatch":
            raise ResumeMismatch(
                f"peer rejected resume: its fingerprint "
                f"{meta.get('ours')} != ours {body.get('fp')}")
        return meta

    def negotiate_resume(self, *, step: int, fingerprint: str | None,
                         deadline_s: float | None = None) -> int:
        """The (re)connect handshake: announce this
        incarnation + our latest published checkpoint step + config
        fingerprint; the peer answers with its recorded step. Returns
        the agreed resume step `min(ours, theirs)` (-1 == fresh start).
        Raises `ResumeMismatch` when the fingerprints disagree."""
        meta = self._resume_request(
            {"op": "hello", "inc": self.incarnation,
             "step": int(step), "fp": fingerprint},
            deadline_s=deadline_s)
        peer_step = int(meta.get("step", -1))
        return min(int(step), peer_step)

    def notify_publish(self, step: int, fingerprint: str | None) -> None:
        """Tell the peer a checkpoint step was atomically published, so
        its progress marker advances. Rides the reliable channel like any
        request; dying before OR after this notify is safe (the peer just
        lags, and min(step) resumes from the older published step)."""
        self._resume_request({"op": "publish", "inc": self.incarnation,
                              "step": int(step), "fp": fingerprint})

    def exchange(self, nbytes: int, rounds: int = 1) -> int:
        with _trace.span("wire.exchange", nbytes=int(nbytes),
                         rounds=int(rounds)):
            return self._exchange(int(nbytes), int(rounds))

    def _exchange(self, nbytes: int, rounds: int) -> int:
        rounds = max(1, int(rounds)) if nbytes else int(rounds)
        total = 0
        for r in range(rounds):
            this = nbytes // rounds + (1 if r < nbytes % rounds else 0)
            a_len = (this + 1) // 2
            b_len = this - a_len
            payload = struct.pack(">I", b_len) + bytes(a_len)
            resp = self.chan.request(T_EXCHANGE, payload)
            if len(resp) != b_len:
                raise WireError(
                    f"exchange round {r}: peer echoed {len(resp)} B, "
                    f"expected {b_len}")
            total += a_len + b_len
        if total != nbytes:
            raise WireError(f"exchange shipped {total} B != {nbytes} B")
        self.payload_bytes += total
        self.rounds += max(0, rounds)
        return total

    def send_arrays(self, meta: dict,
                    arrays: dict | None = None, *,
                    deadline_s: float | None = None) -> tuple[dict, dict]:
        resp = self.chan.request(T_BLOB, _pack_blob(meta, arrays),
                                 deadline_s=deadline_s)
        self.blobs += 1
        return _unpack_blob(resp)

    def heartbeat(self, deadline_s: float | None = None) -> None:
        self.chan.request(T_HEARTBEAT, b"", deadline_s=deadline_s)

    def bye(self) -> None:
        self.chan.request(T_BYE, b"")


def serve_peer(transport: Transport, *, on_blob=None,
               idle_timeout_s: float = 120.0,
               auth_key: bytes | None = None,
               progress: PeerProgress | None = None) -> Responder:
    """Run the data-party (responder) loop until the engine says BYE.

    EXCHANGE requests are answered with the requested echo half; BLOB
    requests go to `on_blob(meta, arrays) -> (meta, arrays) | None`;
    RESUME requests run the negotiation against `progress` (one is
    created in-memory when not given); heartbeats are acked empty.
    Returns the `Responder` (for its dedup / drop counters) once the
    engine closes the session."""
    prog = progress if progress is not None else PeerProgress()

    def handler(ftype: int, payload: bytes) -> bytes:
        _fp.probe("wire.serve")
        if ftype == T_EXCHANGE:
            (b_len,) = struct.unpack_from(">I", payload)
            return bytes(b_len)
        if ftype == T_BLOB:
            meta, arrays = _unpack_blob(payload)
            out = on_blob(meta, arrays) if on_blob is not None else None
            out_meta, out_arrays = out if out is not None else ({}, None)
            return _pack_blob(out_meta, out_arrays)
        if ftype == T_RESUME:
            try:
                meta = json.loads(payload.decode())
            except ValueError:
                meta = {}
            return json.dumps(handle_resume(meta, prog),
                              sort_keys=True).encode()
        return b""                                 # heartbeat / bye

    r = Responder(transport, handler, idle_timeout_s=idle_timeout_s,
                  auth_key=auth_key)
    r.serve_forever()
    return r
