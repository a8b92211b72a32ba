"""The port's wire against the JAX package's: frames byte for byte the
reference's (keyed and traced included), the frame decoder, a wired torch
fit over `LoopbackTransport` equal to the unwired one and to the JAX
wired fit with the same (nbytes, rounds) exchanges in the same order, the
chaos fit under `FaultyTransport`, wired scoring, a torch engine against
the JAX package's `serve_peer` over TCP (and back), the resume
negotiation, and the two-process launcher (`python -m
repro_torch.launch.two_party --device cpu`), clean and killed-and-resumed.
The contracts are those of the reference's tests/test_wire.py and
tests/test_resume_negotiation.py."""
import json
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro.core import channel as JC
from repro.core import faultpoints as JF
from repro.core import kmeans as JK
from repro_torch.core import channel as C
from repro_torch.core import faultpoints
from repro_torch.core.interop import shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.launch import two_party


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


def _data(partition="vertical", sparse=False):
    return _split(_blobs(48, 4, 2, seed=11, sparse_frac=0.5 if sparse
                         else 0.0), partition)


def _common(**kw):
    return dict(dict(k=2, iters=2, seed=5), **kw)


def _port(**kw):
    return SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                     **_common(**kw)))


def _jax(**kw):
    return JK.SecureKMeans(JK.KMeansConfig(backend="xla", **_common(**kw)))


def _words(share):
    if hasattr(share[0], "numpy"):
        return shares_to_numpy(share)
    return tuple(np.asarray(s, np.uint64) for s in share)


def _assert_same_fit(got, want) -> None:
    for field in ("centroids", "assignment"):
        for g, w in zip(_words(getattr(got, field)),
                        _words(getattr(want, field))):
            np.testing.assert_array_equal(g, w)
    assert got.iters_run == want.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(got.dealer, attr) == getattr(want.dealer, attr), attr
    for phase in ("online", "offline"):
        assert got.log.by_tag(phase) == want.log.by_tag(phase), phase


def _recording(mod):
    """A WireSession of package `mod` that records every exchange's
    (nbytes, rounds)."""
    class Recording(mod.WireSession):
        def __init__(self, chan):
            super().__init__(chan)
            self.calls = []

        def exchange(self, nbytes, rounds=1):
            self.calls.append((int(nbytes), int(rounds)))
            return super().exchange(nbytes, rounds)

    return Recording


def _wired_pair(mod, **chan_kw):
    """A loopback engine session of package `mod` and its responder
    thread."""
    ta, tb = mod.LoopbackTransport.pair()
    th = threading.Thread(target=mod.serve_peer, args=(tb,),
                          kwargs={"idle_timeout_s": 60.0}, daemon=True)
    th.start()
    return _recording(mod)(mod.ReliableChannel(ta, **chan_kw)), th


def _close(ws, th) -> None:
    ws.bye()
    th.join(timeout=30)
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

KEY = C.session_key("test-passphrase")
FRAMES = [(1, 0, b""), (2, 7, b"hello world"), (5, 2**63, bytes(range(256))),
          (6, 12345, b'{"op": "hello"}'), (3, 1, b"\x00" * 4096)]


@pytest.mark.parametrize("key", [None, KEY], ids=["crc", "keyed"])
@pytest.mark.parametrize("trace", [None, b"\x01\x02\x03\x04\x05\x06\x07\x08"],
                         ids=["plain", "traced"])
@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: f"t{f[0]}")
def test_encode_frame_byte_identical_to_reference(frame, trace, key):
    ftype, seq, payload = frame
    got = C.encode_frame(ftype, seq, payload, key=key, trace_id=trace)
    assert got == JC.encode_frame(ftype, seq, payload, key=key,
                                  trace_id=trace)
    # each package decodes the other's frames
    for dec in (C.decode_frame, JC.decode_frame):
        assert dec(got, key=key, with_trace=True) == (ftype, seq, payload,
                                                      trace)
    assert C.session_key("x") == JC.session_key("x")
    assert (C.HEADER_BYTES, C.FRAME_MAGIC) == (JC.HEADER_BYTES,
                                               JC.FRAME_MAGIC)


@pytest.mark.parametrize("chunk", [1, 7, 64, 997])
def test_frame_decoder_split_reads(chunk):
    """Any chunking of the byte stream yields the same frames."""
    rng = np.random.default_rng(chunk)
    frames = [(i % 5 + 1, i, rng.bytes(int(rng.integers(0, 600))))
              for i in range(6)]
    stream = b"".join(JC.encode_frame(*f) for f in frames)
    dec = C.FrameDecoder()
    got = []
    for lo in range(0, len(stream), chunk):
        got.extend(dec.feed(stream[lo:lo + chunk]))
    assert got == frames
    assert dec.pending() == 0 and dec.crc_errors == 0


def test_frame_decoder_drops_corrupt_and_unkeyed():
    a = C.encode_frame(C.T_EXCHANGE, 1, b"hello world")
    bad = bytearray(a)
    bad[-3] ^= 0x40
    dec = C.FrameDecoder()
    assert dec.feed(bytes(bad) + C.encode_frame(C.T_EXCHANGE, 2, b"ok")) \
        == [(C.T_EXCHANGE, 2, b"ok")]
    assert dec.crc_errors == 1
    kdec = C.FrameDecoder(key=KEY)
    assert kdec.feed(a) == [] and kdec.auth_errors == 1
    keyed = C.encode_frame(C.T_SCORE, 3, b"p", key=KEY)
    assert kdec.feed(keyed) == [(C.T_SCORE, 3, b"p")]
    with pytest.raises(C.FrameError):
        C.FrameDecoder().feed(b"\x00" * 64)
    with pytest.raises(C.FrameError):
        C.decode_frame(a[:10])
    with pytest.raises(C.FrameCorrupt):
        C.decode_frame(a[:-2])


def test_reliable_channel_exactly_once_under_chaos():
    """Faults both ways: every request's handler runs exactly once and
    every exchange ships its exact byte count."""
    ta, tb = C.LoopbackTransport.pair()
    fa = C.FaultyTransport(ta, seed=3, drop=0.15, dup=0.15, corrupt=0.1,
                           sever_at=(9,))
    fb = C.FaultyTransport(tb, seed=4, drop=0.1, dup=0.1, corrupt=0.1)
    calls = []

    def handler(ftype, payload):
        if ftype == C.T_EXCHANGE:
            (b_len,) = struct.unpack_from(">I", payload)
            calls.append(b_len)
            return bytes(b_len)
        return b""

    resp = C.Responder(fb, handler, idle_timeout_s=30.0)
    th = threading.Thread(target=resp.serve_forever, daemon=True)
    th.start()
    ws = C.WireSession(C.ReliableChannel(fa, try_timeout_s=0.05,
                                         backoff_s=0.002, max_retries=200))
    for i in range(30):
        assert ws.exchange(101 + i, rounds=1) == 101 + i
    _close(ws, th)
    assert calls == [(101 + i) - (101 + i + 1) // 2 for i in range(30)]
    assert fa.faults.severed == 1 and ws.chan.reconnects >= 1
    assert resp.dedup_replays + resp.crc_drops + resp.stale_drops > 0


def test_emulated_network_and_blobs():
    """`FaultyTransport.emulate` delays each frame by rtt/2 plus its bytes
    over the bandwidth; blobs ship numpy arrays both ways."""
    net = C.NetModel("test", 1e9, 0.004)
    ta, tb = C.LoopbackTransport.pair()
    ea = C.FaultyTransport.emulate(ta, net)
    assert (ea.delay_s, ea.bandwidth_bps) == (0.002, 1e9)

    def on_blob(meta, arrays):
        return {"ok": meta["op"]}, {"y": arrays["x"] * 2}

    th = threading.Thread(target=C.serve_peer, args=(tb,),
                          kwargs={"on_blob": on_blob}, daemon=True)
    th.start()
    ws = C.WireSession(C.ReliableChannel(ea))
    x = np.arange(12, dtype=np.uint64).reshape(3, 4)
    meta, arrays = ws.send_arrays({"op": "double"}, {"x": x})
    assert meta == {"ok": "double"}
    np.testing.assert_array_equal(arrays["y"], x * 2)
    ws.heartbeat()
    _close(ws, th)
    assert ea.faults.delayed == 3


# ---------------------------------------------------------------------------
# wired fits and scoring against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(partition="horizontal", sparse=True),
    dict(offline="pooled", sparse=True),
    dict(offline="streamed", batch_size=16, pipeline=True),
    dict(offline="pooled", batch_size=16, pipeline=False, sparse=True)],
    ids=["on_demand", "on_demand_sparse_h", "pooled_sparse",
         "minibatch_pipe", "minibatch_seq_sparse"])
def test_wired_fit_equals_unwired_and_reference(kw):
    """The same words as the unwired fit and the JAX wired fit; the peer
    sees the reference's exchanges, (nbytes, rounds) in the same order;
    the wire's payload bytes and rounds are the CommLog's online totals."""
    sparse = kw.get("sparse", False)
    a, b = _data(kw.get("partition", "vertical"), sparse)
    ws, th = _wired_pair(C)
    rt = _port(**kw).fit(a, b, wire=ws)
    _close(ws, th)
    _assert_same_fit(rt, _port(**kw).fit(a, b))
    jws, jth = _wired_pair(JC)
    rj = _jax(**kw).fit(a, b, wire=jws)
    _close(jws, jth)
    _assert_same_fit(rt, rj)
    assert ws.calls == jws.calls and ws.calls
    assert ws.payload_bytes == rt.log.total_bytes("online")
    assert ws.rounds == rt.log.total_rounds("online")
    if sparse:
        assert rt.he_seconds == rj.he_seconds


@pytest.mark.parametrize("compiled", [None, False], ids=["program", "eager"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_wired_scoring_equals_reference(sparse, compiled):
    a, b = _data("vertical", sparse)
    jkm = _jax(sparse=sparse)
    rj = jkm.fit(a, b)
    tkm = _port(sparse=sparse)
    tkm.fit(a, b)
    qa, qb = _split(_blobs(12, 4, 2, seed=3), "vertical")
    ws, th = _wired_pair(C)
    pt = tkm.score(qa, qb, wire=ws, compiled=compiled)
    pt2 = tkm.predict(qa, qb, wire=ws, compiled=compiled)
    _close(ws, th)
    jws, jth = _wired_pair(JC)
    pj = jkm.score(qa, qb, rj, wire=jws, compiled=compiled)
    jkm.predict(qa, qb, rj, wire=jws, compiled=compiled)
    _close(jws, jth)
    for g, w in zip(_words(pt.scores), _words(pj.scores)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_words(pt.assignment), _words(pj.assignment)):
        np.testing.assert_array_equal(g, w)
    assert pt.log.by_tag("online") == pj.log.by_tag("online")
    assert ws.calls == jws.calls and ws.calls
    assert ws.payload_bytes == pt.log.total_bytes("online") \
        + pt2.log.total_bytes("online")


@pytest.mark.parametrize("partition,sparse",
                         [("vertical", False), ("horizontal", True)])
def test_chaos_fit_equals_clean_fit(partition, sparse):
    """Seeded drops, delays, duplicates, corruption and one severed
    connection, keyed frames: the wired fit ends with the clean fit's
    words."""
    a, b = _data(partition, sparse)
    ta, tb = C.LoopbackTransport.pair()
    fa = C.FaultyTransport(ta, seed=13, drop=0.05, dup=0.05, corrupt=0.05,
                           delay_s=0.0005, sever_at=(25,))
    fb = C.FaultyTransport(tb, seed=14, drop=0.03, dup=0.03, corrupt=0.03)
    th = threading.Thread(target=C.serve_peer, args=(fb,),
                          kwargs={"idle_timeout_s": 60.0, "auth_key": KEY},
                          daemon=True)
    th.start()
    ws = C.WireSession(C.ReliableChannel(
        fa, try_timeout_s=0.05, backoff_s=0.002, max_retries=500,
        deadline_s=120.0, auth_key=KEY))
    km = _port(partition=partition, sparse=sparse, offline="pooled")
    r_chaos = km.fit(a, b, wire=ws)
    _close(ws, th)
    _assert_same_fit(r_chaos, km.fit(a, b))
    f = fa.faults
    assert f.severed == 1 and f.dropped + f.duplicated + f.corrupted > 0


@pytest.mark.parametrize("engine", ["torch", "jax"])
def test_engine_against_the_other_packages_peer_over_tcp(engine):
    """A torch engine completes a fit against the JAX package's
    `serve_peer` over a socket on 127.0.0.1, and a JAX engine against the
    port's; both end with the unwired fit's words."""
    eng, peer = (C, JC) if engine == "torch" else (JC, C)
    a, b = _data()
    listen = eng.SocketTransport("listen", port=0, io_timeout_s=30.0)
    dial = peer.SocketTransport("connect", port=listen.port,
                                io_timeout_s=30.0)
    out = {}
    th = threading.Thread(
        target=lambda: out.update(r=peer.serve_peer(dial,
                                                    idle_timeout_s=60.0)),
        daemon=True)
    th.start()
    ws = eng.WireSession(eng.ReliableChannel(listen))
    km = _port() if engine == "torch" else _jax()
    res = km.fit(a, b, wire=ws)
    ws.bye()
    th.join(timeout=30)
    listen.close()
    dial.close()
    _assert_same_fit(res, _jax().fit(a, b))
    assert out["r"].served == ws.rounds + 1         # the exchanges and BYE
    assert ws.payload_bytes == res.log.total_bytes("online")


def test_pipelined_minibatch_sends_in_sequence(monkeypatch):
    """The pipelined fit runs batch t+1's `pre` exchange before batch t's
    `mid`, on one host thread: the peer sees one request at a time, its
    sequence numbers counting up by one (no retry, no stale drop)."""
    a, b = _data()
    seqs = []
    real = C.Responder.serve_forever

    def serve_forever(self):
        inner = self.handler

        def handler(ftype, payload):
            seqs.append(self._last_seq + 1)
            return inner(ftype, payload)
        self.handler = handler
        return real(self)

    monkeypatch.setattr(C.Responder, "serve_forever", serve_forever)
    ws, th = _wired_pair(C)
    _port(offline="pooled", batch_size=8, pipeline=True).fit(a, b, wire=ws)
    _close(ws, th)
    assert seqs == list(range(len(seqs)))
    assert ws.chan.retries == 0


# ---------------------------------------------------------------------------
# resume negotiation
# ---------------------------------------------------------------------------

def test_peer_progress_and_handle_resume_equal_reference(tmp_path):
    for mod in (C, JC):
        p = mod.PeerProgress(str(tmp_path / f"{mod.__name__}.json"))
        assert p.step == -1 and p.fingerprint is None
        assert mod.handle_resume({"op": "hello", "fp": "fp1"}, p) == \
            {"step": -1, "fp": "fp1"}
        assert mod.handle_resume({"op": "publish", "step": 3, "fp": "fp1"},
                                 p) == {"ok": 1}
        p.update(1, None)                    # never backwards
        assert mod.PeerProgress(p.path).step == 3
        assert mod.handle_resume({"op": "hello", "fp": "fp2"}, p) == \
            {"error": "fingerprint-mismatch", "ours": "fp1", "theirs": "fp2"}
    with open(tmp_path / "torn.json", "w") as f:
        f.write("{torn")
    assert C.PeerProgress(str(tmp_path / "torn.json")).step == -1


def test_negotiate_resume_and_incarnation_reset():
    """min(step) is agreed over the wire; a mismatched fingerprint raises
    `ResumeMismatch`; a restarted engine's fresh sequence space is served
    after its incarnation announce, not dropped as stale."""
    prog = C.PeerProgress()
    ta, tb = C.LoopbackTransport.pair()
    out = {}
    th = threading.Thread(target=lambda: out.update(
        r=C.serve_peer(tb, idle_timeout_s=30.0, progress=prog)), daemon=True)
    th.start()
    ws = C.WireSession(C.ReliableChannel(ta), incarnation="inc-1")
    assert ws.negotiate_resume(step=2_000_000, fingerprint="fpA") == -1
    ws.notify_publish(2_000_000, "fpA")
    ws.exchange(10, rounds=2)
    assert prog.step == 2_000_000
    # a restarted engine: seq 0 again, a new incarnation
    ws2 = C.WireSession(C.ReliableChannel(ta), incarnation="inc-2")
    assert ws2.negotiate_resume(step=3_000_000, fingerprint="fpA") \
        == 2_000_000
    with pytest.raises(C.ResumeMismatch):
        ws2.negotiate_resume(step=1, fingerprint="fpB")
    ws2.exchange(6, rounds=1)
    _close(ws2, th)
    assert out["r"].incarnation_resets == 1


def test_faultpoints_arm_and_probe(monkeypatch):
    """A probe is a no-op until armed; the nth hit prints the DYING line
    and exits with KILL_EXIT_CODE."""
    died = []
    monkeypatch.setattr(faultpoints.os, "_exit", died.append)
    faultpoints.disarm_all()
    faultpoints.probe("fit.mid_s1")
    faultpoints.arm("fit.mid_s1:2, wire.serve")
    assert faultpoints.armed() == {"fit.mid_s1": 2, "wire.serve": 1}
    faultpoints.probe("fit.mid_s1")
    assert died == []
    faultpoints.probe("fit.mid_s1")
    assert died == [faultpoints.KILL_EXIT_CODE] == [JF.KILL_EXIT_CODE]
    faultpoints.disarm_all()


# ---------------------------------------------------------------------------
# two processes over TCP
# ---------------------------------------------------------------------------

def _run_two_party(extra_a, extra_b=(), timeout=300, b_wait=60):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.two_party"]
    a = subprocess.Popen(cmd + ["--role", "A", "--port", "0", "--device",
                                "cpu"] + list(extra_a),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
    line = a.stdout.readline()
    assert line.startswith("LISTENING "), line
    b = subprocess.Popen(cmd + ["--role", "B", "--port", line.split()[1]]
                         + list(extra_b),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
    a_out = a.communicate(timeout=timeout)[0]
    try:
        b_out = b.communicate(timeout=b_wait)[0]
    except subprocess.TimeoutExpired:
        b.kill()
        b_out = b.communicate()[0]
    return a.returncode, a_out, b.returncode, b_out


def test_two_process_fit_equals_in_process_and_reference(tmp_path):
    """Party A (the torch engine on the CPU) and party B as processes over
    TCP: A's shares, counters and traffic equal the in-process fit's and
    the JAX fit's; B never initialized CUDA."""
    out = str(tmp_path / "a.npz")
    rc_a, a_out, rc_b, b_out = _run_two_party(["--out", out])
    assert rc_a == 0, a_out
    assert rc_b == 0, b_out
    stats = json.loads(b_out.split("WIRE_STATS ")[1].splitlines()[0])
    assert stats["cuda_initialized"] is False
    x = two_party.make_data(48, 4, 2, 5)
    xa, xb = two_party.split_data(x, "vertical")
    km = _port(iters=2)
    res = km.fit(xa, xb)
    rj = _jax(iters=2).fit(xa, xb)
    z = np.load(out)
    meta = json.loads(bytes(z["meta"]))
    for k, want in (("mu0", res.centroids.s0), ("mu1", res.centroids.s1),
                    ("c0", res.assignment.s0), ("c1", res.assignment.s1)):
        np.testing.assert_array_equal(z[k], want.numpy().view(np.uint64))
    np.testing.assert_array_equal(z["mu0"], np.asarray(rj.centroids.s0,
                                                       np.uint64))
    assert meta["counters"] == {a: int(getattr(res.dealer, a))
                                for a in ("n_matmul", "n_mul", "n_bin")}
    assert meta["fit_online"] == {t: list(v) for t, v in
                                  res.log.by_tag("online").items()}
    assert meta["fit_wire_payload_bytes"] == res.log.total_bytes("online")
    assert meta["fit_wire_rounds"] == res.log.total_rounds("online")


def test_two_process_kill_and_resume(tmp_path):
    """A dies (KILL_EXIT_CODE) right after the iteration-1 checkpoint; a
    fresh A with --resume against a fresh B, under keyed seeded faults,
    ends with a clean run's words."""
    ckdir = str(tmp_path / "ck")
    clean, resumed = str(tmp_path / "clean.npz"), str(tmp_path / "r.npz")
    common = ["--iters", "3", "--offline", "pooled"]
    rc, out, _, _ = _run_two_party(common + ["--out", clean])
    assert rc == 0, out
    # B outlives A by its redials and idle budget: stop it at once
    rc, out, _, _ = _run_two_party(
        common + ["--checkpoint-dir", ckdir, "--die-at-iter", "1"],
        b_wait=0.1)
    assert rc == faultpoints.KILL_EXIT_CODE, out
    assert "DYING" in out
    faults = ["--fault-drop", "0.02", "--fault-dup", "0.02",
              "--fault-corrupt", "0.02", "--auth-key", "k"]
    rc, out, rc_b, b_out = _run_two_party(
        common + ["--checkpoint-dir", ckdir, "--resume", "--out", resumed]
        + faults, ["--auth-key", "k"])
    assert rc == 0, out
    assert rc_b == 0, b_out
    zc, zr = np.load(clean), np.load(resumed)
    for k in ("mu0", "mu1", "c0", "c1", "p0", "p1"):
        np.testing.assert_array_equal(zc[k], zr[k])
    mc, mr = json.loads(bytes(zc["meta"])), json.loads(bytes(zr["meta"]))
    for k in ("counters", "fit_online", "fit_offline", "predict_online"):
        assert mc[k] == mr[k], k
