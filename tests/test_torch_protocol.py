"""Op-by-op parity of the port's 2PC protocols with the JAX package: under
one dealer seed and the same numpy-drawn input shares, every op must give
the same share words, the same dealer counters and the same per-tag
traffic (exact equality: the ring is integer)."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import protocol as JP
from repro.core.sharing import AShare as JAShare
from repro.core.sharing import BShare as JBShare
from repro_torch.core import protocol as P
from repro_torch.core import ring
from repro_torch.core.channel import CommLog
from repro_torch.core.interop import shares_from_numpy, shares_to_numpy
from repro_torch.core.sharing import BShare, rec, rec_real, share_real
from repro_torch.launch import kmeans_step as KS

RNG = np.random.default_rng(77)


def _ctxs(seed=5):
    return (JP.make_ctx(seed, backend="xla"),
            P.make_ctx(seed, backend="torch", device="cpu"))


def _real_share_words(x):
    enc = np.round(np.asarray(x, np.float64) * (1 << ring.F)) \
        .astype(np.int64).astype(np.uint64)
    s0 = RNG.integers(0, 1 << 64, enc.shape, dtype=np.uint64)
    return s0, enc - s0


def _pair(s0, s1):
    """The same share words in both packages."""
    return (JAShare(jnp.asarray(s0), jnp.asarray(s1)),
            shares_from_numpy(s0, s1))


def _reals(x):
    return _pair(*_real_share_words(x))


def _assert_same(out_j, out_t, jctx, tctx):
    """Share words, dealer counters and CommLog per tag and phase."""
    if isinstance(out_j, tuple) and not isinstance(out_j, (JAShare, JBShare)):
        for oj, ot in zip(out_j, out_t):
            _assert_same(oj, ot, jctx, tctx)
        return
    got = shares_to_numpy(out_t)
    for i in (0, 1):
        want = np.asarray(out_j[i], np.uint64)
        assert got[i].shape == want.shape
        np.testing.assert_array_equal(got[i], want)
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(tctx.dealer, attr) == getattr(jctx.dealer, attr), attr
    for phase in ("online", "offline"):
        assert tctx.log.by_tag(phase) == jctx.log.by_tag(phase), phase


@pytest.mark.parametrize("f", [0, 1, 20, 40])
def test_trunc_parity(f):
    x = RNG.uniform(-1e3, 1e3, (9, 4))
    aj, at = _reals(x)
    jctx, tctx = _ctxs()
    _assert_same(JP.trunc(aj, f), P.trunc(at, f), jctx, tctx)


def test_linear_ops_parity():
    aj, at = _reals(RNG.uniform(-50, 50, (6, 3)))
    bj, bt = _reals(RNG.uniform(-50, 50, (6, 3)))
    c = RNG.integers(0, 1 << 64, (6, 3), dtype=np.uint64)
    ct = ring.from_u64_numpy(c)
    jctx, tctx = _ctxs()
    pairs = [(JP.add(aj, bj), P.add(at, bt)), (JP.sub(aj, bj), P.sub(at, bt)),
             (JP.add_pub(aj, c), P.add_pub(at, ct)),
             (JP.pub_sub(c, aj), P.pub_sub(ct, at)),
             (JP.mul_pub(aj, c), P.mul_pub(at, ct)),
             (JP.lshift(aj, 7), P.lshift(at, 7)), (JP.neg(aj), P.neg(at))]
    for out_j, out_t in pairs:
        _assert_same(out_j, out_t, jctx, tctx)
    m = RNG.integers(0, 1 << 64, (4, 6), dtype=np.uint64)
    _assert_same(JP.matmul_pub_l(m, aj, "xla"),
                 P.matmul_pub_l(ring.from_u64_numpy(m), at, "torch"),
                 jctx, tctx)
    y = m[:3, :2].copy()
    _assert_same(JP.matmul_pub_r(aj, y, "xla"),
                 P.matmul_pub_r(at, ring.from_u64_numpy(y), "torch"),
                 jctx, tctx)


@pytest.mark.parametrize("shapes", [((7, 5), (7, 5)), ((4, 3, 1), (1, 3, 6)),
                                    ((), ())])
@pytest.mark.parametrize("trunc_f", [None, 20])
def test_smul_parity(shapes, trunc_f):
    aj, at = _reals(RNG.uniform(-30, 30, shapes[0]))
    bj, bt = _reals(RNG.uniform(-30, 30, shapes[1]))
    jctx, tctx = _ctxs()
    for tag in ("S1", "S3"):
        jctx.tag = tctx.tag = tag
        _assert_same(JP.smul(jctx, aj, bj, trunc_f=trunc_f),
                     P.smul(tctx, at, bt, trunc_f=trunc_f), jctx, tctx)


@pytest.mark.parametrize("shape", [(9, 4, 3), (1, 200, 7), (3, 50, 1)])
def test_smatmul_parity(shape):
    n, d, k = shape
    aj, at = _reals(RNG.uniform(-10, 10, (n, d)))
    bj, bt = _reals(RNG.uniform(-10, 10, (d, k)))
    jctx, tctx = _ctxs()
    _assert_same(JP.smatmul(jctx, aj, bj, trunc_f=20),
                 P.smatmul(tctx, at, bt, trunc_f=20), jctx, tctx)
    _assert_same(JP.smatmul(jctx, aj, bj), P.smatmul(tctx, at, bt),
                 jctx, tctx)


def test_band_and_xor_parity():
    words = [RNG.integers(0, 1 << 64, (5, 4), dtype=np.uint64)
             for _ in range(4)]
    xj = JBShare(jnp.asarray(words[0]), jnp.asarray(words[1]))
    yj = JBShare(jnp.asarray(words[2]), jnp.asarray(words[3]))
    xt = BShare(*[ring.from_u64_numpy(w) for w in words[:2]])
    yt = BShare(*[ring.from_u64_numpy(w) for w in words[2:]])
    jctx, tctx = _ctxs()
    _assert_same(JP.band(jctx, xj, yj), P.band(tctx, xt, yt), jctx, tctx)
    _assert_same(JP.bxor(xj, yj), P.bxor(xt, yt), jctx, tctx)
    _assert_same(JP.bxor_pub(xj, words[0]),
                 P.bxor_pub(xt, ring.from_u64_numpy(words[0])), jctx, tctx)


@pytest.mark.parametrize("shape", [(16, 8), (3,), (1, 1), ()])
def test_msb_carry_b2a_parity(shape):
    x = RNG.uniform(-1e4, 1e4, shape)
    aj, at = _reals(x)
    jctx, tctx = _ctxs()
    bj, bt = JP.msb_carry(jctx, aj), P.msb_carry(tctx, at)
    _assert_same(bj, bt, jctx, tctx)
    np.testing.assert_array_equal(
        ring.to_u64_numpy(bt.b0 ^ bt.b1), (np.asarray(x) < 0).astype(np.uint64))
    _assert_same(JP.b2a_bit(jctx, bj), P.b2a_bit(tctx, bt), jctx, tctx)


def test_msb_carry_wrap_heavy_words():
    """Shares whose words sit at the top of the ring (every add carries)."""
    s0 = np.uint64(0xFFFFFFFFFFFFFFFF) - RNG.integers(0, 1 << 20, (64,),
                                                      dtype=np.uint64)
    s1 = RNG.integers(0, 1 << 64, (64,), dtype=np.uint64)
    aj, at = _pair(s0, s1)
    jctx, tctx = _ctxs()
    _assert_same(JP.msb_carry(jctx, aj), P.msb_carry(tctx, at), jctx, tctx)


def test_cmp_lt_and_mux_parity():
    aj, at = _reals(RNG.uniform(-5, 5, (12, 3)))
    bj, bt = _reals(RNG.uniform(-5, 5, (1, 3)))       # broadcast
    jctx, tctx = _ctxs()
    zj, zt = JP.cmp_lt(jctx, aj, bj), P.cmp_lt(tctx, at, bt)
    _assert_same(zj, zt, jctx, tctx)
    cj, ct = _reals(RNG.uniform(-5, 5, (12, 3)))
    _assert_same(JP.mux(jctx, zj, aj, cj), P.mux(tctx, zt, at, ct),
                 jctx, tctx)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("return_min", [False, True])
def test_argmin_onehot_parity(k, return_min):
    d = RNG.uniform(-20, 20, (11, k))
    aj, at = _reals(d)
    jctx, tctx = _ctxs()
    jctx.tag = tctx.tag = "S2"
    out_j = JP.argmin_onehot(jctx, aj, return_min=return_min)
    out_t = P.argmin_onehot(tctx, at, return_min=return_min)
    _assert_same(out_j, out_t, jctx, tctx)
    oh = out_t[0] if return_min else out_t
    np.testing.assert_array_equal(rec(oh).numpy().argmax(1), d.argmin(1))


@pytest.mark.parametrize("max_den,extra_bits", [(100, 0), (2048, 5),
                                                ((1 << 20) + 5, 0),
                                                (1 << 22, 3)])
def test_reciprocal_parity(max_den, extra_bits):
    """max_den > 2^20 takes the m > f branch (truncating rescale)."""
    den = RNG.integers(1, max_den + 1, (6,)).astype(np.uint64)
    s0 = RNG.integers(0, 1 << 64, den.shape, dtype=np.uint64)
    aj, at = _pair(s0, den - s0)
    jctx, tctx = _ctxs()
    jctx.tag = tctx.tag = "S3"
    rj = JP.reciprocal(jctx, aj, max_den, extra_bits=extra_bits)
    rt = P.reciprocal(tctx, at, max_den, extra_bits=extra_bits)
    _assert_same(rj, rt, jctx, tctx)
    scale = ring.F + min(extra_bits, int(np.ceil(np.log2(max_den))))
    np.testing.assert_allclose(rec_real(rt, scale).numpy(),
                               1.0 / den.astype(np.float64), rtol=2e-2,
                               atol=2.0 ** -(ring.F - 2))


def test_share_real_feeds_protocol():
    """Shares made by the port's own sharing helpers reconstruct exactly."""
    a = share_real(np.array([1.5, -2.25]), np.random.default_rng(0))
    np.testing.assert_array_equal(rec_real(a).numpy(), [1.5, -2.25])


class _SendLog(CommLog):
    """A CommLog that also keeps every send, in order."""

    def __init__(self):
        super().__init__()
        self.sends = []

    def send(self, nbytes, *, tag="misc", phase="online", rounds=1):
        self.sends.append((nbytes, tag, phase, rounds))
        super().send(nbytes, tag=tag, phase=phase, rounds=rounds)


def _smul_chain_reciprocal(ctx, den, max_den, *, f=ring.F, extra_bits=0):
    """The reciprocal as 2 * iters `smul`s, one Beaver product at a time:
    the loop `P.reciprocal` ran before its loop became one backend call."""
    m = max(0, int(np.ceil(np.log2(max_den))))
    extra_bits = min(extra_bits, m)
    if m <= f:
        dp = P.lshift(den, f - m)
    else:
        dp = P.trunc(P.mul_pub(den, ring.to_i64(1 << (2 * f - m))), f)
    two = ring.encode(2.0, f)
    x = P.pub_sub(two, dp)
    for _ in range(m + 6):
        dx = P.smul(ctx, dp, x, trunc_f=f)
        x = P.smul(ctx, x, P.pub_sub(two, dx), trunc_f=f)
    return P.trunc(x, m - extra_bits) if m > extra_bits else x


@pytest.mark.parametrize("max_den,extra_bits", [(2048, 5), ((1 << 20) + 5, 0),
                                                (6_362_620, 11)])
def test_reciprocal_draws_and_sends_as_the_smul_chain(max_den, extra_bits):
    """One backend call draws the smul chain's triples in its order and
    shapes, and sends its openings with the same bytes and rounds, one
    send a product: a RecordingDealer sees the same requests, and a
    ListDealer replay of the same words gives the same shares, consumes
    as many tensors and logs the same sends."""
    den = RNG.integers(1, max_den + 1, (5,)).astype(np.uint64)
    s0 = RNG.integers(0, 1 << 64, den.shape, dtype=np.uint64)
    den_t = shares_from_numpy(s0, den - s0)
    iters = P.newton_iters(max_den)
    recs = {}
    for name, fn in (("kernel_call", P.reciprocal),
                     ("chain", _smul_chain_reciprocal)):
        dealer = KS.RecordingDealer("cpu")
        fn(P.Ctx(dealer=dealer, log=CommLog(), backend="torch", tag="S3"),
           den_t, max_den, extra_bits=extra_bits)
        recs[name] = dealer.requests
    assert recs["kernel_call"] == recs["chain"] == [("mul", (5,))] * (2 * iters)
    flat = [ring.from_u64_numpy(RNG.integers(0, 1 << 64, (5,),
                                             dtype=np.uint64))
            for _ in range(6 * 2 * iters)]
    runs = {}
    for name, fn in (("kernel_call", P.reciprocal),
                     ("chain", _smul_chain_reciprocal)):
        dealer, log = KS.ListDealer(flat), _SendLog()
        out = fn(P.Ctx(dealer=dealer, log=log, backend="torch", tag="S3"),
                 den_t, max_den, extra_bits=extra_bits)
        runs[name] = (out, dealer.i, log)
    (got, used, log), (want, want_used, want_log) = (runs["kernel_call"],
                                                     runs["chain"])
    np.testing.assert_array_equal(shares_to_numpy(got), shares_to_numpy(want))
    assert used == want_used == len(flat)
    assert log.sends == want_log.sends == [(2 * 2 * 8 * 5, "S3", "online",
                                            1)] * (2 * iters)
    assert dict(log.bytes) == dict(want_log.bytes)
    assert dict(log.rounds) == dict(want_log.rounds)
