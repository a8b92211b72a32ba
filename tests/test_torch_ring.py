"""Parity of the port's ring, sharing and dealer layers with the JAX
package: the same numpy-seeded inputs through both, compared word for word
(exact equality of uint64 words and of float64 decodes)."""
import numpy as np
import pytest
import torch

from repro.core import ring as jring
from repro.core import sharing as jsharing
from repro.core import triples as jtriples
from repro_torch.core import ring, sharing, triples
from repro_torch.core.channel import LAN, WAN, CommLog

RNG = np.random.default_rng(2024)


def _u64(x) -> np.ndarray:
    """Words of either package as uint64 numpy."""
    if isinstance(x, torch.Tensor):
        return ring.to_u64_numpy(x)
    return np.asarray(x, np.uint64)


def _words(shape):
    return RNG.integers(0, 1 << 64, shape, dtype=np.uint64)


def _wrap_heavy(shape):
    """Words at the top of the ring: every sum and product overflows."""
    return np.uint64(0xFFFFFFFFFFFFFFFF) - RNG.integers(0, 1 << 20, shape,
                                                        dtype=np.uint64)


def _t(x):
    return ring.from_u64_numpy(x)


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------

def test_u64_roundtrip_keeps_every_bit():
    x = np.concatenate([_words(50), _wrap_heavy(50),
                        np.array([0, 1, 1 << 63, (1 << 64) - 1], np.uint64)])
    t = ring.from_u64_numpy(x)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(ring.to_u64_numpy(t), x)


@pytest.mark.parametrize("v", [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                               -1, -(1 << 63)])
def test_to_i64_is_the_same_word(v):
    got = ring.to_i64(v)
    assert -(1 << 63) <= got < (1 << 63)
    assert got % (1 << 64) == v % (1 << 64)


def test_mask_constant():
    assert _u64(torch.tensor([ring.MASK]))[0] == np.uint64(jring.MASK)


@pytest.mark.parametrize("f", [0, 13, 20])
def test_encode_decode_parity(f):
    x = np.concatenate([RNG.uniform(-1e5, 1e5, 200),
                        np.array([0.5, 1.5, 2.5, -0.5, -1.5]) / (1 << f),
                        np.array([0.0, -0.0, 3.25, -7.75])])
    enc_t = ring.encode(x, f)
    np.testing.assert_array_equal(_u64(enc_t), _u64(jring.encode(x, f)))
    words = np.concatenate([_words(100), _wrap_heavy(100)])
    np.testing.assert_array_equal(ring.decode(_t(words), f).numpy(),
                                  np.asarray(jring.decode(words, f)))


def test_neg_arith_rshift_from_int_parity():
    words = np.concatenate([_words(200), _wrap_heavy(200)])
    np.testing.assert_array_equal(_u64(ring.neg(_t(words))),
                                  _u64(jring.neg(words)))
    for s in (1, 20, 63):
        np.testing.assert_array_equal(_u64(ring.arith_rshift(_t(words), s)),
                                      _u64(jring.arith_rshift(words, s)))
    ints = RNG.integers(-(1 << 40), 1 << 40, 100)
    np.testing.assert_array_equal(_u64(ring.from_int(ints)),
                                  _u64(jring.from_int(ints)))


@pytest.mark.parametrize("s", [0, 1, 20, 37, 62, 63, 64])
def test_logical_rshift_matches_uint64_shift(s):
    words = np.concatenate([_words(300), _wrap_heavy(300)])
    want = words >> np.uint64(s) if s < 64 else np.zeros_like(words)
    np.testing.assert_array_equal(_u64(ring.logical_rshift(_t(words), s)), want)


def test_ring_ops_wrap_like_uint64():
    a, b = _wrap_heavy((40, 33)), _words((40, 33))
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(_u64(ta + tb), a + b)
    np.testing.assert_array_equal(_u64(ta - tb), a - b)
    np.testing.assert_array_equal(_u64(ta * tb), a * b)
    for s in (1, 31, 63):
        np.testing.assert_array_equal(_u64(ta << s), a << np.uint64(s))


def test_rand_np_and_nbytes():
    r1 = ring.rand_np(np.random.default_rng(5), (7, 3))
    r2 = jring.rand_np(np.random.default_rng(5), (7, 3))
    np.testing.assert_array_equal(r1, r2)
    assert ring.nbytes((4, 5)) == jring.nbytes((4, 5)) == 160
    assert ring.nbytes(()) == jring.nbytes(()) == 8


# ---------------------------------------------------------------------------
# sharing
# ---------------------------------------------------------------------------

def test_share_and_rec_parity():
    x = np.concatenate([_words(60), _wrap_heavy(60)])
    a_t = sharing.share(x, np.random.default_rng(9))
    a_j = jsharing.share(x, np.random.default_rng(9))
    for i in (0, 1):
        np.testing.assert_array_equal(_u64(a_t[i]), _u64(a_j[i]))
    np.testing.assert_array_equal(_u64(sharing.rec(a_t)), x)


def test_share_real_and_rec_real_parity():
    x = RNG.uniform(-5e4, 5e4, (6, 9))
    a_t = sharing.share_real(x, np.random.default_rng(3))
    a_j = jsharing.share_real(x, np.random.default_rng(3))
    for i in (0, 1):
        np.testing.assert_array_equal(_u64(a_t[i]), _u64(a_j[i]))
    np.testing.assert_array_equal(sharing.rec_real(a_t).numpy(),
                                  np.asarray(jsharing.rec_real(a_j)))


def test_share_b_rec_b_zeros_public_parity():
    x = _wrap_heavy((5, 4))
    b_t = sharing.share_b(x, np.random.default_rng(4))
    b_j = jsharing.share_b(x, np.random.default_rng(4))
    for i in (0, 1):
        np.testing.assert_array_equal(_u64(b_t[i]), _u64(b_j[i]))
    np.testing.assert_array_equal(_u64(sharing.rec_b(b_t)), x)
    z = sharing.zeros_like(sharing.share(x, np.random.default_rng(1)))
    assert z.shape == (5, 4) and not z.s0.any() and not z.s1.any()
    p_t = sharing.public_to_ashare(_t(x))
    p_j = jsharing.public_to_ashare(x)
    for i in (0, 1):
        np.testing.assert_array_equal(_u64(p_t[i]), _u64(p_j[i]))


# ---------------------------------------------------------------------------
# channel accounting
# ---------------------------------------------------------------------------

def test_commlog_accounting():
    log = CommLog()
    log.send(100, tag="S1")
    log.send(50, tag="S2", rounds=3)
    log.send(7, tag="S1", phase="offline", rounds=2)
    assert log.total_bytes() == 157 and log.total_bytes("online") == 150
    assert log.total_rounds("online") == 4
    assert log.by_tag("online") == {"S1": (100, 1), "S2": (50, 3)}
    assert log.time_estimate(LAN, "online") == LAN.time_s(150, 4)
    assert WAN.time_s(0, 2) == 2 * 40e-3
    other = log.copy()
    other.merge(log, phase="offline")
    assert other.by_tag("offline") == {"S1": (14, 4)}
    restored = CommLog()
    restored.restore(log.state())
    assert restored.by_tag("online") == log.by_tag("online")
    restored.reset()
    assert restored.total_bytes() == 0 and log.wire is None


# ---------------------------------------------------------------------------
# dealer
# ---------------------------------------------------------------------------

def _dealer_pair(seed, advance=None):
    return (triples.TrustedDealer(seed=seed, advance=advance),
            jtriples.TrustedDealer(seed=seed, advance=advance))


def _assert_triple_equal(t_t, t_j):
    for part_t, part_j in zip(t_t, t_j):
        for i in (0, 1):
            assert tuple(part_t[i].shape) == tuple(part_j[i].shape)
            np.testing.assert_array_equal(_u64(part_t[i]), _u64(part_j[i]))


@pytest.mark.parametrize("advance", [None, "some"])
def test_dealer_words_every_class(advance):
    mm_key = ("matmul", (6, 4), (4, 3))
    adv = None if advance is None else {mm_key: 2, ("mul", (5,)): 1,
                                        ("bin", (2, 3)): 3, ("rand", (4,)): 2,
                                        ("seed", ()): 1}
    dt, dj = _dealer_pair(77, adv)
    for _ in range(2):
        _assert_triple_equal(dt.matmul_triple((6, 4), (4, 3), tag="S1"),
                             dj.matmul_triple((6, 4), (4, 3), tag="S1"))
        _assert_triple_equal(dt.mul_triple((5,), tag="S2"),
                             dj.mul_triple((5,), tag="S2"))
        _assert_triple_equal(dt.bin_triple((2, 3), tag="S2"),
                             dj.bin_triple((2, 3), tag="S2"))
        _assert_triple_equal(dt.mul_triple((), tag="S3"),
                             dj.mul_triple((), tag="S3"))
        np.testing.assert_array_equal(_u64(dt.rand((4,))), _u64(dj.rand((4,))))
        assert dt.mask_seed() == dj.mask_seed()
    assert (dt.n_matmul, dt.n_mul, dt.n_bin) == (dj.n_matmul, dj.n_mul,
                                                 dj.n_bin) == (2, 4, 2)
    assert dt.log.by_tag("offline") == dj.log.by_tag("offline")
    assert dt.modelled_ot_seconds == pytest.approx(dj.modelled_ot_seconds,
                                                   rel=0, abs=0)


def test_dealer_advance_equals_skipped_draws():
    """advance={class: n} lands where n requests of that class would."""
    fresh = triples.TrustedDealer(seed=3)
    for _ in range(3):
        fresh.bin_triple((4,))
    jumped = triples.TrustedDealer(seed=3, advance={("bin", (4,)): 3})
    _assert_triple_equal(fresh.bin_triple((4,)), jumped.bin_triple((4,)))


def test_dealer_shape_checks_and_helpers():
    d = triples.TrustedDealer(seed=0)
    with pytest.raises(ValueError, match="inner dims"):
        d.matmul_triple((2, 3), (4, 5))
    with pytest.raises(ValueError, match="flat tuple"):
        d.mul_triple(((2, 3), (3, 4)))
    with pytest.raises(ValueError, match="negative"):
        d.bin_triple((2, -1))
    assert triples.serve_seed(11) == jtriples.serve_seed(11)
    for key in [("matmul", (6, 4), (4, 3)), ("mul", (5, 2)), ("bin", (3,)),
                ("rand", (7,)), ("seed", ())]:
        assert triples._class_words(key) == jtriples._class_words(key)
    assert triples.ot_mul_triple_bytes(10) == jtriples.ot_mul_triple_bytes(10)
    assert triples.ot_bin_triple_bytes(640) == jtriples.ot_bin_triple_bytes(640)


def test_dealer_hands_out_tensors_on_its_device():
    d = triples.TrustedDealer(seed=1, device="cpu")
    t = d.matmul_triple((3, 2), (2, 4))
    assert t.z.s0.device.type == "cpu" and t.z.s0.dtype == torch.int64
    z = sharing.rec(t.z)
    uv = sharing.rec(t.u) @ sharing.rec(t.v)
    assert torch.equal(z, uv)
