"""The frozen work count held to hand-worked values."""
import pytest

from bench import work


def test_offline_words_by_hand():
    # n = 64, d = 8 + 8, k = 4. S1: |mu|^2 6*4*16 = 384; two joint
    # triples 2*(64*8 + 8*4 + 64*4) = 1600 each; the tournament's two
    # levels: CMP (n, 2) = 6*128 + 6*6*2*128 + 2*128 + 6*128 = 11008 and
    # its MUX 6*128 = 768; CMP (n, 1) = 5504 and the stacked MUX
    # 6*64*(1 + 4) = 1920. S3: two joint triples 1600 each, CMP (4,) = 344
    # and MUX 24, Newton-Raphson 2*(6 + 6)*24 = 576, num*r and MUX 768.
    assert work.offline_words(64, 8, 8, 4) == (
        384 + 3200 + 11008 + 768 + 5504 + 1920
        + 3200 + 344 + 24 + 576 + 768)
    assert work.offline_words(64, 8, 8, 4) == 27696


@pytest.mark.parametrize("shape, words", [
    ((64, 3, 5, 5), 34060),          # odd k: a bye at two levels
    ((100, 7, 9, 3), 30800),
    ((524288, 512, 512, 16), 3290798208),
    ((4194304, 18, 24, 5), 2667584104),
])
def test_offline_words_at_cells(shape, words):
    assert work.offline_words(*shape) == words


def test_ring_matmul_bound_at_the_kmeans_fraud_cell():
    # 10 long-K (16, n) @ (n, 512) and 10 tall (n, 512) @ (512, 16) at
    # n = 524,288: 15.4061 ms of ring operations (0.7703 each)
    ms = 1e3 * (10 * work.ring_matmul_bound_s(16, 524288, 512)
                + 10 * work.ring_matmul_bound_s(524288, 512, 16))
    assert ms == pytest.approx(15.4061, abs=1e-4)


def test_step_bounds():
    kf = work.step_bound_s(524288, 512, 512, 16)
    assert kf["bound"] == "compute"
    assert 1e3 * kf["bound_s"] == pytest.approx(15.4061, abs=1e-4)
    assert work.ring_macs(524288, 1024, 16) * 2 == 171798691840
    fd = work.step_bound_s(4194304, 18, 24, 5)
    assert fd["bound"] == "memory"
    assert 1e3 * fd["compute_s"] == pytest.approx(1.5797, abs=1e-4)
    assert work.step_bytes(4194304, 18, 24, 5) == 8 * (
        4194304 * 42 + 4 * 5 * 42 + 2667584104 + 2 * 4194304 * 5)


def test_ks_carry_share_bound():
    # 36 words a word over HBM beats the 96 32-bit ops a word
    assert work.ks_carry_share_bound_s(1 << 20) == pytest.approx(
        8 * 36 * (1 << 20) / 3.35e12)
