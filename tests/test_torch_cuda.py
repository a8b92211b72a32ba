"""The hand-written CUDA kernels against their plain PyTorch versions on
the card (exact equality), and dense and sparse GPU fits against the CPU
fits. Needs an
NVIDIA GPU and nvcc; skipped without them. Imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ring
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans
from repro_torch.kernels import ksadder, modmatmul, spmm

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels are built with nvcc)")
    return torch.device("cuda")


def _words(shape, dev):
    return ring.from_u64_numpy(
        RNG.integers(0, 1 << 64, shape, dtype=np.uint64), dev)


@pytest.mark.parametrize("shape", [(2048, 18, 5), (5, 2048, 24), (1, 200, 7),
                                   (129, 129, 129), (5, 100_000, 18)])
def test_ring_matmul_kernel_equals_plain(cuda, shape):
    m, kdim, n = shape
    a, b = _words((m, kdim), cuda), _words((kdim, n), cuda)
    before = modmatmul.LAUNCHES
    got = modmatmul.ring_matmul(a, b)
    assert modmatmul.LAUNCHES == before + 1
    assert torch.equal(got, modmatmul.ring_matmul_plain(a, b))
    # transposed / sliced views, as the main path passes them
    at = _words((kdim + 3, m), cuda)
    assert torch.equal(modmatmul.ring_matmul(at.T[:, 3:], b[:, :]),
                       modmatmul.ring_matmul_plain(at.T[:, 3:].contiguous(), b))


@pytest.mark.parametrize("shape", [(2048, 2), (2048, 1), (5,), (1, 1), ()])
@pytest.mark.parametrize("party0", [True, False])
def test_ks_carry_share_kernel_equals_plain(cuda, shape, party0):
    flat = [_words(shape, cuda) for _ in range(6)]
    lvls = [_words((6, 2) + shape, cuda) for _ in range(4)]
    lvls.append(_words((6, 3) + shape, cuda)[:, :2])   # a strided stack
    before = ksadder.LAUNCHES
    got = ksadder.ks_carry_share(*flat, *lvls, party0=party0)
    assert ksadder.LAUNCHES == before + 1
    assert torch.equal(got, ksadder.ks_carry_share_plain(*flat, *lvls,
                                                         party0=party0))


@pytest.mark.parametrize("case", [((12500, 1, 8, 128), 128, 3),
                                  ((16, 782, 8, 128), 100096, 3),
                                  ((64, 20, 8, 128), 2560, 1),
                                  ((64, 20, 8, 128), 2560, 8),
                                  ((33, 9, 4, 64), 640, 5)],
                         ids=["S1", "S3", "k1", "k8", "bm4_bk64"])
def test_spmm_ell_kernel_equals_plain(cuda, case):
    (nrb, maxb, bm, bk), d_pad, k = case
    blocks, y = _words((nrb, maxb, bm, bk), cuda), _words((d_pad, k), cuda)
    idx = RNG.integers(0, d_pad // bk, (nrb, maxb))
    counts = RNG.integers(0, maxb + 1, nrb)
    counts[0], counts[-1] = maxb, 0                # a full and an empty block
    pad = np.arange(maxb)[None, :] >= counts[:, None]
    idx[pad] = 1 << 30                               # never read
    idx = torch.as_tensor(idx.astype(np.int32), device=cuda)
    counts = torch.as_tensor(counts.astype(np.int32), device=cuda)
    before = spmm.LAUNCHES
    got = spmm.spmm_ell(blocks, idx, counts, y)
    assert spmm.LAUNCHES == before + 1
    assert torch.equal(got, spmm.spmm_ell_plain(blocks, idx, counts, y))
    # a transposed Y view, as S3 passes it
    yt = _words((k, d_pad), cuda)
    assert torch.equal(spmm.spmm_ell(blocks, idx, counts, yt.T),
                       spmm.spmm_ell_plain(blocks, idx, counts,
                                           yt.T.contiguous()))


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_sparse_gpu_fit_equals_cpu_fit(cuda, partition):
    x = RNG.normal(size=(96, 8)) + RNG.integers(0, 3, (96, 1)) * 4.0
    x *= RNG.random(x.shape) >= 0.7
    a, b = (x[:, :4], x[:, 4:]) if partition == "vertical" else (x[:40], x[40:])
    res = {}
    for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
        cfg = KMeansConfig(k=3, iters=2, partition=partition, seed=2,
                           sparse=True, backend=backend, device=device)
        res[backend] = SecureKMeans(cfg).fit(a, b)
    g, c = res["cuda"], res["torch"]
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
    assert g.log.by_tag("online") == c.log.by_tag("online")
    assert g.log.by_tag("offline") == c.log.by_tag("offline")
    assert g.he_seconds == c.he_seconds > 0.0


@pytest.mark.parametrize("partition", ["vertical", "horizontal"])
def test_gpu_fit_equals_cpu_fit(cuda, partition):
    x = RNG.normal(size=(96, 6)) + RNG.integers(0, 3, (96, 1)) * 4.0
    a, b = (x[:, :3], x[:, 3:]) if partition == "vertical" else (x[:40], x[40:])
    res = {}
    for backend, device in (("cuda", "cuda"), ("torch", "cpu")):
        cfg = KMeansConfig(k=3, iters=2, partition=partition, seed=2,
                           backend=backend, device=device)
        res[backend] = SecureKMeans(cfg).fit(a, b)
    g, c = res["cuda"], res["torch"]
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(g, field)[i].cpu(),
                               getattr(c, field)[i])
    assert g.log.by_tag("online") == c.log.by_tag("online")
    assert g.log.by_tag("offline") == c.log.by_tag("offline")
