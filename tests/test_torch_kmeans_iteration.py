"""The port's single-launch online iteration (`launch/kmeans_step.py`'s
legacy forms) against the JAX package's: the offline schedule at the
kmeans-fraud cell's REDUCED and FULL sizes (recorded on meta, nothing
allocated), the iteration's words against the reference's jitted
`online_iteration_fn` and `fit_iteration_fn` (backend="xla") on identical
inputs and the reference's offline tensors carried across, the fused form
against the split S1/S3 pair, FUSE_BEAVER on against off, and the sample-axis
argument specs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import kmeans_fraud as JKF
from repro.core import ring as jring
from repro.core.kmeans import _encode_np
from repro.core.triples import TrustedDealer as JTrustedDealer
from repro.launch import kmeans_step as JKS
from repro_torch.configs import kmeans_fraud as KF
from repro_torch.core import protocol
from repro_torch.core import ring
from repro_torch.core.triples import TrustedDealer
from repro_torch.launch import kmeans_step as KS

SIZES = [(32, 4, 2, 2), (64, 8, 4, 4)]          # (n, d, k, d_a)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("size", ["REDUCED", "FULL"])
def test_record_offline_shapes_match_reference(size, sparse):
    mine, ref = getattr(KF, size), getattr(JKF, size)
    args = (mine.n, mine.d, mine.k, mine.d_a)
    assert args == (ref.n, ref.d, ref.k, ref.d_a)
    got = KS.record_offline_shapes(*args, sparse=sparse)
    want = JKS.record_offline_shapes(*args, sparse=sparse)
    assert got == [(kind, tuple(shape)) for kind, shape in want]
    specs = KS.offline_tensor_specs(got, mine.n)
    assert all(t.device.type == "meta" and t.dtype == torch.int64
               for t in specs)
    assert [tuple(t.shape) for t in specs] == [
        tuple(s.shape) for s in JKS.offline_tensor_specs(want, ref.n)]


def _inputs(n, d, k, d_a, sparse, seed):
    """Encoded data, centroid shares and (sparse) 8 Protocol-2 result
    shares as uint64 words, and the reference's offline tensors."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(0, 0.2, (n, d))
    enc = _encode_np(x, jring.F)
    mu = _encode_np(x[rng.choice(n, k, replace=False)], jring.F)
    r = rng.integers(0, 2 ** 63, (k, d), dtype=np.uint64)
    words = [enc[:, :d_a], enc[:, d_a:], r, (mu - r).astype(np.uint64)]
    if sparse:
        for s in [(n, k), (n, k), (k, d_a), (k, d - d_a)]:
            words += [rng.integers(0, 2 ** 64, s, dtype=np.uint64,
                                   endpoint=False) for _ in range(2)]
    flat = JKS.materialize_offline(
        JKS.record_offline_shapes(n, d, k, d_a, sparse=sparse),
        JTrustedDealer(seed=seed + 1))
    words += [np.asarray(t, np.uint64) for t in flat]
    return [np.ascontiguousarray(w, np.uint64) for w in words]


def _port(words):
    return [ring.from_u64_numpy(w) for w in words]


def _u64(ts):
    return [ring.to_u64_numpy(t) for t in ts]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "n%d_d%d_k%d" % s[:3])
def test_online_iteration_words_match_reference(size, sparse):
    n, d, k, d_a = size
    words = _inputs(n, d, k, d_a, sparse, seed=n + d)
    jfn, jargs = JKS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                         backend="xla")
    want = jax.jit(jfn)(*[jnp.asarray(w) for w in words])
    fn, args = KS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                      device="cpu")
    assert [tuple(a.shape) for a in args] == [tuple(a.shape) for a in jargs]
    assert all(a.device.type == "meta" for a in args)
    got = fn(*_port(words))
    for g, w in zip(_u64(got), want):
        np.testing.assert_array_equal(g, np.asarray(w, np.uint64))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "n%d_d%d_k%d" % s[:3])
def test_fit_iteration_words_match_reference(size):
    n, d, k, d_a = size
    words = _inputs(n, d, k, d_a, False, seed=2 * n + d)
    jfn, jargs, jreq = JKS.fit_iteration_fn(n, d, k, d_a, backend="xla")
    want = jax.jit(jfn)(*[jnp.asarray(w) for w in words])
    fn, args, req = KS.fit_iteration_fn(n, d, k, d_a, device="cpu")
    assert req == [(kind, tuple(s)) for kind, s in jreq]
    assert len(args) == len(jargs)
    got = fn(*_port(words))
    assert len(got) == 4
    for g, w in zip(_u64(got), want):
        np.testing.assert_array_equal(g, np.asarray(w, np.uint64))


def _port_offline(requests, seed):
    return KS.materialize_offline(requests, TrustedDealer(seed=seed,
                                                          device="cpu"))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "n%d_d%d_k%d" % s[:3])
def test_fused_iteration_equals_split_pair(size, sparse):
    """The single-launch iteration is the S1 -> S3 pair of `fit_programs`
    fed the same flat list split at the length of S1's part; its schedule
    is S1's followed by S3's."""
    n, d, k, d_a = size
    words = _port(_inputs(n, d, k, d_a, sparse, seed=3 * n + d)[:4])
    he = []
    if sparse:
        rng = np.random.default_rng(n)
        he = [ring.from_u64_numpy(rng.integers(0, 2 ** 64, s, np.uint64))
              for s in [(n, k), (n, k), (k, d_a), (k, d - d_a)]
              for _ in range(2)]
    requests = KS.record_offline_shapes(n, d, k, d_a, sparse=sparse)
    progs = KS.fit_programs("vertical", sparse, (n, d_a), (n, d - d_a), k,
                            backend="torch", device="cpu")
    assert requests == progs.s1_requests + progs.s3_requests
    flat = _port_offline(requests, seed=7)
    cut = len(KS.offline_tensor_specs(progs.s1_requests, n))
    fn, _ = KS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                   device="cpu")
    fused = fn(*words, *he, *flat)
    c = progs.s1(*words, *he[:4], *flat[:cut])
    split = progs.s3(*words, *c, *he[4:], *flat[cut:])
    for a, b in zip(fused, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sparse", [False, True])
def test_fuse_beaver_on_equals_off(sparse, monkeypatch):
    n, d, k, d_a = SIZES[1]
    words = _port(_inputs(n, d, k, d_a, sparse, seed=5))
    fn, _ = KS.online_iteration_fn(n, d, k, d_a, sparse=sparse,
                                   device="cpu")
    on = fn(*words)
    schedule = KS.record_offline_shapes(n, d, k, d_a, sparse=sparse)
    monkeypatch.setattr(protocol, "FUSE_BEAVER", False)
    assert KS.record_offline_shapes(n, d, k, d_a, sparse=sparse) == schedule
    off = fn(*words)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_arg_shardings_match_reference():
    """The sample axis (the first dim of size n of every argument) over
    ('pod','data'), the rest replicated, on both production meshes."""
    from _torch_plans import abstract_mesh
    from repro_torch.models.sharding import Sharding, Spec
    k = KF.REDUCED
    _, args = KS.online_iteration_fn(k.n, k.d, k.k, k.d_a, device="cpu")
    _, jargs = JKS.online_iteration_fn(k.n, k.d, k.k, k.d_a)

    class Mesh:
        def __init__(self, names):
            self.mesh_dim_names = names

    for names, shape in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16))):
        got = KS.arg_shardings(Mesh(names), args, k.n)
        want = JKS.arg_shardings(abstract_mesh(shape, names), jargs, k.n)
        assert all(isinstance(s, Sharding) for s in got)
        assert [tuple(s.spec) for s in got] == [tuple(s.spec) for s in want]
        axes = Spec(names[:-1])[0]        # 'data' or ('pod', 'data')
        assert got[0].spec == Spec(axes, None)         # x_a: (n, d_a)
        assert got[2].spec == Spec(None, None)         # mu0: (k, d)
