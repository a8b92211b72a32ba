"""The port's TripleBank against the JAX package's: provisioning serves the
same words for any worker count; a bank saved by either package loads in
the other and serves the same words; corrupt files are refused; stock-outs
replenish (or raise in strict mode) and the top-up daemon keeps the served
words those of a synchronous bank; and a bank-fed fit — full batch and
minibatch — equals the JAX package's bank-fed fit word for word. The
contracts are those of the reference's tests/test_offline_bank.py and
tests/test_serve.py."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import kmeans as JK
from repro.core import triples as JT
from repro_torch.core import triples as T
from repro_torch.core.interop import result_from_reference, shares_to_numpy
from repro_torch.core.kmeans import KMeansConfig, SecureKMeans

COMBOS = [("vertical", False), ("vertical", True),
          ("horizontal", False), ("horizontal", True)]


def _fit_data(partition, seed=0, sparse=False):
    rng = np.random.default_rng(seed)

    def blob(n, d):
        x = rng.uniform(-2, 2, (n, d))
        if sparse:
            x *= rng.random((n, d)) > 0.6
        return x
    if partition == "vertical":
        return blob(48, 5), blob(48, 4)
    return blob(30, 6), blob(18, 6)


def _pair(**common):
    return (JK.SecureKMeans(JK.KMeansConfig(backend="xla", **common)),
            SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                      **common)))


def _port_words(bank) -> dict:
    return {k: [tuple(np.asarray(a, np.uint64) if not torch.is_tensor(a)
                      else shares_to_numpy((a, a))[0] for a in e)
                for e, _shelf in q] for k, q in bank._queues.items()}


def _ref_words(bank) -> dict:
    return {k: [tuple(np.asarray(a, np.uint64) for a in e) for e in q]
            for k, q in bank._queues.items()}


def _assert_same_queues(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for ck in want:
        assert len(got[ck]) == len(want[ck]), ck
        for eg, ew in zip(got[ck], want[ck]):
            for a, b in zip(eg, ew):
                np.testing.assert_array_equal(a, b)


def _assert_same_fit(rj, rt, he_exact: bool = True) -> None:
    for field in ("centroids", "assignment"):
        got = shares_to_numpy(getattr(rt, field))
        for i in (0, 1):
            np.testing.assert_array_equal(
                got[i], np.asarray(getattr(rj, field)[i], np.uint64))
    assert rt.iters_run == rj.iters_run
    for attr in ("n_matmul", "n_mul", "n_bin"):
        assert getattr(rt.dealer, attr) == getattr(rj.dealer, attr), attr
    for phase in ("online", "offline"):
        assert rt.log.by_tag(phase) == rj.log.by_tag(phase), phase
    if he_exact:
        assert rt.he_seconds == rj.he_seconds
    else:
        # the full-batch program path adds each exchange's modelled HE time
        # to the fit in the on-demand order; the JAX package sums an
        # iteration first, which can round the last bit differently
        # (test_torch_pooled.py: test_pooled_he_seconds_add_in_the_on_
        # demand_order)
        assert abs(rt.he_seconds - rj.he_seconds) <= 1e-12 * rj.he_seconds


# ---------------------------------------------------------------------------
# provisioning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2, 4])
def test_provisioning_equals_reference_for_any_worker_count(workers):
    """A sparse fit plan (every class kind, the Protocol-2 seeds included)
    provisioned twice over: the port's queues hold the JAX bank's words
    and the class streams end where the JAX bank's end."""
    xa, xb = _fit_data("vertical", seed=5, sparse=True)
    jk, tk = _pair(k=3, iters=2, seed=7, sparse=True, offline="pooled")
    kj, plan_j, _ = jk.plan_fit(xa.shape, xb.shape)
    kt, plan_t, _ = tk.plan_fit(xa.shape, xb.shape)
    assert kt == kj
    assert [tuple(r) for r in plan_t.requests] \
        == [tuple(r) for r in plan_j.requests]
    ref = JT.TripleBank(seed=11)
    ref.provision(kj, plan_j, copies=2)
    bank = T.TripleBank(seed=11, device="cpu")
    bank.provision(kt, plan_t, copies=2, workers=workers)
    _assert_same_queues(_port_words(bank), _ref_words(ref))
    assert {k: repr(r.bit_generator.state) for k, r in bank._rngs.items()} \
        == {k: repr(r.bit_generator.state) for k, r in ref._rngs.items()}
    assert bank.pool_bytes == ref.pool_bytes
    assert bank.stock() == ref.stock()
    assert bank.stock_copies(kt) == ref.stock_copies(kj) == 2
    assert bank.modelled_ot_seconds == ref.modelled_ot_seconds
    assert bank.log.by_tag("offline") == ref.log.by_tag("offline")


def test_provision_items_equal_reference():
    counts = {("matmul", (7, 3), (3, 2)): 5, ("mul", (5, 4)): 9,
              ("bin", (2, 6)): 3, ("rand", (8,)): 4, ("seed", ()): 6}
    for workers in (1, 2, 3, 8):
        assert T._provision_items(counts, workers) \
            == JT._provision_items(counts, workers)


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="no plan registered"):
        T.TripleBank(seed=0, device="cpu").dealer(("predict", "nope"))


# ---------------------------------------------------------------------------
# save / load across the two packages
# ---------------------------------------------------------------------------

def _scoring_pair(partition="vertical", sparse=False):
    """A JAX model and the port model over its shares, plus a batch."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (40, 4)) * ((rng.random((40, 4)) > 0.5)
                                     if sparse else 1.0)
    a, b = (x[:, :2], x[:, 2:]) if partition == "vertical" \
        else (x[:20], x[20:])
    jk, tk = _pair(k=3, iters=2, seed=5, partition=partition, sparse=sparse)
    rj = jk.fit(a, b)
    tk.result_ = result_from_reference({
        f: tuple(np.asarray(getattr(rj, f)[i], np.uint64) for i in (0, 1))
        for f in ("centroids", "assignment")})
    q = rng.normal(0, 1, (8, 4))
    qa, qb = (q[:, :2], q[:, 2:]) if partition == "vertical" \
        else (q[:4], q[4:])
    return jk, tk, qa, qb


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_bank_files_cross_packages(tmp_path, sparse):
    """A JAX save loads in the port and a port save loads in the JAX
    package; each serves the words the saving bank would have served, the
    replenishment past the provisioned stock included (the stream
    positions cross too)."""
    jk, tk, qa, qb = _scoring_pair(sparse=sparse)
    kj, plan_j, _ = jk.plan_predict(qa.shape, qb.shape, True)
    kt, plan_t, _ = tk.plan_predict(qa.shape, qb.shape, True)
    assert kt == kj
    ref = JT.TripleBank(seed=13)
    ref.provision(kj, plan_j, copies=2)
    bank = T.TripleBank(seed=13, device="cpu")
    bank.provision(kt, plan_t, copies=2)
    p_ref, p_port = (os.path.join(tmp_path, n) for n in ("jax", "port"))
    ref.save(p_ref)
    bank.save(p_port)
    with np.load(p_ref) as zj, np.load(p_port) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for name in zj.files:
            np.testing.assert_array_equal(zj[name], zt[name])
    in_port = T.TripleBank.load(p_ref, device="cpu")
    in_jax = JT.TripleBank.load(p_port)
    assert in_port.stock() == ref.stock()
    assert in_port.pool_bytes == ref.pool_bytes
    for _ in range(3):                  # 2 provisioned, then a replenish
        want = jk.score(qa, qb, dealer=ref.dealer(kj))
        got = tk.score(qa, qb, dealer=in_port.dealer(kt))
        back = jk.score(qa, qb, dealer=in_jax.dealer(kj))
        for field in ("assignment", "scores"):
            g = shares_to_numpy(getattr(got, field))
            for i in (0, 1):
                w = np.asarray(getattr(want, field)[i], np.uint64)
                np.testing.assert_array_equal(g[i], w)
                np.testing.assert_array_equal(
                    np.asarray(getattr(back, field)[i], np.uint64), w)
    assert in_port.replenish_events == ref.replenish_events == 1
    assert in_port.served_requests == ref.served_requests
    assert in_port.consumed_counts() == ref.consumed_counts()


def _tiny_saved_bank(td):
    km = SecureKMeans(KMeansConfig(k=2, iters=1, seed=3, backend="torch",
                                   device="cpu"))
    key, plan, _ = km.plan_fit((12, 2), (12, 2))
    bank = T.TripleBank(seed=3, device="cpu")
    bank.provision(key, plan)
    path = os.path.join(td, "bank.npz")
    bank.save(path)
    return path


def _flip(path):
    raw = bytearray(open(path, "rb").read())
    # one bit inside the zip's data region: an array CRC32 or the zip's
    # own CRC must catch it
    raw[len(raw) // 2] ^= 0x10
    open(path, "wb").write(bytes(raw))


def _truncate(path):
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) // 2])


def _foreign(path):
    with open(path, "wb") as f:
        np.savez(f, x=np.arange(8))


def _wrong_version(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("manifest")).decode())
    manifest["version"] = 99
    with open(path, "wb") as f:
        np.savez(f, manifest=np.frombuffer(
            json.dumps(manifest).encode(), np.uint8), **arrays)


def _garbage(path):
    open(path, "wb").write(b"this is not an npz archive at all")


@pytest.mark.parametrize("damage,match", [
    (_flip, "TripleBank"), (_truncate, "TripleBank"),
    (_foreign, "manifest"), (_wrong_version, "version"),
    (_garbage, "TripleBank")],
    ids=["bit-flip", "truncation", "foreign", "version", "garbage"])
def test_load_rejects_corrupt_files(tmp_path, damage, match):
    """Both packages refuse the same damaged file with a ValueError."""
    path = _tiny_saved_bank(str(tmp_path))
    damage(path)
    with pytest.raises(ValueError, match=match):
        T.TripleBank.load(path, device="cpu")
    with pytest.raises(ValueError, match=match):
        JT.TripleBank.load(path)


def test_save_path_used_verbatim(tmp_path):
    path = _tiny_saved_bank(str(tmp_path))
    bare = os.path.join(str(tmp_path), "bank_no_suffix")
    T.TripleBank.load(path, device="cpu").save(bare)
    assert os.path.exists(bare)
    assert T.TripleBank.load(bare, device="cpu").stock() \
        == T.TripleBank.load(path, device="cpu").stock()


# ---------------------------------------------------------------------------
# stock-outs and the top-up daemon
# ---------------------------------------------------------------------------

def test_auto_replenish_and_strict_mode():
    _, tk, qa, qb = _scoring_pair()
    key, plan, _ = tk.plan_predict(qa.shape, qb.shape, True)
    bank = T.TripleBank(seed=2, device="cpu")
    bank.provision(key, plan, copies=1)
    tk.score(qa, qb, dealer=bank.dealer(key))
    assert bank.replenish_events == 0
    tk.score(qa, qb, dealer=bank.dealer(key))     # stock-out -> replenish
    assert bank.replenish_events == 1
    strict = T.TripleBank(seed=2, auto_replenish=False, device="cpu")
    strict.provision(key, plan, copies=1)
    tk.score(qa, qb, dealer=strict.dealer(key))
    with pytest.raises(T.PoolExhaustedError, match="stock-out"):
        tk.score(qa, qb, dealer=strict.dealer(key))


def test_discard_realigns_and_skip_drains():
    """discard(consumed_counts) on a bank saved before serving lands every
    class stream where the served bank stands; BankDealer.skip drains
    executions without serving them."""
    _, tk, qa, qb = _scoring_pair()
    key, plan, _ = tk.plan_predict(qa.shape, qb.shape, False)
    bank = T.TripleBank(seed=4, device="cpu")
    bank.provision(key, plan, copies=3)
    twin = T.TripleBank(seed=4, device="cpu")
    twin.provision(key, plan, copies=3)
    tk.predict(qa, qb, dealer=bank.dealer(key))
    twin.discard(bank.consumed_counts())
    a = tk.predict(qa, qb, dealer=bank.dealer(key))
    b = tk.predict(qa, qb, dealer=twin.dealer(key))
    assert torch.equal(a.assignment.s0, b.assignment.s0)
    bank.dealer(key).skip(plan)
    twin.discard({ck: c for ck, c in plan.class_counts().items()})
    assert bank.stock() == twin.stock() \
        and all(v == 0 for v in bank.stock().values())


def test_replenisher_keeps_served_words_exact():
    """A daemon topping the bank up while the main thread scores serves the
    words of a bank that only ever replenishes synchronously."""
    _, tk, qa, qb = _scoring_pair()
    key, plan, _ = tk.plan_predict(qa.shape, qb.shape, True)
    sync = T.TripleBank(seed=6, device="cpu")
    sync.provision(key, plan, copies=1)
    live = T.TripleBank(seed=6, device="cpu")
    live.provision(key, plan, copies=1)
    with T.BankReplenisher(live, low_water=1, high_water=3,
                           poll_s=0.0005) as daemon:
        for _ in range(6):
            a = tk.score(qa, qb, dealer=sync.dealer(key))
            b = tk.score(qa, qb, dealer=live.dealer(key))
            for i in (0, 1):
                assert torch.equal(a.scores[i], b.scores[i])
                assert torch.equal(a.assignment[i], b.assignment[i])
        assert daemon.running
    assert not daemon.running and daemon.topups >= 1 and daemon.errors == 0
    assert sync.replenish_events == 5


def test_replenisher_validates_and_survives_errors():
    bank = T.TripleBank(seed=0, device="cpu")
    with pytest.raises(ValueError, match="high_water"):
        T.BankReplenisher(bank, low_water=2, high_water=2)
    d = T.BankReplenisher(bank, keys=[("missing",)])
    assert d.poll_once() == 0
    bank._plans[("bad",)] = T.TriplePlan([T.PlanRequest("nope", (1,), "x")])
    d = T.BankReplenisher(bank, poll_s=0.0005)
    d.start()
    done = threading.Event()
    while d.errors == 0 and not done.wait(0.005):
        pass
    d.stop()
    assert d.errors >= 1 and isinstance(d.last_error, KeyError)


# ---------------------------------------------------------------------------
# bank-fed fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition,sparse", COMBOS)
def test_bank_fit_full_batch_equals_reference(partition, sparse):
    """plan_fit -> provision (2 workers) -> fit(dealer=bank.dealer(key)):
    shares, counters, per-tag traffic and he_seconds equal the JAX
    package's bank-fed fit, the shares its pooled fit's, and the whole plan
    is served. The modelled he_seconds is the port's pooled fit's bit for
    bit."""
    xa, xb = _fit_data(partition, seed=1, sparse=sparse)
    common = dict(k=3, iters=2, seed=3, partition=partition, sparse=sparse,
                  offline="pooled")
    jk, tk = _pair(**common)
    kj, plan_j, _ = jk.plan_fit(xa.shape, xb.shape)
    kt, plan_t, comm_t = tk.plan_fit(xa.shape, xb.shape)
    assert kt == kj and len(plan_t) == len(plan_j)
    assert comm_t.by_tag("online") == jk.plan_fit(xa.shape, xb.shape)[2] \
        .by_tag("online")
    ref = JT.TripleBank(seed=3)
    ref.provision(kj, plan_j, workers=2)
    bank = T.TripleBank(seed=3, device="cpu")
    bank.provision(kt, plan_t, workers=2)
    rj = jk.fit(xa, xb, dealer=ref.dealer(kj))
    rt = tk.fit(xa, xb, dealer=bank.dealer(kt))
    _assert_same_fit(rj, rt, he_exact=False)
    pooled = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                       **common)).fit(xa, xb)
    assert rt.he_seconds == pooled.he_seconds
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(rt, field)[i],
                               getattr(pooled, field)[i])
    assert bank.served_requests == len(plan_t)
    assert bank.replenish_events == 0


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_bank_fit_minibatch_equals_reference(tmp_path, sparse):
    """A minibatch fit fed by a BankSlotDealer equals the JAX package's
    word for word; a bank saved before serving and reloaded serves the
    same fit, and copy 2 agrees between the live and the reloaded bank."""
    xa, xb = _fit_data("vertical", seed=2, sparse=sparse)
    common = dict(k=3, iters=2, seed=3, sparse=sparse, batch_size=20,
                  offline="pooled", pipeline=True)
    jk, tk = _pair(**common)
    kj, plan_j, _ = jk.plan_fit(xa.shape, xb.shape)
    kt, plan_t, _ = tk.plan_fit(xa.shape, xb.shape)
    assert kt == kj
    assert [tuple(r) for r in plan_t.requests] \
        == [tuple(r) for r in plan_j.requests]
    ref = JT.TripleBank(seed=3)
    ref.provision(kj, plan_j, copies=2, workers=3)
    bank = T.TripleBank(seed=3, device="cpu")
    bank.provision(kt, plan_t, copies=2, workers=3)
    path = os.path.join(str(tmp_path), "bank.npz")
    bank.save(path)
    rj = jk.fit(xa, xb, dealer=ref.dealer(kj))
    rt = tk.fit(xa, xb, dealer=bank.dealer(kt))
    _assert_same_fit(rj, rt)
    assert rt.dealer.pool_bytes == rj.dealer.pool_bytes
    assert rt.dealer.remaining() == rj.dealer.remaining()
    slot = SecureKMeans(KMeansConfig(backend="torch", device="cpu",
                                     **common)).fit(xa, xb)
    reloaded = T.TripleBank.load(path, device="cpu")
    re = tk.fit(xa, xb, dealer=reloaded.dealer(kt))
    for field in ("centroids", "assignment"):
        for i in (0, 1):
            assert torch.equal(getattr(rt, field)[i],
                               getattr(slot, field)[i])
            assert torch.equal(getattr(re, field)[i], getattr(rt, field)[i])
    live2 = tk.fit(xa, xb, dealer=bank.dealer(kt))
    re2 = tk.fit(xa, xb, dealer=reloaded.dealer(kt))
    for i in (0, 1):
        assert torch.equal(live2.centroids[i], re2.centroids[i])


def test_minibatch_fit_rejects_a_non_bank_dealer():
    """Both packages refuse a dealer that is not a bank view, with the same
    message."""
    xa, xb = _fit_data("vertical", seed=4)
    msgs = []
    for km, planning in zip(
            _pair(k=3, iters=1, seed=0, batch_size=20, offline="pooled"),
            (JT.PlanningDealer(), T.PlanningDealer())):
        with pytest.raises(ValueError, match="TripleBank dealer") as exc:
            km.fit(xa, xb, dealer=planning)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_fit_dealer_on_another_device_type_raises():
    xa, xb = _fit_data("vertical", seed=4)
    km = SecureKMeans(KMeansConfig(k=3, iters=1, backend="torch",
                                   device="cpu"))
    alien = T.PlanningDealer()
    alien.device = torch.device("meta")
    with pytest.raises(ValueError, match="serves words on"):
        km.fit(xa, xb, dealer=alien)


def test_concurrent_pops_and_topups_serve_each_word_once():
    """Eight consumer threads popping while the daemon and the hot path
    both generate, with a short thread switch interval: every served entry
    is served once, and together they are the prefix of the class stream a
    single-threaded bank serves (a forked stream or a lost update would
    serve words twice or skip some)."""
    import sys
    plan = T.TriplePlan([T.PlanRequest("mul", (3, 2), "t"),
                         T.PlanRequest("rand", (4,), "t")])
    bank = T.TripleBank(seed=21, device="cpu")
    bank.provision(("k",), plan, copies=2)
    per_thread, threads = 40, 8
    served: list = []
    lock = threading.Lock()

    def consume():
        dealer = bank.dealer(("k",))
        mine = [(tuple(dealer.mul_triple((3, 2)).u.s0.flatten().tolist()),
                 tuple(dealer.rand((4,)).tolist()))
                for _ in range(per_thread)]
        with lock:
            served.extend(mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with T.BankReplenisher(bank, low_water=3, high_water=6,
                               poll_s=0.0):
            pool = [threading.Thread(target=consume)
                    for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    total = per_thread * threads
    ref = T.TripleBank(seed=21, device="cpu", auto_replenish=True)
    ref.provision(("k",), plan, copies=total)
    d = ref.dealer(("k",))
    want = [(tuple(d.mul_triple((3, 2)).u.s0.flatten().tolist()),
             tuple(d.rand((4,)).tolist())) for _ in range(total)]
    muls = sorted(m for m, _ in served)
    rands = sorted(r for _, r in served)
    assert muls == sorted(m for m, _ in want)
    assert rands == sorted(r for _, r in want)
    assert bank.served_requests == 2 * total
    assert bank.consumed_counts() == {k: total for k in plan.class_counts()}
    left = sum(T._entry_bytes(e) for q in bank._queues.values()
               for e, _ in q)
    assert bank.pool_bytes == left
