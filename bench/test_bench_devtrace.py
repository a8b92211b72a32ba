"""The reduction of a device trace, on a Chrome trace written by hand."""
import pytest

from bench import devtrace


def ev(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": pid, "args": args}


def trace():
    # host thread 1: the window [100, 200], a ring_matmul range [110, 130]
    # with two launches, and an aten op covering [150, 190]; device
    # (pid 0): kernels at [112, 140] (from inside the range), [135, 145]
    # (overlapping it), [160, 170] and a memset at [180, 185]; one kernel
    # before the window.
    return [
        ev("user_annotation", devtrace.WINDOW, 100, 100),
        ev("user_annotation", "bench.ring_matmul", 110, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 111, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=2),
        ev("cpu_op", "aten::add", 150, 40),
        ev("cuda_runtime", "cudaLaunchKernel", 151, 1, correlation=3),
        ev("cuda_runtime", "cudaMemsetAsync", 160, 1, correlation=4),
        ev("kernel", "longw_kernel", 112, 28, tid=7, pid=0, correlation=1),
        ev("kernel", "tallw_kernel", 135, 10, tid=7, pid=0, correlation=2),
        ev("kernel", "add_kernel", 160, 10, tid=7, pid=0, correlation=3),
        ev("gpu_memset", "Memset", 180, 5, tid=7, pid=0, correlation=4),
        ev("kernel", "early", 10, 5, tid=7, pid=0, correlation=9),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 111},
    ]


def test_reduce_busy_ranges_and_gaps():
    t = devtrace.reduce(trace(), ("bench.ring_matmul",
                                  "bench.ks_carry_share"))
    assert t["window_s"] == pytest.approx(100e-6)
    # union: [112, 145] + [160, 170] + [180, 185] = 33 + 10 + 5
    assert t["busy_s"] == pytest.approx(48e-6)
    assert t["device_ops"] == 4
    assert t["device_s"] == pytest.approx(53e-6)
    # both launches of the range count, the overlap included
    assert t["range_s"]["bench.ring_matmul"] == pytest.approx(38e-6)
    assert t["range_s"]["bench.ks_carry_share"] == 0.0
    assert t["top_ops"][0] == ["longw_kernel", pytest.approx(28e-6)]
    gaps = dict(t["idle_gaps"])
    # [100, 112] and [185, 200]: the window alone (the range opens at 110,
    # after the first gap's middle); [145, 160] and [170, 180]: the aten op
    assert gaps == {devtrace.WINDOW: pytest.approx(27e-6),
                    "aten::add": pytest.approx(25e-6)}


def test_reduce_by_device_range_without_launch_records():
    evs = [e for e in trace() if e["cat"] != "cuda_runtime"]
    evs.append(ev("gpu_user_annotation", "bench.ring_matmul", 112, 34,
                  tid=7, pid=0))
    t = devtrace.reduce(evs, ("bench.ring_matmul",))
    assert t["range_s"]["bench.ring_matmul"] == pytest.approx(38e-6)


def test_reduce_finds_nothing_to_read():
    assert devtrace.reduce([ev("kernel", "k", 0, 1)]) is None
    assert devtrace.reduce([ev("user_annotation", devtrace.WINDOW, 0,
                               10)]) is None
