"""ring_matmul_roofline: the frozen bound (bench/work.py) of the products
ring_matmul was called with in the traced slice, over the device time of
the operations launched inside its ranges."""
from bench import work


def read(rec):
    t, shapes = rec.get("trace"), rec.get("mm_shapes")
    dev = t["range_s"].get("bench.ring_matmul", 0.0) if t else 0.0
    if not shapes or dev <= 0:
        return None
    return 100.0 * sum(work.ring_matmul_bound_s(*s) for s in shapes) / dev
