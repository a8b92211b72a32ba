"""ks_carry_share_roofline: the frozen bound (bench/work.py) of the carry
words ks_carry_share was called with in the traced slice, over the device
time of the operations launched inside its ranges."""
from bench import work


def read(rec):
    t, numels = rec.get("trace"), rec.get("ks_numels")
    dev = t["range_s"].get("bench.ks_carry_share", 0.0) if t else 0.0
    if not numels or dev <= 0:
        return None
    return 100.0 * sum(work.ks_carry_share_bound_s(m) for m in numels) / dev
