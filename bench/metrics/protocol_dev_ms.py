"""protocol_dev_ms: device ms an iteration of the operations launched
outside the ring_matmul and ks_carry_share ranges (the protocol's own
elementwise work, copies and memsets)."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    return 1e3 * (t["device_s"] - sum(t["range_s"].values())) \
        / rec["trace_iters"]
