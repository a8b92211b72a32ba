"""launches_per_iter: device operations (kernels, memsets, copies) the
profiler recorded in the traced slice, per iteration."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    return t["device_ops"] / rec["trace_iters"]
