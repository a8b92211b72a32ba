"""s1_ms: device time between CUDA events around each FitPrograms.s1 call
of the traced slice, per iteration."""


def read(rec):
    if "s1_s" not in rec:
        return None
    return 1e3 * rec["s1_s"] / rec["trace_iters"]
