"""s3_ms: device time between CUDA events around each FitPrograms.s3 call
of the traced slice, per iteration."""


def read(rec):
    if "s3_s" not in rec:
        return None
    return 1e3 * rec["s3_s"] / rec["trace_iters"]
