"""s3_finalize_ms: the device-stream interval of each traced iteration's
s3.finalize span (S3's (k,)-sized tail: the empty-cluster guard, the
Newton reciprocal, the update), per iteration."""
from bench import progspans


def read(rec):
    return progspans.dev_ms(rec, ("s3.finalize",))
