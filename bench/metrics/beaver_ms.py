"""beaver_ms: the device-stream intervals of each traced iteration's
beaver.open and beaver.combine spans (every Beaver opening and
recombination of S1 and S3), summed, per iteration."""
from bench import progspans


def read(rec):
    return progspans.dev_ms(rec, ("beaver.open", "beaver.combine"))
