"""tournament_ms: the device-stream interval of each traced iteration's
s2.tournament span (S1's tournament argmin), per iteration."""
from bench import progspans


def read(rec):
    return progspans.dev_ms(rec, ("s2.tournament",))
