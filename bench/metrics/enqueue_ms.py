"""enqueue_ms: the host duration of each traced iteration's prog.s1 and
prog.s3 spans (what the host takes to issue one iteration), per
iteration."""
from bench import progspans


def read(rec):
    its = progspans.iterations(rec)
    if its is None:
        return None
    return sum(e["dur"] for spans in its for e in spans
               if e["name"] in progspans.PROGRAMS) / 1e3 / len(its)
