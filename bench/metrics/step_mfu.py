"""step_mfu: the least time one iteration could take on one H100 (the
larger of its ring products over the ring rate and its words read and
written once over HBM; bench/work.py, from the cell's shapes) over the
window's measured iteration time."""
from bench import work


def read(rec):
    c = rec["config"]
    bound = work.step_bound_s(c["n"], c["d_a"], c["d"] - c["d_a"], c["k"])
    return 100.0 * bound["bound_s"] / (rec["window_s"] / rec["iters"])
