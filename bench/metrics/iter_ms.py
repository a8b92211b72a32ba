"""iter_ms: the window's wall over the iterations it completed (host
clock; the window ends with a synchronize)."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["iters"]
