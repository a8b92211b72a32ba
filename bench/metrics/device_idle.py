"""device_idle: the share of the traced slice's wall in which no
operation ran on the device (one minus the union of their intervals)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
