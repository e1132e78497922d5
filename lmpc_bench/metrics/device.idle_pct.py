"""Share of the profiled window in which no kernel, copy or set ran on the
device (the union of their intervals)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
