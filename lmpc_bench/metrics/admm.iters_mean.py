"""Mean ADMM iterations (the solver's own count, the rescue's included)
over the window's live solves."""


def read(rec):
    c = rec["counters"]
    return c["iters_live"] / c["live"] if c["live"] else None
