"""Share of B4's lane-solves whose carried inverse passed the warm gate
(so Newton-Schulz started from it, not from Jacobi) over the window's
episodes."""


def read(rec):
    w = rec["work"].get("fused")
    if not w or not w["window"]["lanes"]:
        return None
    return 100.0 * w["window"]["warm_lanes"] / w["window"]["lanes"]
