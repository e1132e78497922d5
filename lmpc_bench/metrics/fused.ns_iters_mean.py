"""B4's Newton-Schulz lane-iterations (both passes) per lane-solve over
the window's episodes: the kernel's own per-lane count, carried in the
controller's state."""


def read(rec):
    w = rec["work"].get("fused")
    if not w or not w["window"]["lanes"]:
        return None
    return w["window"]["ns_lane_iters"] / w["window"]["lanes"]
