"""B4's prologue launch (``admm_fused_prologue``) against its roofline
over the profiled episodes: the least time of its work
(``roofline/fused.py``, the larger of operations over the float32 peak
and bytes over the bandwidth) over its device time."""
from lmpc_bench import roofline
from lmpc_bench.roofline import fused

KERNEL = "admm_fused_prologue"


def read(rec):
    t, w = rec.get("trace"), rec["work"].get("fused")
    if not t or not w:
        return None
    out = roofline.share(*fused.work(w),
                         t["device_s_by_name"].get(KERNEL, 0.0), rec["card"])
    return None if out is None else out[0]
