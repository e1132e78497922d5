"""B1's share of its roofline over the profiled episodes: the least time
(operations over the float32 peak or bytes over the bandwidth, the larger)
over B1's device time."""
from lmpc_bench import roofline
from lmpc_bench.roofline import admm


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    out = roofline.share(*admm.work(rec["work"]["admm"]),
                         t["kernel_s"]["admm"], rec["card"])
    return None if out is None else out[0]
