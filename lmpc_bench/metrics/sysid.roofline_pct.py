"""B2's share of its roofline over the profiled episodes (as B1's)."""
from lmpc_bench import roofline
from lmpc_bench.roofline import sysid


def read(rec):
    t = rec.get("trace")
    if not t or not rec["work"]["sysid"]["launches"]:
        return None
    out = roofline.share(*sysid.work(rec["work"]["sysid"]),
                         t["kernel_s"]["sysid"], rec["card"])
    return None if out is None else out[0]
