"""B3's share of its roofline over the profiled episodes (as B1's)."""
from lmpc_bench import roofline
from lmpc_bench.roofline import rollout


def read(rec):
    t = rec.get("trace")
    if not t or not rec["work"]["rollout"]["launches"]:
        return None
    out = roofline.share(*rollout.work(rec["work"]["rollout"]),
                         t["kernel_s"]["rollout"], rec["card"])
    return None if out is None else out[0]
