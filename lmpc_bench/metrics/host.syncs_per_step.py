"""Host waits on the device (synchronising CUDA runtime calls: device,
stream and event synchronisation, blocking copies) per batched control
step over the profiled episodes, less the benchmark's own."""


def read(rec):
    t = rec.get("trace")
    return t["syncs"] / rec["profiled_steps"] if t and rec[
        "profiled_steps"] else None
