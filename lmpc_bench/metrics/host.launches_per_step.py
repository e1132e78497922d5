"""Kernel launches (the profiler's CUDA runtime launch calls) per batched
control step over the profiled episodes; one a step is the benchmark's
plant draw."""


def read(rec):
    t = rec.get("trace")
    return t["launches"] / rec["profiled_steps"] if t and rec[
        "profiled_steps"] else None
