"""Reduce a torch.profiler session to what the per-layer metrics read.

Read in the process, once the profiled episodes have ended; nothing is
written to disk. From the device side: every kernel, copy and set's
interval (their union is the busy time, so kernels that overlap count
once), kernel time by name and by the port's kernel (B1, B2, B3, the rest).
From the host side: the CUDA runtime calls that launch a kernel and those
that wait for the device. Each idle stretch of the device is put down to
what the host was doing at its midpoint: the runtime call in flight, or,
with none, host work outside CUDA (Python and ATen dispatch).
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

DEVICE_ACTS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_ACTS = {"cuda_runtime", "cuda_driver"}
LAUNCH = re.compile(r"^cu(da)?LaunchKernel(Ex)?(C)?$")
SYNC = re.compile(r"^(cu(da)?(Device|Stream|Event|Ctx)Synchronize|cudaMemcpy)$")
# the port's kernels by name: B1 (main loop and rescue), B2, B3
KERNELS = {"admm": ("admm_main", "admm_rescue"), "sysid": ("sysid_kernel",),
           "rollout": ("rollout_kernel",)}


def kernel_class(name: str) -> str:
    for cls, keys in KERNELS.items():
        if any(k in name for k in keys):
            return cls
    return "other"


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    s = re.sub(r"^void ", "", name)
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s[:120]


def union_seconds(iv: np.ndarray) -> Tuple[float, np.ndarray]:
    """Seconds covered by the union of intervals (k, 2) in ns, and the
    merged intervals."""
    if len(iv) == 0:
        return 0.0, iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    m = np.asarray(merged, dtype=np.int64)
    return float((m[:, 1] - m[:, 0]).sum()) * 1e-9, m


def idle_gaps(merged: np.ndarray, host: List[Tuple[int, int, str]],
              t0: int, t1: int) -> Dict[str, float]:
    """Seconds of device idle time inside [t0, t1] by the host's activity
    at each gap's midpoint."""
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    edges = [t0] + [v for se in merged for v in se] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "host work outside CUDA calls"
        if i >= 0 and host[i][1] >= mid:
            label = f"in {host[i][2]}"
        out[label] += (b - a) * 1e-9
    return dict(out)


RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def kind(e) -> str:
    """An event's activity ("kernel", "gpu_memcpy", "gpu_memset",
    "cuda_runtime", ...), from its own field where PyTorch has one, else
    from its device and name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return act()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if RUNTIME.match(name) else "cpu_op"


def reduce(prof, window_s: float, harness_syncs: int = 0) -> dict:
    """The profiled window's record: launches, syncs (less the harness's
    own), device seconds by kernel class and by name (every kernel, for a
    roofline reader whose kernel has no class here), busy seconds, the
    idle gaps and the top device operations."""
    dev, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    launches = syncs = 0
    for e in prof.profiler.kineto_results.events():
        act = kind(e)
        if act in DEVICE_ACTS:
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            name = e.name()
            if act == "kernel":
                by_name[short(name)] += d * 1e-9
                by_class[kernel_class(name)] += d * 1e-9
            else:
                by_name[act] += d * 1e-9
        elif act in HOST_ACTS:
            name = e.name()
            s = e.start_ns()
            host.append((s, s + e.duration_ns(), name))
            if LAUNCH.match(name):
                launches += 1
            elif SYNC.match(name):
                syncs += 1
    busy, merged = union_seconds(np.asarray(dev, dtype=np.int64)
                                 .reshape(-1, 2))
    host.sort()
    firsts = (([int(merged[0, 0])] if len(merged) else [])
              + ([host[0][0]] if host else []))
    t0 = min(firsts) if firsts else 0
    t1 = t0 + int(window_s * 1e9)
    gaps = idle_gaps(merged, host, t0, t1) if len(merged) else {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"launches": launches, "syncs": syncs - harness_syncs,
            "busy_s": busy, "window_s": window_s,
            "kernel_s": {k: by_class.get(k, 0.0)
                         for k in list(KERNELS) + ["other"]},
            "device_s_by_name": dict(by_name),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
