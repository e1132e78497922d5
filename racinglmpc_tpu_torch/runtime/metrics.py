"""Metrics, profiling and latency reporting (port of
``racinglmpc_tpu/runtime/metrics.py``).

- :class:`StepMetrics`: per-step, per-scenario solver and lap data kept as
  tensors on the device (no host sync in the loop); :func:`summarize`
  fetches them once.
- :func:`latency_report`: step-latency percentiles against the 100 ms
  (10 Hz) control budget.
- :func:`time_steps`: wall seconds per call, synchronizing the card.
- :func:`profile`: ``torch.profiler`` around a block, with the trace
  written as Chrome JSON into ``logdir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch


class StepMetrics(NamedTuple):
    """Per-scenario step diagnostics (leading axes: [batch] or [T, batch])."""

    feasible: torch.Tensor     # bool: accepted QP solution
    pri_res: torch.Tensor      # primal residual of the last solve
    dua_res: torch.Tensor      # dual residual
    iters: torch.Tensor        # ADMM iterations
    lap_progress: torch.Tensor  # arc length s


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def summarize(m: StepMetrics) -> dict:
    """Host-side summary of a metrics tuple."""
    h = StepMetrics(*(_np(t) for t in m))
    return {
        "feasible_rate": float(np.mean(np.asarray(h.feasible,
                                                  dtype=np.float64))),
        "pri_res_p50": float(np.percentile(h.pri_res, 50)),
        "pri_res_p99": float(np.percentile(h.pri_res, 99)),
        "dua_res_p50": float(np.percentile(h.dua_res, 50)),
        "iters_mean": float(np.mean(h.iters)),
        "s_mean": float(np.mean(h.lap_progress)),
    }


def latency_report(step_seconds, budget_s: float = 0.1) -> dict:
    """Percentile latency against the 10 Hz control budget."""
    s = np.asarray(step_seconds, dtype=np.float64)
    return {
        "p50_ms": float(np.percentile(s, 50) * 1e3),
        "p99_ms": float(np.percentile(s, 99) * 1e3),
        "max_ms": float(s.max() * 1e3),
        "budget_ms": budget_s * 1e3,
        "within_budget_p99": bool(np.percentile(s, 99) <= budget_s),
    }


def time_steps(fn, n: int, *args, **kwargs) -> np.ndarray:
    """Call ``fn(*args, **kwargs)`` ``n`` times; seconds per call, each
    ended by a device synchronize when a card is present."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        out.append(time.perf_counter() - t0)
    return np.asarray(out)


@contextlib.contextmanager
def profile(logdir: Optional[str]) -> Iterator[Optional[object]]:
    """``with profile(dir) as prof:`` traces the block with
    ``torch.profiler`` (CPU, and CUDA when a card is present), writes
    ``dir/trace.json`` and yields the profiler (``prof.key_averages()``);
    a no-op yielding None when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
