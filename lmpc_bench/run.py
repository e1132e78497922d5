"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m lmpc_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It loads and seeds the cell (set-up), warms up its shapes, runs
episodes for ``--seconds`` (the window), judges what the window produced
against the float64 reference of the cell's controller stage
(``stages/<name>.py``), and prints one JSON line last on standard output:
``correct``, ``attempted`` (live solves in the window), ``failed`` (those
the controller rejected), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, also printed as the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; if JAX or the JAX package is loaded once
the window has closed, with code 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse          # noqa: E402
import importlib.util    # noqa: E402
import json              # noqa: E402
import os                # noqa: E402
import subprocess        # noqa: E402
import sys               # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np       # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "racinglmpc_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def metric_reader(name: str, root: str = os.path.dirname(__file__)):
    """The ``read`` function of ``<root>/metrics/<name>.py``."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"lmpc_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters(win) -> Dict[str, float]:
    """Live and executed scenario-steps, rejected live solves and the live
    solves' iterations (the stage's ``collect``) over the window's
    episodes."""
    live = executed = rejected = iters = 0
    for ep in win.episodes:
        m = ep.sr.mask
        rej, its = ep.sr.collected
        live += int(m.sum())
        executed += ep.calls * m.shape[0]
        rejected += int((rej & m).sum())
        iters += int((its.long() * m).sum())
    return {"live": live, "executed": executed, "rejected": rejected,
            "iters_live": iters}


def p95(values: np.ndarray) -> float:
    """The 95th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(values, 95))


def prepare(workload: str, *, device: str = "cuda",
            batch: Optional[int] = None, overrides: Optional[dict] = None):
    """Set-up: the cell, its controller and seeded state, warmed up on
    noise streams the window never draws. ``device``, ``batch`` and
    ``overrides`` are for the tests and the control."""
    import torch

    from lmpc_bench import cell as cell_mod
    from lmpc_bench import spec

    # host dispatch sets the step time; no intra-op pool to contend with it
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.benchmark()
    c = spec.cell(workload, bench)
    S = cell_mod.setup(c, device, overrides, batch)
    cell_mod.warm_up(S)
    return bench, c, S


def measure(bench: dict, c, S, seed: int, seconds: float, trace: bool, *,
            setup_s: Optional[float] = None, breaker=None,
            log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """The window and its check; returns the result line's object, with
    ``_numbers``, the judge's diagnostics. ``breaker`` is a test's hook
    that breaks the timed path (``cell.window``)."""
    import torch

    from lmpc_bench import cell as cell_mod
    from lmpc_bench import judge

    workload = c.name
    stage = cell_mod.stage(c)
    cuda = S.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = cell_mod.window(S, seed, seconds, trace=trace, breaker=breaker)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if forbidden_modules():
        log("JAX or the JAX package is loaded: " +
            ", ".join(forbidden_modules()))
        raise SystemExit(3)
    cnt = counters(win)
    solves_per_s = cnt["live"] / win.seconds
    step_p95_ms = p95(win.step_ms) if len(win.step_ms) else None
    log(f"window {win.seconds:.3f} s, {len(win.episodes)} episodes, "
        f"{len(win.step_ms)} batched steps, {cnt['live']} live solves, "
        f"{cnt['rejected']} rejected; step ms p50 "
        f"{np.median(win.step_ms) if len(win.step_ms) else 0:.3f}")
    edges = np.cumsum([0] + [ep.calls for ep in win.episodes])
    log("episodes (stream steps ms): " + " ".join(
        f"{k}:{ep.calls}:{win.step_ms[a:b].sum():.0f}" for k, ep, a, b in
        zip(win.streams, win.episodes, edges[:-1], edges[1:])))

    rec = None
    if trace:
        from lmpc_bench import trace as trace_mod
        t_tr = time.perf_counter()
        rec = {"counters": cnt, "work": stage.work(S, win),
               "card": torch.cuda.get_device_name(0) if cuda else "cpu",
               "profiled_steps": sum(ep.calls for ep in
                                     win.episodes[:win.profiled]),
               "trace": (trace_mod.reduce(win.prof, win.prof_seconds,
                                          harness_syncs=1)
                         if cuda else None)}
        log(f"trace: {win.profiled} episodes, {rec['profiled_steps']} "
            f"steps, {win.prof_seconds:.3f} s profiled, reduced in "
            f"{time.perf_counter() - t_tr:.3f} s")

    t_ref = time.perf_counter()
    numbers = stage.judge(S, win, seed, c.limits)
    del win
    numbers["rejected_pct"] = 100.0 * cnt["rejected"] / max(cnt["live"], 1)
    log(f"reference: {numbers.get('sampled')} steps sampled, judged in "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct, checks = judge.verdict(numbers, c.limits["limits"])

    metrics = {}
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    if trace:
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        e2e = {"solves_per_s": solves_per_s, "step_p95_ms": step_p95_ms,
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if (workload in m.get("workloads", [workload])
                    and e2e.get(m["name"]) is not None):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    out = {"correct": bool(correct), "attempted": cnt["live"],
           "failed": cnt["rejected"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and rec["trace"]:
        t = rec["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["_numbers"] = numbers
    out["checks"] = checks
    return out


def run(workload: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run as the command line makes it: set-up, then :func:`measure`."""
    bench, c, S = prepare(workload)
    setup_s = time.perf_counter() - T_START
    print(f"{workload}: set-up {setup_s:.3f} s (batch {S.batch})",
          file=sys.stderr, flush=True)
    return measure(bench, c, S, seed, seconds, trace, setup_s=setup_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from lmpc_bench import spec
    chips = spec.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    numbers = out.pop("_numbers")
    numbers.pop("gaps", None)
    print(f"card: {card_limit()}", file=sys.stderr)
    print("judge: " + json.dumps(numbers), file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        notes = "".join(f", {k} {v!r}" for k, v in c.items()
                        if k not in ("value", "limit"))
        print(f"  {name} {c['value']!r} <= {c['limit']!r}{notes}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
