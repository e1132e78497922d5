"""The port's spans laid over the device trace of a cell's profiled
episodes.

    python3 -m lmpc_bench.spans --workload <cell> --seed <n> [--pairs <k>]

A tool beside ``run.py``, on a machine with the cell's card. It sets the
cell up as ``run.py`` does (``run.prepare``), then runs the episodes a
``--trace 1`` run profiles (the first ``profiled_episodes`` of the seed's
window: the same noise streams, kept steps and lanes) twice inside
``torch.profiler`` with the device's activity only, as the traced run
takes it: first with the port's tracer disarmed, then inside
``tracing.session()``, then once more each way in the other order
(ABBA). It prints the last armed run's per-span table on standard error
(``tracing.table``: per batched step, each span's calls, host self time,
the device time of the kernels it launched, the device idle time while it
was the innermost span, its launches and syncs) and one JSON line on
standard output:

- ``disarmed``, ``armed``: ``trace.reduce``'s launches and syncs per step
  and idle share of each run, in run order (the tracer launches and syncs
  nothing, so the counts agree; the idle shares differ by the spans' host
  cost and by the host's drift);
- ``metrics``: the per-layer numbers that read the session, as their
  readers would in a traced run whose harness arms it;
- ``checks``: that the spans share the device trace's clock (every B1, B2
  and B3 launch inside its ``qp.admm``, ``ctrl.sysid`` or ``lap.plant``
  span; the share of idle time under a named span; the three idle numbers
  against the idle time under spans) and the rescued lanes counted;
- ``counts`` (the tracer's counters), ``overlay`` (the whole table).

``--pairs k`` first runs k pairs of episodes without the profiler, one
disarmed and one armed each, in turns (ABBA), and adds ``cost``: host ms
per batched step of each side.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from lmpc_bench import cell as cell_mod
from lmpc_bench import roofline, run
from lmpc_bench import trace as trace_mod
from lmpc_bench.roofline import admm as admm_roof
from lmpc_bench.roofline import prologue as prologue_roof
from lmpc_bench.roofline import rescue as rescue_roof
from racinglmpc_tpu_torch.runtime import tracing

PROLOGUE = ("qp.prologue", "qp.ruiz", "qp.build_k", "qp.ns")
CTRL = ("qp.solve", "qp.admm", "qp.finish")
# each launch of the port's kernels, by name, and the span it belongs in
KERNEL_SPANS = {"admm_main": "qp.admm", "admm_rescue": "qp.admm",
                "sysid_kernel": "ctrl.sysid", "rollout_kernel": "lap.plant"}


def idle_group(name: str) -> str:
    """The idle metric a span's idle time belongs to."""
    if name.startswith("lap."):
        return "lap.idle_ms_per_step"
    if name in PROLOGUE:
        return "prologue.idle_ms_per_step"
    if name.startswith("ctrl.") or name in CTRL:
        return "ctrl.idle_ms_per_step"
    return ""


class Episodes:
    """The window's first episodes as ``cell.window`` draws them."""

    def __init__(self, S, seed: int, max_episodes: int = 256):
        self.S = S
        self.stage = cell_mod.stage(S.cell)
        self.clock = cell_mod.Clock(S.step, True, self.stage.keep_fields)
        self.steps, lanes = cell_mod.plan(seed, max_episodes, S.cell,
                                          S.batch)
        self.lanes = torch.as_tensor(np.stack(lanes), device=S.device)
        self.order = cell_mod.streams(seed, max_episodes, S.cell.traffic)

    def run(self, e: int):
        return self.stage.run_episode(self.S, self.clock, self.order[e],
                                      self.steps[e], self.lanes[e])


def profiled(eps: Episodes, n: int, armed: bool):
    """The first ``n`` episodes inside the traced run's profiler, inside a
    tracing session when ``armed``: (episodes, record or None, profiler,
    window (ns), seconds)."""
    cell_mod.sync(eps.S.device)
    ctx = tracing.session() if armed else contextlib.nullcontext()
    with ctx as rec:
        prof = cell_mod._profiler()
        with prof:
            t0, tp = time.time_ns(), time.perf_counter()
            out = [eps.run(e) for e in range(n)]
            cell_mod.sync(eps.S.device)
            secs, t1 = time.perf_counter() - tp, time.time_ns()
    return out, rec, prof, (t0, t1), secs


def per_step(red: dict, steps: int) -> dict:
    return {"launches_per_step": red["launches"] / steps,
            "syncs_per_step": red["syncs"] / steps,
            "idle_pct": 100.0 * (1.0 - red["busy_s"] / red["window_s"]),
            "idle_gaps": red["idle_gaps"], "device_ops": red["device_ops"]}


def metrics(S, ov: dict, counts: dict, dev, card: str) -> dict:
    """The six per-layer numbers that read a session (see the module's
    docstring of ``roofline/prologue.py`` and ``roofline/rescue.py``)."""
    N, K = S.lcfg.N, S.lcfg.num_ss_points
    n, m = admm_roof.nonzeros(N, K)[:2]
    steps = ov["steps"]
    out = dict.fromkeys(("lap.idle_ms_per_step", "ctrl.idle_ms_per_step",
                         "prologue.idle_ms_per_step"), 0.0)
    for name, r in ov["spans"].items():
        g = idle_group(name)
        if g:
            out[g] += r["idle_ms"]
    lanes = counts.get("ns.lanes", 0)
    if lanes:
        out["ns.iters_mean"] = (counts.get("ns.first.lane_iters", 0)
                                + counts.get("ns.restart.lane_iters", 0)
                                ) / lanes
    dev_s = 1e-3 * steps * sum(ov["spans"].get(k, {}).get("device_ms", 0.0)
                               for k in PROLOGUE)
    f32, f64, nbytes = prologue_roof.work(counts, n, m, N, K)
    if dev_s > 0 and nbytes > 0:
        t, _ = prologue_roof.least_seconds(f32, f64, nbytes, card)
        out["prologue.roofline_pct"] = 100.0 * t / dev_s
    rescue_s = 1e-9 * sum(d.end_ns - d.start_ns for d in dev
                          if "admm_rescue_prologue" in d.name)
    share = roofline.share(*rescue_roof.work(counts, n, m, N, K), rescue_s,
                           card)
    if share is not None and counts.get("admm.rescue.lanes", 0):
        out["admm.rescue_roofline_pct"] = share[0]
    return out


def checks(ov: dict, counts: dict, dev, host, spans) -> dict:
    """The clock checks of the module's docstring."""
    owner = tracing.owners(spans, host)
    placed = {k: [0, 0] for k in KERNEL_SPANS}
    for d in dev:
        for key, want in KERNEL_SPANS.items():
            if key in d.name:
                placed[key][owner.get(d.correlation) == want] += 1
    idle = ov["idle_ms"] / max(ov["steps"], 1)     # per step, as the rows
    under = idle - ov["spans"].get(tracing.OUTSIDE, {}).get("idle_ms", 0.0)
    groups = sum(r["idle_ms"] for k, r in ov["spans"].items()
                 if idle_group(k))
    return {"kernels_outside_their_span": {k: v[0] for k, v in
                                           placed.items()},
            "kernels_in_their_span": {k: v[1] for k, v in placed.items()},
            "idle_under_named_spans_pct": 100.0 * under / max(idle, 1e-12),
            "idle_groups_over_idle_under_spans": groups / max(under, 1e-12),
            "rescue_lanes_counted": counts.get("admm.rescue.lanes", 0)}


def cost(eps: Episodes, pairs: int) -> dict:
    """Host ms per batched step, disarmed and armed, ``pairs`` pairs in
    turns (ABBA), both sides of a pair on the same episode's draws."""
    ms = {"disarmed": [], "armed": []}
    for i in range(pairs):
        sides = ("disarmed", "armed") if i % 2 == 0 else ("armed",
                                                          "disarmed")
        for side in sides:
            ctx = (tracing.session() if side == "armed"
                   else contextlib.nullcontext())
            with ctx:
                cell_mod.sync(eps.S.device)
                t0 = time.perf_counter()
                ep = eps.run(i)
                cell_mod.sync(eps.S.device)
                ms[side].append(1e3 * (time.perf_counter() - t0) / ep.calls)
    out = {}
    for side, v in ms.items():
        q = np.quantile(v, [0.25, 0.5, 0.75]) if v else [0, 0, 0]
        out[side] = {"ms_per_step": v, "median": float(q[1]),
                     "quartiles": [float(q[0]), float(q[2])]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    bench, c, S = run.prepare(args.workload)
    card = torch.cuda.get_device_name(0)
    eps = Episodes(S, args.seed)
    out = {"workload": c.name, "seed": args.seed, "card": run.card_limit()}
    if args.pairs:
        out["cost"] = cost(eps, args.pairs)
        log("cost (host ms per step): " + json.dumps(
            {k: (v["median"], v["quartiles"]) for k, v in
             out["cost"].items()}))
    n = int(S.cell.traffic["profiled_episodes"])
    out["disarmed"], out["armed"] = [], []
    for side in ("disarmed", "armed", "armed", "disarmed"):
        got, r, p, w, secs = profiled(eps, n, side == "armed")
        steps = sum(ep.calls for ep in got)
        out[side].append(per_step(
            trace_mod.reduce(p, secs, harness_syncs=1), steps))
        x = out[side][-1]
        log(f"{side}: {steps} steps, {secs:.3f} s, launches/step "
            f"{x['launches_per_step']:.2f}, syncs/step "
            f"{x['syncs_per_step']:.3f}, idle {x['idle_pct']:.3f}%")
        if r is not None:
            rec, prof, window, armed_steps = r, p, w, steps
    dev, host = tracing.profiler_events(prof)
    ov = tracing.overlay(rec.spans, dev, host, window=window,
                         steps=armed_steps)
    counts = dict(rec.counts)
    log(tracing.table(ov))
    log("counters: " + json.dumps(counts))
    out["metrics"] = metrics(S, ov, counts, dev, card)
    out["checks"] = checks(ov, counts, dev, host, rec.spans)
    per = max(armed_steps, 1)
    out["ns_passes_per_step"] = {
        k: counts.get(f"ns.{k}.passes", 0) / per
        for k in ("first", "restart", "final")}
    out["counts"], out["overlay"] = counts, ov
    log("metrics: " + json.dumps(out["metrics"]))
    log("checks: " + json.dumps(out["checks"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
