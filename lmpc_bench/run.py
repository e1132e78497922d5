"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m lmpc_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It loads and seeds the cell (set-up), warms up its shapes, runs
episodes for ``--seconds`` (the window), judges a sample of what the
window produced against the float64 reference (``judge.py``), and prints
one JSON line last on standard output: ``correct``, ``attempted`` (live
solves in the window), ``failed`` (those the controller rejected),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number beside its limit, also printed as the
last lines of standard error.

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


def _cpu(t):
    return t.detach().cpu().numpy()


def counters(win) -> Dict[str, float]:
    """Live and executed scenario-steps, rejected live solves and the live
    solves' ADMM iterations over the window's episodes."""
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


def work(S, win) -> dict:
    """Counts the roofline functions read, over the profiled episodes."""
    eps = win.episodes[:win.profiled]
    steps = sum(ep.calls for ep in eps)
    ce = S.solver.check_every
    its = [ep.sr.collected[1][:, :ep.calls].long() for ep in eps]
    engaged_b2 = S.ctrl.use_kernel_sysid
    from racinglmpc_tpu_torch.runtime import loop
    engaged_b3 = loop.use_kernel_rollout(S.sim, S.vp)
    store_steps = [int(v) for v in _cpu(S.state0.store.steps[0])
                   if v < 2**30]
    return {
        "admm": {"N": S.lcfg.N, "K": S.lcfg.num_ss_points,
                 "refine_steps": S.solver.kkt_refine_steps,
                 "check_every": ce, "lanes": steps * S.batch,
                 "iters": sum(int(i.sum()) for i in its),
                 "checks": sum(int((1 + (i + ce - 1) // ce).sum())
                               for i in its)},
        "sysid": {"launches": steps if engaged_b2 else 0, "batch": S.batch,
                  "N": S.lcfg.N, "knn": S.lcfg.knn_max,
                  "lap_rows": store_steps},
        "rollout": {"launches": steps if engaged_b3 else 0,
                    "batch": S.batch, "substeps": S.sim.substeps}}


def step_samples(S, win, seed: int, count: int):
    """A sample, drawn from the seed, of the window's live scenario-steps
    among those whose state the clock kept: host copies for the judge."""
    from lmpc_bench import judge
    cand = []
    for e, ep in enumerate(win.episodes):
        steps = _cpu(ep.sr.steps)
        for t in sorted(ep.kept):
            for b in np.flatnonzero(steps > t):
                cand.append((e, t, int(b)))
    rng = np.random.default_rng([seed, 0x6A756467])
    pick = sorted(rng.choice(len(cand), min(count, len(cand)),
                             replace=False)) if cand else []
    out = []
    host = {}
    for i in pick:
        e, t, b = cand[i]
        ep = win.episodes[e]
        if e not in host:
            sr = ep.sr
            host[e] = {k: _cpu(getattr(sr, k)).astype(float)
                       for k in ("x", "u", "x_glob")}
            host[e]["final"] = _cpu(sr.plant_final.x).astype(float)
            host[e]["steps"] = _cpu(sr.steps)
        h = host[e]
        before, after = (tuple(_cpu(f[b]) for f in grp)
                         for grp in ep.kept[t])
        f64 = [np.asarray(v, float) for v in before]
        a64 = [np.asarray(v, float) for v in after]
        nxt = (h["x"][b, t + 1] if t + 1 < h["steps"][b]
               else h["final"][b])
        out.append(judge.StepSample(
            xs=h["x"][b, :t], us=h["u"][b, :t], x0=h["x"][b, t],
            xg0=h["x_glob"][b, t], u=h["u"][b, t], x_next=nxt,
            draw=_cpu(ep.draws[t][b]).astype(float),
            x_lin=f64[0], u_lin=f64[1], zt=f64[2], x_pred=f64[3],
            u_old=f64[4], time_step=int(before[5]),
            rejects=int(after[8]), new_x_pred=a64[0], new_u_pred=a64[1],
            new_lam=a64[2], new_x_lin=a64[3], new_u_lin=a64[4],
            new_zt=a64[5], new_zt_u=a64[6], new_u_old=a64[7]))
    return out


def start_samples(S, lanes) -> list:
    from lmpc_bench import judge
    st = S.state0
    n = len(S.laps)
    rows = max(k for *_, k in S.laps)
    out = []
    for b in lanes:
        out.append(judge.StartSample(
            ss_x=_cpu(st.ss.x[b, :n, :rows]), ss_u=_cpu(st.ss.u[b, :n, :rows]),
            qfun=_cpu(st.ss.qfun[b, :n, :rows]), n_pts=_cpu(st.ss.n_pts[b, :n]),
            n_laps=int(st.ss.n_laps[b]), store_x=_cpu(st.store.x[b, :, :rows]),
            store_u=_cpu(st.store.u[b, :, :rows]),
            store_steps=[v for v in _cpu(st.store.steps[b]) if v < 2**30],
            x_lin=_cpu(st.x_lin[b]), u_lin=_cpu(st.u_lin[b]),
            zt=_cpu(st.zt[b]), u_old=_cpu(st.u_old[b]),
            time_step=int(st.time_step[b])))
    return out


def closure_samples(S, win, L32: float) -> list:
    from lmpc_bench import judge
    out = []
    for ep in win.episodes:
        pieces = [_cpu(p) for p in ep.closure]
        x, u, q, n_pts, lap_time, n_laps, st_steps, st_x = pieces
        steps = _cpu(ep.sr.steps)
        for j, b in enumerate(_cpu(ep.lanes)):
            k = int(steps[b])
            out.append(judge.ClosureSample(
                xs=_cpu(ep.sr.x[b, :k]), us=_cpu(ep.sr.u[b, :k]),
                prev_x=x[j, 0], prev_u=u[j, 0], prev_q=q[j, 0],
                prev_n=int(n_pts[j, 0]), new_x=x[j, 1], new_u=u[j, 1],
                new_q=q[j, 1], new_n=int(n_pts[j, 1]),
                new_time=int(lap_time[j]), n_laps=int(n_laps[j]),
                store_steps=st_steps[j], store_x=st_x[j], L32=L32))
    return out


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
    from lmpc_bench.reference import track as ref_track

    workload = c.name
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
        rec = {"counters": cnt, "work": work(S, win),
               "card": torch.cuda.get_device_name(0) if cuda else "cpu",
               "profiled_steps": sum(ep.calls for ep in
                                     win.episodes[:win.profiled]),
               "trace": (trace_mod.reduce(win.prof, win.prof_seconds,
                                          harness_syncs=1)
                         if cuda else None)}
        log(f"trace: {win.profiled} episodes, {rec['profiled_steps']} "
            f"steps, {win.prof_seconds:.3f} s profiled, reduced in "
            f"{time.perf_counter() - t_tr:.3f} s")

    # host copies for the judge; the window's tensors are freed before
    # the reference runs
    chk = c.limits["check"]
    samples = step_samples(S, win, seed, int(chk["samples"]))
    starts = start_samples(S, _cpu(win.episodes[0].lanes))
    L32 = float(np.float32(ref_track.table().total_len))
    closures = closure_samples(S, win, L32)
    del win
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = judge.reference(c.config, c.traffic, S.laps)
    gaps = [judge.judge_step(ref, s) for s in samples]
    numbers = judge.summarize(gaps)
    numbers["rejected_pct"] = 100.0 * cnt["rejected"] / max(cnt["live"], 1)
    numbers["mismatches"] = (
        numbers.pop("carry_mismatches")
        + sum(judge.judge_start(ref, s, S.laps) for s in starts)
        + sum(judge.judge_closure(ref, s, S.laps) for s in closures))
    numbers["gaps"] = [[r["input"], r["plant"], r["accepted"]]
                       for r in gaps]
    log(f"reference: {len(samples)} steps, {len(starts)} starts, "
        f"{len(closures)} closures in {time.perf_counter() - t_ref:.3f} s")
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
    numbers.pop("gaps")
    print(f"card: {card_limit()}", file=sys.stderr)
    print("judge: " + json.dumps(numbers), file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"  {name} {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
