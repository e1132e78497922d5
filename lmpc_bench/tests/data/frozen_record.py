"""What one CPU run of ``lmpc_b256.converged_lap`` computes, as a record
that two versions of the harness can be held to.

    python3 lmpc_bench/tests/data/frozen_record.py --out FILE

from the root of a checkout (``PYTHONPATH`` at that root). It sets the
cell up on the CPU at batch 4, runs a traced window of two episodes on
seed ``SEED`` (no profiler: the CPU has no device activity to trace)
and records: each episode's noise stream and steps, SHA-256
digests of the state fields and plant draws the clock kept, the window's
counters and roofline counts, a digest of every sample the judge was
handed (steps, starts, closures), each sampled step's judged gaps, and
the result's numbers, checks and per-layer metrics. The plant's
reference is left out (its gap, ``plant_gap``, is the one number a
curvature-jump repair may move). ``frozen_lmpc_b256.json`` beside this
file was written by this script on the tree before the controller stages
were split out of the harness; ``test_lmpc_bench_frozen.py`` holds the
current tree to it.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import sys

CELL = "lmpc_b256.converged_lap"
SEED = 3_516_000_001
BATCH = 4
PLANT = ("plant", "other_side")


def digest(*arrays) -> str:
    import numpy as np
    import torch
    h = hashlib.sha256()
    for a in arrays:
        if torch.is_tensor(a):
            a = a.detach().cpu().contiguous().numpy()
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def plain(v):
    """JSON-safe and exactly comparable: NaN and infinities as strings."""
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if hasattr(v, "item"):
        return plain(v.item())
    return v


def record() -> dict:
    import torch

    from lmpc_bench import cell as cell_mod
    from lmpc_bench import judge, run

    torch.set_num_threads(1)
    bench, c, S = run.prepare(CELL, device="cpu", batch=BATCH)
    out = {}
    window, handed = cell_mod.window, {"step": [], "start": [],
                                      "closure": []}

    def work(S, win):
        if hasattr(run, "work"):          # the harness before the stages
            return run.work(S, win)
        return cell_mod.stage(c).work(S, win)

    def captured(S, *a, **k):
        win = window(S, *a, **k)
        out["streams"] = list(win.streams)
        out["calls"] = [ep.calls for ep in win.episodes]
        out["kept"] = [{str(t): digest(*ep.kept[t][0], *ep.kept[t][1])
                        for t in sorted(ep.kept)} for ep in win.episodes]
        out["draws"] = [{str(t): digest(ep.draws[t])
                         for t in sorted(ep.draws)} for ep in win.episodes]
        out["counters"] = run.counters(win)
        out["work"] = work(S, win)
        return win

    def wrap(name, key):
        f = getattr(judge, name)

        def g(ref, s, *a):
            handed[key].append(digest(*s))
            return f(ref, s, *a)
        return f, g

    saved = {}
    for name, key in (("judge_step", "step"), ("judge_start", "start"),
                      ("judge_closure", "closure")):
        saved[name], g = wrap(name, key)
        setattr(judge, name, g)
    cell_mod.window = captured
    profiler, cell_mod._profiler = cell_mod._profiler, contextlib.nullcontext
    try:
        step_gaps = []
        judge_step = judge.judge_step

        def kept_gaps(ref, s):
            r = judge_step(ref, s)
            step_gaps.append({k: v for k, v in r.items() if k not in PLANT})
            return r
        judge.judge_step = kept_gaps
        res = run.measure(bench, c, S, SEED, 0.0, True, log=lambda *a: None)
    finally:
        cell_mod.window, cell_mod._profiler = window, profiler
        for name, f in saved.items():
            setattr(judge, name, f)
    numbers = {k: v for k, v in res["_numbers"].items()
               if not k.startswith("plant_gap")}
    numbers["gaps"] = [[g[0], g[2]] for g in numbers["gaps"]]
    out.update(samples=handed, step_gaps=step_gaps, numbers=numbers,
               checks={k: v for k, v in res["checks"].items()
                       if k != "plant_gap"},
               metrics=res["metrics"], correct=res["correct"],
               attempted=res["attempted"], failed=res["failed"])
    return plain(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        json.dump(record(), f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
