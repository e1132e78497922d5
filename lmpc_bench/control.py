"""The readings that set the limits of ``correct``, and the control.

    python3 -m lmpc_bench.control --workload <cell> --variant <v> \
        --seeds 11,12,13 --seconds <s> [--out FILE]

runs the cell's window and its check once per seed in one process (one
set-up), and prints each run's compared numbers as a JSON line (to
``--out`` too). ``--variant``:

- ``program``: the cell as ``BENCHMARK.json`` states it (the lower
  readings);
- ``bf16x3``, ``default``: the control, the step below the configuration's
  float32 that the program has itself: B1's iterations at that
  ``pallas_iter_precision`` (``bf16x3``: each operand split into two
  bfloat16 halves, three products; ``default``: one bfloat16 pass), and the
  plant's state kept in bfloat16 after every period (the reference's plant
  put in the program's place at bfloat16). It has to come out not correct.

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

CONTROLS = ("bf16x3", "default")


def bf16_plant(loop_mod):
    """Keep the plant's state in bfloat16 after each period: the lap
    runner's plant step, wrapped in place for this process."""
    import torch

    from racinglmpc_tpu_torch.models.dynamics import PlantState
    step = loop_mod.plant_step

    def rounded(plant, u, vp, trk, sim_cfg, draws, table):
        out = step(plant, u, vp, trk, sim_cfg, draws, table)
        return PlantState(x=out.x.to(torch.bfloat16).to(out.x.dtype),
                          x_glob=out.x_glob)
    loop_mod.plant_step = rounded


def overrides(variant: str) -> dict:
    if variant == "program":
        return {}
    if variant not in CONTROLS:
        raise ValueError(f"variant must be program or one of {CONTROLS}")
    return {"solver": {"pallas_iter_precision": variant}}


def readings(workload: str, variant: str, seeds, seconds: float, *,
             device: str = "cuda", batch=None, log=print):
    """Yield (seed, result) for each seed, one set-up for all."""
    from lmpc_bench import run
    from racinglmpc_tpu_torch.runtime import loop
    if variant != "program":
        bf16_plant(loop)
    bench, c, S = run.prepare(workload, device=device, batch=batch,
                              overrides=overrides(variant))
    for seed in seeds:
        t0 = time.perf_counter()
        out = run.measure(bench, c, S, int(seed), seconds, False,
                          log=lambda *a: None)
        log(f"{workload} {variant} seed {seed}: correct {out['correct']} "
            f"({time.perf_counter() - t0:.1f} s)")
        yield int(seed), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, out in readings(args.workload, args.variant, seeds,
                                  args.seconds,
                                  log=lambda m: print(m, file=sys.stderr)):
            line = json.dumps({"workload": args.workload,
                               "variant": args.variant, "seed": seed,
                               "correct": out["correct"],
                               "attempted": out["attempted"],
                               "failed": out["failed"],
                               "metrics": out["metrics"],
                               "numbers": out["_numbers"]})
            print(line[:600], flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
