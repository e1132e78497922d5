"""Dump one scenario's inputs of an MPC-stage preset run, for a replay.

The LTV-MPC stage of a preset is driven by two things per scenario: the
PID-stage lap that fills its sys-ID store, and the plant noise of its own
stream. Both come from the card's generators and kernels, so a CPU replay
needs them as numbers. This script runs the preset on the card as
``chip_smoke.py`` phase 5 runs it (the preset's solver, the plant through
the rollout kernel), then writes, for the scenario ``--row``:

- ``pid_x``, ``pid_u``, ``pid_x_glob`` (T, ·) and ``pid_steps``: its PID lap;
- ``ltv_draws`` (stage_steps, 3): the standard-normal plant draws of its
  LTV stage (the stage's stream, redrawn call by call for the whole batch
  and cut to the row);
- ``ltv_x`` (stage_steps, 6): its LTV trajectory on the card, and
  ``card_ok``: whether that trajectory met the stage criteria (no NaN,
  |ey| < 0.5 throughout, final s > 14.0);
- ``misses``: every scenario of the batch that missed them.

    python -m racinglmpc_tpu_torch.runtime.dump_scenario \\
        --preset config3_ltv --seed 0 --row 168 --out fixtures/c3.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop as loop_mod
from racinglmpc_tpu_torch.runtime import presets


def ltv_criteria(x: torch.Tensor) -> torch.Tensor:
    """Per-scenario LTV stage criteria of the reference's closed-loop test
    on x (B, T, 6): no NaN, |ey| < 0.5 throughout, final s > 14.0."""
    finite = torch.isfinite(x).all(-1).all(-1)
    lane = (x[..., 5].abs() < 0.5).all(-1)
    return finite & lane & (x[:, -1, 4] > 14.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="config3_ltv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--row", type=int, default=168)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    base = presets.PRESETS[args.preset]
    if "ltv" not in base["stages"]:
        raise SystemExit(f"{args.preset} runs no LTV stage")
    cfg = dataclasses.replace(base["cfg"], sim=dataclasses.replace(
        base["cfg"].sim, use_pallas_rollout=True))
    out = presets.run_preset(args.preset, seed=args.seed, cfg=cfg,
                             device="cuda")
    res = out["result"]
    batch, r = out["batch"], args.row

    # the LTV stage's plant draws, as run_experiment draws them
    gen = exp._generator(args.seed, "cuda", exp.LTV)
    noise = loop_mod.gaussian_noise(batch, 0, cfg.sim, gen, torch.float32,
                                    "cuda")
    draws = torch.stack([noise(t)[1][r] for t in range(cfg.stage_steps)])

    ok = ltv_criteria(res.ltv.x)
    misses = (~ok).nonzero()[:, 0].cpu().numpy()
    np.savez(
        args.out, preset=args.preset, seed=args.seed, row=r, batch=batch,
        pid_x=res.pid.x[r].cpu().numpy(), pid_u=res.pid.u[r].cpu().numpy(),
        pid_x_glob=res.pid.x_glob[r].cpu().numpy(),
        pid_steps=int(res.pid.steps[r]), ltv_draws=draws.cpu().numpy(),
        ltv_x=res.ltv.x[r].cpu().numpy(), card_ok=bool(ok[r]),
        misses=misses, card=torch.cuda.get_device_name(0))
    x = res.ltv.x[r]
    print(f"dump_scenario: {args.preset} seed {args.seed} row {r}: card ok "
          f"{bool(ok[r])}, final s {float(x[-1, 4]):.4f}, max |ey| "
          f"{float(x[:, 5].abs().max()):.4f}; misses {misses.tolist()} -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
