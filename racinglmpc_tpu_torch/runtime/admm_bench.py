"""Kernel B1 timed on saved main-path inputs, so that two checkouts of the
port can be timed on the same FTOCPs in one call on one card.

    python racinglmpc_tpu_torch/runtime/admm_bench.py --save build/b1.pt
    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/admm_bench.py \\
        --load build/b1.pt
    PYTHONPATH=<other checkout> python \\
        racinglmpc_tpu_torch/runtime/admm_bench.py --load build/b1.pt

``--save`` drives the main path (batch 256, 100 steps, as ``chip_smoke.py``
phase 2 does) and stores the kernel inputs of the next step's solve, at the
solver's tolerance and at 16 fixed iterations (no early exit, no rescue:
the time per iteration). ``--load`` times ``cuda_qp.admm_iterate`` of
whichever package is imported on them (CUDA events, median of 20 launches
after 3), in every layout that package offers, and prints one JSON line
per configuration and layout with the iterations (mean, max) and the
rescued lanes. ``--phases`` builds the kernels with their phase clocks
(``-DQP_PHASES``) and prints, per configuration, the SM cycles scenario 0
spent in each phase of the resident layout's loop.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import inspect
import json
import statistics
import subprocess

import torch

from racinglmpc_tpu_torch.ops import cuda_build, cuda_qp

PHASES = ("v.Kinv", "rho A xt", "A'(rho z - y)", "xt.P + A'(rho A xt)",
          "A xt + z, y update", "check", "prologue",
          "vectors + Kinv wait")   # qp_common.cuh: PH_*


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def save(path: str, batch: int = 256, steps: int = 100) -> None:
    from racinglmpc_tpu_torch.ops import qp as qp_mod
    from racinglmpc_tpu_torch.runtime import main_path

    mp, st, plant, _ = main_path.setup(batch)
    st, plant = main_path.run_chunk(mp, st, plant, steps)[:2]
    qp = mp.ctrl.build_qp(st, plant.x)[0]
    fixed = dataclasses.replace(mp.cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    out = {}
    for key, scfg in (("tolerance", mp.cfg.solver), ("fixed16", fixed)):
        pro, kinv, _ = qp_mod.admm_inputs(qp, scfg, (st.warm_x, st.warm_y),
                                          st.fac)
        kw = qp_mod.kernel_args(pro, kinv, scfg)
        out[key] = {k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in kw.items()}
    torch.save(out, path)


def _card(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def phases(path: str) -> None:
    cuda_build.DEFINES = ("QP_PHASES",)
    lib = cuda_build.library()
    lib.rl_admm_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rl_admm_phases.restype = ctypes.c_int
    buf = (ctypes.c_longlong * len(PHASES))()
    for key, kw in torch.load(path).items():
        kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
        cuda_build.check(lib.rl_admm_phases(buf, 1))
        out = cuda_qp.admm_iterate(**kw, layout="resident")
        torch.cuda.synchronize()
        cuda_build.check(lib.rl_admm_phases(buf, 0))
        print(json.dumps(dict(
            config=key, scenario0_iters=int(out[4][0]),
            cycles=dict(zip(PHASES, list(buf))),
            sm_clock=_card("clocks.sm"), card=_card())), flush=True)


def load(path: str) -> None:
    card = _card()
    layouts = [None]
    if "layout" in inspect.signature(cuda_qp.admm_iterate).parameters:
        layouts = list(cuda_qp.LAYOUTS)
    for key, kw in torch.load(path).items():
        kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
        for layout in layouts:
            extra = {} if layout is None else {"layout": layout}
            out = cuda_qp.admm_iterate(**kw, **extra)
            ms = _time_ms(lambda: cuda_qp.admm_iterate(**kw, **extra))
            it = out[4].float()
            print(json.dumps(dict(
                config=key, layout=layout or "default", ms=ms,
                iters_mean=float(it.mean()), iters_max=int(it.max()),
                rescued=int(out[6].sum()), batch=int(it.numel()),
                package=cuda_qp.__file__, card=card)), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="drive the main path, store the inputs")
    ap.add_argument("--load", help="time B1 on stored inputs")
    ap.add_argument("--phases", help="phase clocks of B1 on stored inputs")
    a = ap.parse_args()
    if a.save:
        save(a.save)
    if a.load:
        load(a.load)
    if a.phases:
        phases(a.phases)
