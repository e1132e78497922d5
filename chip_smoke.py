#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (racinglmpc_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``racinglmpc_tpu_torch/csrc`` (nvcc, into
``build/kernels/``), then:

1. prints the card (nvidia-smi name and power limit), the torch / CUDA
   versions, the kernel build time and the TF32 flags;
2. drives the main path at full width -- the batch-256 LMPC control step
   (``SolverConfig.throughput()``, ``LMPCConfig(max_laps=12, max_pts=1024,
   model_pts=512)``, N=14) seeded from one PID stage of the port's own
   ``run_experiment(stages="pid", batch=1)`` -- for a warm-up chunk and a
   timed chunk of 50 steps, with the launch counters of the three kernels
   reset just before and read just after (each must be > 0), and B1's
   per-layout counters: resident launches > 0 and no scenario streamed;
3. holds B1-B3 against their plain PyTorch versions on the card at the
   main path's shapes (the FTOCPs, lap store and plant states of the batch
   just driven): rollout |dx| < 1e-4, sys-ID |dA|,|dB|,|dC| < 1e-3 (also on
   a ragged store with a 4-row and an empty lap, on a store of tied
   feature rows and on the store zero-padded to T = 1024, and with knn_max
   8 and 40 through B2's rescan instance), each bit-identical
   over two calls, and B2's shared-memory plan against the kernel source's
   count and the card's occupancy (one wave); B2 and B3 are timed by CUDA
   events around 20 back-to-back launches, divided by 20, and every kernel's
   device time comes from a short torch.profiler window; B1 in both of its
   layouts (resident: Kinv and the compressed A and P in shared memory;
   stream: the matrices read from global memory in every product):
   |dx| < 3e-2 after 16 fixed iterations, >= 90% solved at tolerance, and
   a forced rho-escalation
   rescue with the same rescued flags and iteration counts as the plain
   version on every lane; bit-identical results from two resident calls
   and from the two layouts; the shared-memory plan against the kernel
   source's count; times B1 (CUDA events, median of 20 launches after
   warm-up; its layouts in turns: resident, stream, stream, resident);
4. runs the closed loop ``run_experiment(stages="pid,lti,ltv,lmpc",
   n_lmpc_laps=4, batch=4)`` and requires every lap finished, no NaN, a
   first->last lap improvement above 15% and no scenario streamed;
5. runs the MPC stages through ``runtime/presets.run_preset``:
   ``config2_lti`` (batch 64) and ``config3_ltv`` (batch 256), 450 steps
   each, with the preset's ``throughput()`` solver, each with
   ``pallas_fused_ns=True`` (counters reset before, read after: B4 > 0 and
   B1 = 0) and without (B1 > 0), no scenario streamed by either, then
   ``config3_ltv`` with ``throughput_max()`` (the structured KKT build);
   the plant steps through the rollout kernel B3. Each stage must hold on
   >= 99% of its scenarios (LTI: mean vx over steps 300+ within 0.12 of
   0.8, |ey| < 0.5; LTV: final s > 14.0, |ey| < 0.5) with no NaN; prints
   stage wall, steps/s and the accepted share of the solves;
6. holds B4 against its plain version on those stages' FTOCPs -- the LTI
   stage's with their warm cache (batch 64) and the LTV stage's cold build
   (batch 256): |dx| < 3e-2 after 16 fixed iterations, >= 90% solved at
   tolerance, the same warm/cold decision on every lane whose |I - K X0|_F
   lies farther than 1e-3 from 0.9, max|I - K Kinv| < 50 ns_tol for the
   kernel's Kinv on every lane, bit-identical results from two calls, and
   B4's plan (``cuda_qp_fused.plan``) against the kernel source's count and
   the card's occupancy; times both (B4 by CUDA events and in a
   torch.profiler window); and the structured KKT inverse on the
   throughput_max LTV stage's K: max|I - K X| < 5e-2;
7. runs the LMPC stage for 2 laps with a checkpoint, resumes it to 4 laps
   and requires the lap steps of phase 4's uninterrupted run (the LMPC
   noise does not depend on which stages ran before it);
8. prints one JSON line of kernel summaries, the card line, and as the
   last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
any phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

FAILED = []
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores


def check(name, ok, detail=""):
    print(f"[chip_smoke] {'PASS' if ok else 'FAIL'} {name} {detail}",
          flush=True)
    if not ok:
        FAILED.append(name)


def bound_ms(nbytes: float, ops: float):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_o = ops / H100_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(torch, fn, reps=20, warm=3):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warm`` calls."""
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


def nbytes(*ts):
    return float(sum(t.numel() * t.element_size() for t in ts))


def count(c):
    """A launch counter's launches or a scenario counter's scenarios."""
    return c.n if hasattr(c, "n") else c.value()


def admm_ops(torch, P, A, n, m, iters, refine, check_every):
    """Operations the ADMM loop's work needs on these inputs, per scenario:
    per iteration 1 + refine passes over the dense Kinv, 2 + 2 refine
    sparse products with A and refine with P (2 operations per nonzero),
    30 (n + m) elementwise; per check (the entry check and one per chunk)
    one product with A each way and one with P."""
    nnz_a = (A != 0).sum((1, 2)).double()
    nnz_p = (P != 0).sum((1, 2)).double()
    per_iter = (2.0 * n * n * (1 + refine) + 2.0 * nnz_a * (2 + 2 * refine)
                + 2.0 * nnz_p * refine + 30.0 * (n + m))
    per_check = 4.0 * nnz_a + 2.0 * nnz_p + 20.0 * (n + m)
    iters = iters.double()
    checks = 1 + torch.ceil(iters / check_every)
    return iters * per_iter + checks * per_check


FUSED_NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E",
               "c", "x0", "z0", "y0")
STAGE_RUNS = (("config2_lti", "fused"), ("config2_lti", "base"),
              ("config3_ltv", "fused"), ("config3_ltv", "base"),
              ("config3_ltv", "max"))


def stage_ok(torch, x, stage):
    """Per-scenario criteria of the reference's closed-loop stage tests:
    no NaN, |ey| < 0.5 throughout, and LTI mean vx over steps 300+ within
    0.12 of 0.8 / LTV final s > 14.0."""
    finite = torch.isfinite(x).all(-1).all(-1)
    lane = (x[..., 5].abs() < 0.5).all(-1)
    if stage == "lti":
        goal = (x[:, 300:, 0].mean(-1) - 0.8).abs() < 0.12
    else:
        goal = x[:, -1, 4] > 14.0
    return finite & lane & goal


class SolveTally:
    """Counts the solves of a run and the ones the MPC controllers accept
    (finite, primal residual below ``accept_pri_res``), on the device."""

    def __init__(self, torch, qp_mod):
        self.torch, self.qp_mod, self.orig = torch, qp_mod, qp_mod.solve
        self.n, self.acc = 0, None

    def __enter__(self):
        def solve(qp, cfg, *a, **k):
            sol = self.orig(qp, cfg, *a, **k)
            ok = (self.torch.isfinite(sol.x).all(-1)
                  & (sol.pri_res < cfg.accept_pri_res)).sum()
            self.n += sol.x.shape[0]
            self.acc = ok if self.acc is None else self.acc + ok
            return sol
        self.qp_mod.solve = solve
        return self

    def __exit__(self, *exc):
        self.qp_mod.solve = self.orig

    def share(self):
        return float(self.acc) / self.n if self.n else float("nan")


def stage_runs(torch, qp_mod, counters, cuda_qp, cuda_qp_fused):
    """Phase 5: each preset run of STAGE_RUNS with the counters (kernels,
    B1's layouts, streamed scenarios) reset just before and read just
    after."""
    from racinglmpc_tpu_torch.runtime import presets
    from racinglmpc_tpu_torch.utils.config import SolverConfig

    runs = {}
    for name, variant in STAGE_RUNS:
        base = presets.PRESETS[name]["cfg"]
        solver = {"fused": dataclasses.replace(base.solver,
                                               pallas_fused_ns=True),
                  "base": base.solver,
                  "max": SolverConfig.throughput_max()}[variant]
        cfg = dataclasses.replace(base, solver=solver, sim=dataclasses.replace(
            base.sim, use_pallas_rollout=True))
        for c in counters:
            c.reset()
        with SolveTally(torch, qp_mod) as tally:
            out = presets.run_preset(name, cfg=cfg, device="cuda")
        launches = {c.name: count(c) for c in counters}
        res = out["result"]
        stage = "lti" if name == "config2_lti" else "ltv"
        ok = stage_ok(torch, getattr(res, stage).x, stage)
        share = float(ok.float().mean())
        wall = res.stage_wall_s[stage]
        sps = out["batch"] * cfg.stage_steps / wall
        misses = (~ok).nonzero()[:, 0].tolist()
        print(f"[chip_smoke] {name} ({variant}): batch {out['batch']}, "
              f"{stage} stage {cfg.stage_steps} steps in {wall:.2f} s = "
              f"{sps:.1f} scenario-steps/s, whole run {out['wall_s']} s, "
              f"accepted {100 * tally.share():.2f}% of {tally.n} solves, "
              f"criteria met {100 * share:.1f}% (misses {misses}), "
              f"launches {launches}")
        tag = f"{name}_{variant}"
        check(f"{tag}_criteria_99pct", share >= 0.99)
        check(f"{tag}_no_scenario_streamed",
              launches["admm_streamed"] == 0
              and launches["fused_admm_streamed"] == 0
              and launches["admm_stream"] == 0)
        if variant == "fused":
            check(f"{tag}_launched_fused_admm",
                  launches["fused_admm"] > 0 and launches["admm"] == 0,
                  f"({launches['fused_admm']}, admm {launches['admm']})")
        else:
            check(f"{tag}_launched_admm",
                  launches["admm"] > 0 and launches["fused_admm"] == 0)
        runs[f"{name}/{variant}"] = dict(cfg=cfg, res=res, launches=launches,
                                         fused=variant == "fused")
    return runs


def fused_phase(torch, qp_mod, cuda_qp_fused, runs, trk, launches):
    """Phase 6: B4 against its plain version on the LTI stage's FTOCPs
    (warm cache, batch 64) and the LTV stage's (cold build, batch 256).
    Returns the kernel summary (times of the LTV set)."""
    from racinglmpc_tpu_torch.runtime import kernel_bench, stage_path

    info, errs = {}, []
    for key, stage in (("config2_lti/fused", "lti"),
                       ("config3_ltv/fused", "ltv")):
        cfg = runs[key]["cfg"]
        f = stage_path.stage_ftocps(runs[key]["res"], cfg, stage, trk)
        fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                    max_iter=16, check_every=16,
                                    rescue_max_iter=0)
        kw = qp_mod.fused_inputs(f.qp, fixed, f.warm, f.fac)
        args = [kw.pop(n) for n in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
        errs.append(float((k.x - p.x).abs().max()))
        check(f"fused_admm_{stage}_fixed16_vs_plain", errs[-1] < 3e-2,
              f"(max |dx| {errs[-1]:.2e})")

        kw = qp_mod.fused_inputs(f.qp, cfg.solver, f.warm, f.fac)
        args = [kw.pop(n) for n in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        p = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
        check(f"fused_admm_{stage}_same_bits_twice", all(
            bool(torch.equal(x, y)) for x, y in zip(
                k, cuda_qp_fused.admm_iterate_fused(*args, **kw))))
        a = dict(zip(FUSED_NAMES, args))
        B, n = a["q"].shape
        m = a["l"].shape[1]
        pl = cuda_qp_fused.plan(n, m, B)
        card = (cuda_qp_fused.smem_bytes_on_card(n, m),
                cuda_qp_fused.ctas_per_sm_on_card(n, m))
        print(f"[chip_smoke] B4 plan at n={n}, m={m}, batch {B}: {pl}; "
              f"kernel source {card[0]} B, CTAs per SM on the card {card[1]}")
        check(f"fused_admm_{stage}_plan_matches_card",
              card == (pl.nbytes, pl.ctas_per_sm))
        K = cuda_qp_fused.build_k(a["P"], a["A"], a["rho"], cfg.solver.sigma)
        eye = torch.eye(n, device=K.device)
        R0 = eye - K @ a["kinv0"]
        r0f = torch.sqrt((R0 * R0).sum((1, 2)))
        close = a["warm_ok"] & ((r0f - 0.9).abs() <= 1e-3)
        same = bool(((k.warm == p.warm) | close).all())
        rk = float((eye - K @ k.kinv).abs().amax())
        n_ok = int(k.solved.sum())
        check(f"fused_admm_{stage}_tolerance_solves", n_ok >= 0.9 * B,
              f"(solved {n_ok}/{B}; plain {int(p.solved.sum())}/{B})")
        check(f"fused_admm_{stage}_same_warm_decision", same,
              f"(warm kernel {int(k.warm.sum())}/{B}, plain "
              f"{int(p.warm.sum())}/{B}, {int(close.sum())} lanes within "
              f"1e-3 of the gate)")
        check(f"fused_admm_{stage}_kinv_residual",
              rk < 50 * kw["ns_tol"], f"(max|I - K Kinv| {rk:.2e})")
        ms = time_ms(torch, lambda: cuda_qp_fused.admm_iterate_fused(
            *args, **kw))
        dms = kernel_bench.device_ms(
            lambda: cuda_qp_fused.admm_iterate_fused(*args, **kw),
            ("admm_fused", "admm_main", "admm_rescue"))
        pms = time_ms(torch, lambda: cuda_qp_fused.admm_iterate_fused_plain(
            *args, **kw))
        # K = A'(rho A) + P + sigma I from A's nonzeros (2 nnz(row)^2 per
        # row), the warm guard and the Newton-Schulz GEMMs dense, then the
        # ADMM loop's count on these inputs
        row = (a["A"] != 0).sum(2).double()
        k_build = (2.0 * (row * row).sum(1) + (a["P"] != 0).sum((1, 2))
                   + n)
        ops = float((k_build + a["warm_ok"].double() * 2.0 * n ** 3
                     + p.ns_iters.double() * 4.0 * n ** 3
                     + admm_ops(torch, a["P"], a["A"], n, m, k.iters,
                                kw["refine_steps"],
                                cfg.solver.check_every)).sum())
        bms, by = bound_ms(nbytes(*args, k.x, k.y, k.pri, k.dua, k.iters,
                                  k.kinv, k.ns_resid), ops)
        print(f"[chip_smoke] kernel fused_admm ({stage}, batch {B}): "
              f"{ms:.4f} ms (device {dms}, plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms by {by}); warm {int(k.warm.sum())}/{B}, NS "
              f"iters mean kernel {float(k.ns_iters.float().mean()):.2f} "
              f"plain {float(p.ns_iters.float().mean()):.2f}, ADMM "
              f"iters mean kernel {float(k.iters.float().mean()):.2f} plain "
              f"{float(p.iters.float().mean()):.2f}, ns_resid max "
              f"{float(k.ns_resid.max()):.2e}")
        info[stage] = dict(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bms,
                           bound_by=by, ns_iters=float(
                               k.ns_iters.float().mean()),
                           ctas_per_sm=card[1])
    return dict(name="fused_admm", route="cuda",
                source="racinglmpc_tpu_torch/csrc/cuda_qp_fused.cu",
                replaces="racinglmpc_tpu/ops/pallas_qp.py:424",
                launches=launches, max_abs_err=max(errs),
                ms=info["ltv"]["ms"], device_ms=info["ltv"]["device_ms"],
                plain_ms=info["ltv"]["plain_ms"],
                bound_ms=info["ltv"]["bound_ms"],
                bound_by=info["ltv"]["bound_by"], library_ms=None,
                ns_iters=info["ltv"]["ns_iters"],
                ctas_per_sm=info["ltv"]["ctas_per_sm"],
                lti=info["lti"])


def structured_phase(torch, qp_mod, run, trk):
    """The structured KKT inverse on the throughput_max LTV stage's K
    (cold Ruiz scaling, as ``examples/tpu_smoke.py`` checks it)."""
    from racinglmpc_tpu_torch.ops import kkt_band
    from racinglmpc_tpu_torch.runtime import stage_path

    cfg = run["cfg"]
    f = stage_path.stage_ftocps(run["res"], cfg, "ltv", trk, steps=2)
    pro = qp_mod._prologue(f.qp, cfg.solver, None, None)
    K = qp_mod._build_K(pro.qp_s, pro.rho0, cfg.solver.sigma)
    X = kkt_band.structured_kinv(K, f.ctrl.structure)
    eye = torch.eye(K.shape[-1], device=K.device)
    resid = float((eye - K @ X).abs().amax())
    check("structured_kinv_residual", resid < 5e-2,
          f"(max|I - K X| {resid:.2e} over {K.shape[0]} LTV FTOCPs)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from racinglmpc_tpu_torch.models import sysid
    from racinglmpc_tpu_torch.ops import (cuda_build, cuda_qp, cuda_qp_fused,
                                          cuda_rollout, cuda_sysid)
    from racinglmpc_tpu_torch.ops import qp as qp_mod
    from racinglmpc_tpu_torch.runtime import experiment as exp
    from racinglmpc_tpu_torch.runtime import kernel_bench, main_path
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                                   SolverConfig)

    dev = "cuda"
    B, STEPS = 256, 50
    counters = (cuda_qp.launches, cuda_sysid.launches, cuda_rollout.launches,
                cuda_qp_fused.launches)
    # B1's launches per layout and the scenarios B1 and B4 streamed
    layouts = (*cuda_qp.layout_launches.values(), cuda_qp.streamed,
               cuda_qp_fused.streamed)

    # ---- phase 1: device, build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[chip_smoke] card: {smi}")
    print(f"[chip_smoke] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    build = cuda_build.build()
    print(f"[chip_smoke] kernel build {build.seconds:.1f} s -> {build.path}")
    for line in build.log.splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
            print(f"[chip_smoke]   {line.strip()}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"[chip_smoke] tf32 matmul/cudnn: {tf32}")
    check("tf32_off", tf32 == (False, False))

    # ---- phase 2: main path: PID seed stage, batch-256 LMPC step ----------
    for c in counters:
        c.reset()
    t0 = time.time()
    mp, state, plant, pid = main_path.setup(B, device=dev)
    torch.cuda.synchronize()
    print(f"[chip_smoke] PID seed stage + seeding: {time.time() - t0:.1f} s, "
          f"{int(pid.pid.steps[0])} steps, rollout launches "
          f"{cuda_rollout.launches.n}")
    check("pid_stage_used_rollout_kernel", cuda_rollout.launches.n > 0)
    cfg, trk, table, vp, ctrl = mp.cfg, mp.trk, mp.table, mp.vp, mp.ctrl

    for c in counters + layouts:
        c.reset()
    t0 = time.time()
    state, plant = main_path.run_chunk(mp, state, plant, STEPS)[:2]
    torch.cuda.synchronize()
    print(f"[chip_smoke] warm-up chunk ({STEPS} steps): "
          f"{time.time() - t0:.2f} s")
    t0 = time.time()
    state, plant, iters, rej, unc = main_path.run_chunk(mp, state, plant,
                                                        STEPS)
    torch.cuda.synchronize()
    dt_chunk = time.time() - t0
    launches = {c.name: c.n for c in counters}
    lay = {c.name: count(c) for c in layouts}
    it = iters.float().cpu()
    solves = B * STEPS
    sps = solves / dt_chunk
    unc_n = int(unc)
    print(f"[chip_smoke] main path: {sps:.1f} solves/s (batch {B}, "
          f"{STEPS} steps in {dt_chunk:.3f} s), ADMM iters mean "
          f"{float(it.mean()):.2f} p50 {float(it.quantile(0.5)):.0f} "
          f"p99 {float(it.quantile(0.99)):.0f}, rejected {int(rej)}, "
          f"not solved to tolerance {unc_n} of {solves}, launches "
          f"{launches}, B1 layouts and streamed scenarios {lay}")
    for name, n in launches.items():
        if name != "fused_admm":      # B4 is off on the main path
            check(f"main_path_launched_{name}", n > 0, f"({n})")
    check("main_path_admm_resident_no_scenario_streamed",
          lay["admm_resident"] > 0 and lay["admm_stream"] == 0
          and lay["admm_streamed"] == 0, f"({lay})")
    check("main_path_solved_90pct", unc_n <= 0.1 * solves,
          f"({solves - unc_n}/{solves})")
    check("main_path_finite", bool(torch.isfinite(plant.x).all()))

    kernels = []

    # ---- phase 3: B1-B3 against their plain versions ----------------------
    # B3: plant rollout on the batch's current states and inputs
    u = state.u_old.contiguous()

    def rollout():
        return cuda_rollout.plant_step_batch(plant.x, plant.x_glob, u, vp,
                                             trk, cfg.sim, table=table)

    ox, oxg = rollout()
    px, pxg = cuda_rollout.plant_step_batch_plain(plant.x, plant.x_glob, u,
                                                  vp, trk, cfg.sim)
    err = max(float((ox - px).abs().max()), float((oxg - pxg).abs().max()))
    check("rollout_vs_plain", err < 1e-4, f"(max |dx| {err:.2e})")
    check("rollout_same_bits_twice",
          all(bool(torch.equal(a, b)) for a, b in zip((ox, oxg), rollout())))
    ms = kernel_bench.event_ms(rollout)
    dms = kernel_bench.device_ms(rollout, kernel_bench.KERNELS["rollout"])
    pms = time_ms(torch, lambda: cuda_rollout.plant_step_batch_plain(
        plant.x, plant.x_glob, u, vp, trk, cfg.sim))
    bms, by = bound_ms(nbytes(plant.x, plant.x_glob, u, ox, oxg),
                       B * cfg.sim.substeps * 60.0)
    kernels.append(dict(
        name="rollout", route="cuda",
        source="racinglmpc_tpu_torch/csrc/cuda_rollout.cu",
        replaces="racinglmpc_tpu/ops/pallas_rollout.py:66",
        launches=launches["rollout"], max_abs_err=err, ms=ms, device_ms=dms,
        plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None))

    # B2: sys-ID at the horizon of the current state on the full store, a
    # ragged store (a lap of 4 rows, one of 37, an empty one), a store
    # whose rows come in pairs of equal features with different successors
    # (ties decide the picks) and the store zero-padded to T = 1024
    N = cfg.lmpc.N
    x_lin = state.x_lin[:, :N].contiguous()
    u_lin = state.u_lin.contiguous()
    st = state.store
    Kl, T = st.x.shape[1], st.x.shape[2]
    ragged_steps = st.steps.clone()
    ragged_steps[:, 0] = 4
    ragged_steps[:, 1] = 37
    ragged_steps[:, 3] = sysid._EMPTY
    rx, ru = st.x.clone(), st.u.clone()
    rx[:, 3] = 0.0
    ru[:, 3] = 0.0
    pair = torch.arange(T, device=dev) // 2
    tx, tu = st.x.clone(), st.u[:, :, pair].contiguous()
    tx[..., :3] = st.x[:, :, pair, :3]
    pad = (0, 0, 0, max(T, 1024) - T)
    stores = {"full": st, "ragged+empty": sysid.LapStore(rx, ru, ragged_steps),
              "ties": sysid.LapStore(tx, tu, st.steps),
              "T=1024": sysid.LapStore(
                  torch.nn.functional.pad(st.x, pad).contiguous(),
                  torch.nn.functional.pad(st.u, pad).contiguous(), st.steps)}

    def sysid_k(store, lcfg=cfg.lmpc):
        return cuda_sysid.local_linearization_horizon(
            store, trk, x_lin, u_lin, lcfg, cfg.sim.dt, table=table)

    errs = {}
    for name, store in stores.items():
        k = sysid_k(store)
        p = cuda_sysid.local_linearization_horizon_plain(
            store, trk, x_lin, u_lin, cfg.lmpc, cfg.sim.dt)
        errs[name] = max(float((a - b).abs().max()) for a, b in zip(k, p))
    # knn above a lane's list: the rescan instance (one and two chunks of
    # 32 rounds), on the full store and the ties
    for knn in (cuda_sysid.MAX_KNN + 1, 40):
        lcfg = dataclasses.replace(cfg.lmpc, knn_max=knn)
        for name in ("full", "ties"):
            k = sysid_k(stores[name], lcfg)
            p = cuda_sysid.local_linearization_horizon_plain(
                stores[name], trk, x_lin, u_lin, lcfg, cfg.sim.dt)
            errs[f"{name} knn={knn}"] = max(float((a - b).abs().max())
                                            for a, b in zip(k, p))
        pl = cuda_sysid.plan(Kl, T, N, B, knn)
        card = (cuda_sysid.smem_bytes_on_card(T, N, pl.nbuf, knn),
                cuda_sysid.ctas_per_sm_on_card(T, N, pl.nbuf, knn))
        check(f"sysid_plan_knn{knn}_matches_kernel_source",
              card == (pl.nbytes, pl.ctas_per_sm), f"({pl}; card {card})")
    check("sysid_vs_plain", max(errs.values()) < 1e-3,
          "(max |dA|,|dB|,|dC| " + ", ".join(
              f"{n} {e:.2e}" for n, e in errs.items()) + ")")
    k = sysid_k(st)
    check("sysid_same_bits_twice",
          all(bool(torch.equal(a, b)) for a, b in zip(k, sysid_k(st))))
    for rows in sorted({T, max(T, 1024)}):
        pl = cuda_sysid.plan(Kl, rows, N, B)
        card = (cuda_sysid.smem_bytes_on_card(rows, N, pl.nbuf),
                cuda_sysid.ctas_per_sm_on_card(rows, N, pl.nbuf))
        print(f"[chip_smoke] B2 plan at K={Kl}, T={rows}, N={N}: {pl}; "
              f"kernel source {card[0]} B, CTAs per SM on the card {card[1]}")
        check(f"sysid_plan_T{rows}_matches_kernel_source",
              card == (pl.nbytes, pl.ctas_per_sm) and pl.waves == 1,
              "(one wave of the batch)")
    ms = kernel_bench.event_ms(lambda: sysid_k(st))
    dms = kernel_bench.device_ms(lambda: sysid_k(st),
                                 kernel_bench.KERNELS["sysid"])
    pms = time_ms(torch, lambda: cuda_sysid.local_linearization_horizon_plain(
        st, trk, x_lin, u_lin, cfg.lmpc, cfg.sim.dt))
    # operations these laps need: a scaled-L1 distance (16) per valid row
    # and query, 3 per pick and normal-equation entry (45)
    valid = ((torch.clamp(st.steps, max=T) - 1).clamp(min=0)
             * (st.steps < sysid._EMPTY)).sum()
    ops = N * (16.0 * float(valid) + B * Kl * cfg.lmpc.knn_max * 135.0)
    bms, by = bound_ms(nbytes(st.x, st.u, st.steps, x_lin, u_lin, *k), ops)
    kernels.append(dict(
        name="sysid", route="cuda",
        source="racinglmpc_tpu_torch/csrc/cuda_sysid.cu",
        replaces="racinglmpc_tpu/ops/pallas_sysid.py:68",
        launches=launches["sysid"], max_abs_err=max(errs.values()), ms=ms,
        device_ms=dms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None))

    # B1: the batch's own FTOCPs, prologue as in the solve
    qp, _, _, _ = ctrl.build_qp(state, plant.x)
    warm = (state.warm_x, state.warm_y)
    names = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
             "z0", "y0")

    def admm_args(scfg, fac):
        pro, Kinv1, _ = qp_mod.admm_inputs(qp, scfg, warm, fac)
        kw = qp_mod.kernel_args(pro, Kinv1, scfg)
        return [kw.pop(n) for n in names], kw

    n, m = qp.q.shape[1], qp.l.shape[1]
    plan = cuda_qp.choose_layout(n, m)
    card_bytes = cuda_qp.smem_bytes_on_card(n, m, plan)
    card_ctas = {name: cuda_qp.ctas_per_sm_on_card(n, m, cuda_qp.pick_layout(
        n, m, name)) for name in cuda_qp.LAYOUTS}
    print(f"[chip_smoke] B1 plan at n={n}, m={m}: {plan}; kernel source "
          f"{card_bytes} B; CTAs per SM on the card {card_ctas}")
    check("admm_plan_matches_kernel_source",
          plan.name == "resident" and card_bytes == plan.nbytes
          and card_ctas["resident"] == 1,
          "(one resident CTA per SM: shared memory and registers)")
    fixed = dataclasses.replace(cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    f_args, f_kw = admm_args(fixed, state.fac)
    args, kw = admm_args(cfg.solver, state.fac)
    rescue_cfg = dataclasses.replace(
        cfg.solver, rho=1e-4, rho_eq_scale=1.0, max_iter=40,
        check_every=10, scaling_iters=0, eps_abs=1e-4, eps_rel=1e-4,
        rescue_max_iter=400, rescue_rho_scale=100.0)
    r_args, r_kw = admm_args(rescue_cfg, None)
    pf = cuda_qp.admm_iterate_plain(*f_args, **f_kw)
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    pr = cuda_qp.admm_iterate_plain(*r_args, **r_kw)
    err_b1, outs = {}, {}
    for name in cuda_qp.LAYOUTS:
        cuda_qp.streamed.reset()
        k = cuda_qp.admm_iterate(*f_args, **f_kw, layout=name)
        err_b1[name] = float((k[0] - pf[0]).abs().max())
        check(f"admm_{name}_fixed16_vs_plain", err_b1[name] < 3e-2,
              f"(max |dx| {err_b1[name]:.2e})")
        k = cuda_qp.admm_iterate(*args, **kw, layout=name)
        n_ok = int(k[5].sum())
        check(f"admm_{name}_tolerance_solves_batch", n_ok >= 0.9 * B,
              f"(solved {n_ok}/{B}; plain {int(p[5].sum())}/{B}; iters mean "
              f"kernel {float(k[4].float().mean()):.2f} plain "
              f"{float(p[4].float().mean()):.2f}, max kernel "
              f"{int(k[4].max())} plain {int(p[4].max())}; rescued kernel "
              f"{int(k[6].sum())} plain {int(p[6].sum())})")
        kr = cuda_qp.admm_iterate(*r_args, **r_kw, layout=name)
        outs[name] = (k, kr)
        same_flags = bool((kr[6] == pr[6]).all())
        same_iters = float((kr[4] == pr[4]).float().mean())
        check(f"admm_{name}_forced_rescue", bool(kr[6].all()) and same_flags
              and same_iters == 1.0,
              f"(rescued {int(kr[6].sum())}/{B}, flags equal {same_flags}, "
              f"iteration counts equal on {100 * same_iters:.1f}% of lanes, "
              f"rescued-lane iters mean kernel "
              f"{float(kr[4].float().mean()):.1f} plain "
              f"{float(pr[4].float().mean()):.1f})")
        want = 0 if name == "resident" else 3 * B
        check(f"admm_{name}_streamed_scenarios",
              cuda_qp.streamed.value() == want,
              f"({cuda_qp.streamed.value()}, expected {want})")
    k = cuda_qp.admm_iterate(*args, **kw)
    k2 = cuda_qp.admm_iterate(*args, **kw)
    check("admm_resident_same_bits_twice",
          all(bool(torch.equal(a, b)) for a, b in zip(k, k2)))
    check("admm_resident_same_bits_as_stream", all(
        bool(torch.equal(a, b)) for r, s in zip(outs["resident"],
                                                 outs["stream"])
        for a, b in zip(r, s)), "(at tolerance and under the forced rescue)")
    times = {name: [] for name in cuda_qp.LAYOUTS}
    for name in ("resident", "stream", "stream", "resident"):
        times[name].append(time_ms(torch, lambda: cuda_qp.admm_iterate(
            *args, **kw, layout=name)))
    ms = statistics.mean(times["resident"])
    stream_ms = statistics.mean(times["stream"])
    dms = kernel_bench.device_ms(lambda: cuda_qp.admm_iterate(*args, **kw),
                                 ("admm_main", "admm_rescue"))
    pms = time_ms(torch, lambda: cuda_qp.admm_iterate_plain(*args, **kw))
    ops = float(admm_ops(torch, args[0], args[2], n, m, k[4],
                         kw["refine_steps"], cfg.solver.check_every).sum())
    bms, by = bound_ms(nbytes(*args, k[0], k[1], k[2], k[3], k[4]), ops)
    print(f"[chip_smoke] kernel admm layouts in turns (resident, stream, "
          f"stream, resident): {times}; bound {bms:.4f} ms by {by} "
          f"({ops / B:.0f} operations per scenario, nnz(A) mean "
          f"{float((args[2] != 0).sum((1, 2)).float().mean()):.1f}, nnz(P) "
          f"mean {float((args[0] != 0).sum((1, 2)).float().mean()):.1f})")
    kernels.append(dict(
        name="admm", route="cuda",
        source="racinglmpc_tpu_torch/csrc/cuda_qp.cu",
        replaces="racinglmpc_tpu/ops/pallas_qp.py:391",
        launches=launches["admm"], max_abs_err=max(err_b1.values()), ms=ms,
        device_ms=dms, plain_ms=pms, bound_ms=bms, bound_by=by,
        library_ms=None, resident_ms=ms, stream_ms=stream_ms))
    for kinfo in kernels:
        print(f"[chip_smoke] kernel {kinfo['name']}: {kinfo['ms']:.4f} ms "
              f"(device {kinfo['device_ms']}, plain "
              f"{kinfo['plain_ms']:.4f} ms, bound "
              f"{kinfo['bound_ms']:.4f} ms by {kinfo['bound_by']}), "
              f"{kinfo['launches']} launches on the main path")

    # ---- phase 4: closed loop, all four stages -----------------------------
    loop_cfg = exp.ExperimentConfig(
        stage_steps=450, n_lmpc_laps=4, lap_max_steps=500, lap_chunk=125,
        solver=SolverConfig.throughput(),
        sim=SimConfig(use_pallas_rollout=True),
        lmpc=LMPCConfig(max_laps=10, max_pts=1024, model_pts=512,
                        use_pallas_sysid=True))
    for c in counters + layouts:
        c.reset()
    t0 = time.time()
    res = exp.run_experiment(loop_cfg, batch=4, stages="pid,lti,ltv,lmpc",
                             trk=trk, device=dev, seed=0)
    ls = res.lap_steps.astype(float)
    gain = 1.0 - ls[:, -1].mean() / ls[:, 0].mean()
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.lmpc_state.x_pred, res.lti.x, res.ltv.x))
    walls = {k: round(v, 1) for k, v in res.stage_wall_s.items()}
    print(f"[chip_smoke] closed loop ({time.time() - t0:.1f} s, stage walls "
          f"{walls} s): lap steps {res.lap_steps.tolist()}, lap times "
          f"{res.lap_times.tolist()}, launches "
          f"{dict((c.name, count(c)) for c in counters + layouts)}")
    check("closed_loop_laps_finished", bool((res.lap_steps < 500).all()))
    check("closed_loop_improves_15pct", gain > 0.15,
          f"(first->last mean lap steps {100 * gain:.1f}%)")
    check("closed_loop_finite", finite)
    check("closed_loop_used_kernels",
          all(c.n > 0 for c in counters if c.name != "fused_admm"))
    check("closed_loop_admm_resident_no_scenario_streamed",
          cuda_qp.layout_launches["resident"].n > 0
          and cuda_qp.layout_launches["stream"].n == 0
          and cuda_qp.streamed.value() == 0)
    loop_steps = res.lap_steps

    # ---- phase 5: the MPC stages through the presets ----------------------
    runs = stage_runs(torch, qp_mod, counters + layouts, cuda_qp,
                      cuda_qp_fused)
    fused_launches = sum(r["launches"]["fused_admm"] for r in runs.values()
                         if r["fused"])

    # ---- phase 6: B4 against its plain version; structured inverse -------
    kernels.append(fused_phase(torch, qp_mod, cuda_qp_fused, runs, trk,
                               fused_launches))
    structured_phase(torch, qp_mod, runs["config3_ltv/max"], trk)

    # ---- phase 7: checkpoint and resume -----------------------------------
    ck = pathlib.Path(__file__).resolve().parent / "build" / "smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.time()
    two = dataclasses.replace(loop_cfg, n_lmpc_laps=2)
    exp.run_experiment(two, batch=4, stages="pid,lmpc", trk=trk, device=dev,
                       seed=0, checkpoint_dir=str(ck))
    res = exp.run_experiment(loop_cfg, batch=4, stages="pid,lmpc", trk=trk,
                             device=dev, seed=0, checkpoint_dir=str(ck),
                             resume=True)
    shutil.rmtree(ck, ignore_errors=True)
    same = res.lap_steps.shape == loop_steps.shape and bool(
        (res.lap_steps == loop_steps).all())
    print(f"[chip_smoke] checkpoint + resume ({time.time() - t0:.1f} s): "
          f"resumed at lap {res.resume_lap}, lap steps "
          f"{res.lap_steps.tolist()} (uninterrupted {loop_steps.tolist()})")
    check("resume_reproduces_uninterrupted", res.resume_lap == 2 and same)

    if FAILED:
        print(f"[chip_smoke] FAILED: {', '.join(FAILED)}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
