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
   ``run_experiment(stages="pid", batch=1)`` -- through the bench's
   headline (``runtime/bench.time_chunks``): a warm-up chunk and 3 timed
   chunks of 50 steps, the best one reported, each timed chunk holding B1,
   B2 and B3 to one launch a step and no scenario streamed; the launch
   counters of the three kernels are reset just before and read just
   after (each must be > 0), and B1's per-layout counters: resident
   launches > 0 and no scenario streamed; at most 10% of the solves of
   the first two timed chunks (steps 51-150) not at tolerance, the share
   of all three (the bench's window, steps 51-200, which reaches the
   finish line: ROADMAP C6) and where the last chunk's solves at
   max_iter sit printed beside it; after each timed chunk, the float64
   true residual max|I - K Kinv| of the inverse handed to B1 on 8 lanes,
   below the reference's float32 floor (3e-4);
   the final Newton-Schulz squaring timed in float64 and in float32;
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
   and from the two layouts; the same on the FTOCPs after the last timed
   chunk (step 200), but at tolerance, where most solves sit at float32's
   floor of the dual residual (ROADMAP C6), solves and mean iterations
   within 2% of the interval between the plain version with float32
   products and with each product rounded once from float64, and every
   lane called solved at tolerance in float64, and the lanes the plain
   version brings to tolerance with one class of products at a time
   rounded once from float64 printed (``product_classes``: the exit
   test's, Kinv.rhs with its refinement, the iteration's A x and
   A'(rho z - y)); under the forced rescue
   the plain version's count on every lane but those whose count it does
   not reproduce itself in another summation order (the lane alone on the
   CPU, one thread), at most 2% of the batch (``last_chunk_b1``, ROADMAP
   C7); the float64 true residuals of B1's in-kernel rescue inverse and
   of B4's prologue inverse on 8 lanes (``inverse_floors``);
   the shared-memory plan against the kernel
   source's count; times B1 (CUDA events, median of 20 launches after
   warm-up; its layouts in turns: resident, stream, stream, resident);
   then B1 at the lowered iteration precisions ("bf16x3", "default"; the
   reference's ``pallas_iter_precision``) in both layouts against the
   plain version: after one fixed iteration on 64 random QPs (n = 30)
   within fixed limits (``SHARP``; at default a lane beyond the max limit
   only within the mean limit of the plain version with one near-tie bf16
   rounding taken the other way, ``FLIP_MARGIN``), every other
   precision's kernel ("highest" included) beyond them; on the main
   path's FTOCPs bf16x3
   after 16 fixed iterations within twice the control (the plain version
   with float64 accumulation against itself: bf16x3 rounds each operand
   to ~16 bits, so another summation order moves a product by ~2^-17 and
   the iteration amplifies it), default after one (it diverges on these
   FTOCPs) with the median lane within 1e-3 relative; at the main path's
   tolerance solved count (or 2 scenarios) and mean iterations within 2%
   of the plain version's; two calls bit-identical; the forced rescue (full precision
   whatever the loop's) with the plain version's flags (every lane at
   bf16x3; at default a lane whose loop ends NaN is not rescued, as in
   the reference) and its iteration counts on >= 95% of lanes; every
   precision timed by events around 20 back-to-back launches and on the
   device, at 16 fixed iterations and at tolerance;
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
   torch.profiler window); then B4 at bf16x3 and default on both sets: the
   prologue's outputs bit-identical to highest's, the ADMM phase against
   the plain loop on B4's own refreshed inverse as phase 3 holds B1 (and
   on the random QPs), solves and iterations at tolerance as the plain
   version's, two calls bit-identical, every precision timed in one loop;
   and the
   structured KKT inverse on the throughput_max LTV stage's K: max|I - K
   X| < 5e-2;
7. runs the LMPC stage for 2 laps with a checkpoint, resumes it to 4 laps
   and requires the lap steps of phase 4's uninterrupted run (the LMPC
   noise does not depend on which stages ran before it);
8. the mesh and giant path (``parallel/mesh.py``, ``ops/qp_sharded.py``,
   ``controllers/giant_ftocp.py``): (a) ``make_mesh()`` on a one-rank NCCL
   group, phase 4's LMPC run through ``run_experiment(stages="pid,lmpc",
   mesh=...)`` with the counters reset just before and read just after:
   its lap steps must equal phase 4's, B1, B2 and B3 must launch and no
   scenario may stream; ``cross_scenario_metrics`` over NCCL against
   torch's mean (1e-6 relative) / min / max (equal); (b) the giant FTOCP at
   N = 40 in float64, assembled on the card from a noise-free PID lap (the
   float64 NumPy plant of ``tests/oracles/ref_plant.py``), solved by the
   sharded solver on a one-rank NCCL mesh with the settings of
   ``tests/test_giant_ftocp.py`` and held to its criteria against the
   float64 interior-point oracle ``tests/oracles/qp_ip.py``: relative
   objective gap < 1e-6, feasibility < 1e-6, lambda on the simplex
   (|sum - 1| < 1e-5, min > -1e-6), and one check chunk of the same solve
   with the CG iteration replayed as a CUDA graph against its operations
   launched one by one (equal x and CG count; both timed); (c) the full
   width, N = 512 in
   float32 (n = 5180, m = 7229) on a lap of the port's PID stage (420
   steps, noise on), ``ShardedSolverConfig(max_iter=500)``:
   prints the assembly seconds, the solve wall, ``iters``, ``cg_iters``,
   the residuals, the sum and minimum of lambda and the rank's block MB,
   and requires a finite x, ``pri_res <= 1e-2`` and
   |sum(lambda) - 1| <= ``pri_res``;
9. the main path at each lowered iteration precision: ``main_path.setup``
   with ``throughput()`` and ``pallas_iter_precision`` replaced, 20 steps
   after phase 2's PID seed (then 5 with ``pallas_fused_ns``, B4), counters
   reset just before and read just after: prints solves/s, the rejected share,
   the solves not at tolerance and ADMM iterations mean / p50 / p99, and
   requires finite states and inputs, B1 (B4) launched at that precision
   on every step and no scenario streamed (the rejected share is the
   card's verdict, not a gate);
10. the bench's closed-loop quality gate (``runtime/bench.quality_gate``)
   at its defaults on the main path's preset: 12 laps seeded from phase
   2's PID lap, then 8 from ``fixtures/converged_laps_v1.npz``, batch 8,
   chunk 100, at most 400 steps a lap; every per-lap list is printed, the
   gate must pass, B1-B3 must launch in it and no scenario may stream;
   then the ``throughput_max()`` secondary (``bench.secondary``: its timed
   chunks on the kernels, no error); then the converged phase again at
   the round-3 preset (``rescue_max_iter=0``), which must fail one of the
   gate's criteria (the gate can fail); where the converged phase's
   solves not at tolerance sit is printed, by metres to the finish line
   and by ADMM iterations (ROADMAP C9);
11. the 40-lap lap-time criterion (``runtime/solver_quality.py``, the
   port's counterpart of ``examples/solver_quality.py``): one scenario of
   ``throughput()`` in float32 on the card with ``LMPCConfig()``, the
   record's own configuration (B1 drives the QP; by the reference's rule
   the sys-ID is the plain one), driven through the float64 NumPy plant
   of ``tests/oracles/ref_plant.py`` with the draws of
   ``fixtures/solver_quality_40lap_v1.npz`` for 40 laps, counters reset
   just before and read just after; every lap's steps printed beside the
   float64 oracle's (the fixture) and the reference's float32 controller's
   (``BENCH_solver_quality_40lap_tpu.json``); cumulative lap steps within
   1% of the oracle's, every lap under 1000 steps, no NaN, rejected solves
   at most 0.5%, B1 launched once a step and no scenario streamed, and B2
   launched once a step on that step's sys-ID inputs, within 1e-3 of the
   plain sys-ID the step ran. Each phase's wall is printed;
12. prints one JSON line of kernel summaries (B1 and B4 also at each
   lowered precision, their launches from phase 9; a variant's
   ``max_abs_err`` is that of the random-QP check, ``ftocp_max_abs_err``
   that of the FTOCP check; its bound prices the main loop's products at
   the bf16 tensor-core rate), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
any phase fails. It imports nothing of JAX.

    python3 chip_smoke.py --quality-triage

runs phase 11's 40 laps alone, 16 draws with B2 engaged and 16 with the
plain sys-ID (the run and 15 one-float32-ulp nudges of the controller's
state at one step each), eight worker processes at once on the card
(~21 min on one H100): how far float32's rounding moves the criterion
(``quality_triage``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import statistics
import sys
import time
import traceback

FAILED = []
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12       # bf16 x bf16 -> float32 on the tensor cores


def check(name, ok, detail=""):
    print(f"[chip_smoke] {'PASS' if ok else 'FAIL'} {name} {detail}",
          flush=True)
    if not ok:
        FAILED.append(name)


def bound_ms(nbytes: float, ops: float, bf16_ops: float = 0.0):
    """(ms, "bytes" or "operations"): ``ops`` float32 operations and
    ``bf16_ops`` products of bf16 operands accumulated in float32, each at
    its type's peak rate."""
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_o = (ops / H100_F32_FLOPS + bf16_ops / H100_BF16_FLOPS) * 1e3
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


def admm_ops(torch, P, A, n, m, iters, refine, check_every,
             precision="highest", max_iter=None):
    """(float32, bf16) operations the ADMM loop's work needs on these
    inputs, per scenario: per iteration 1 + refine passes over the dense
    Kinv, 2 + 2 refine sparse products with A and refine with P (2
    operations per nonzero), 30 (n + m) elementwise; per check (the entry
    check and one per chunk) one product with A each way and one with P.
    Below "highest" the main loop's products (its first ``max_iter``
    iterations) are bf16 products, three of them at bf16x3; the rescue's
    iterations, the elementwise work and the checks stay float32. Neither
    count holds the rescue's inverse rebuild (nor does it at highest)."""
    nnz_a = (A != 0).sum((1, 2)).double()
    nnz_p = (P != 0).sum((1, 2)).double()
    prod = (2.0 * n * n * (1 + refine) + 2.0 * nnz_a * (2 + 2 * refine)
            + 2.0 * nnz_p * refine)
    per_check = 4.0 * nnz_a + 2.0 * nnz_p + 20.0 * (n + m)
    iters = iters.double()
    checks = 1 + torch.ceil(iters / check_every)
    f32 = iters * 30.0 * (n + m) + checks * per_check
    if precision == "highest":
        return f32 + iters * prod, torch.zeros_like(f32)
    main = torch.clamp(iters, max=max_iter)
    return (f32 + (iters - main) * prod,
            main * prod * (3.0 if precision == "bf16x3" else 1.0))


FUSED_NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E",
               "c", "x0", "z0", "y0")
ADMM_NAMES = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
              "z0", "y0")
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


def fused_phase(torch, qp_mod, cuda_qp, cuda_qp_fused, runs, trk, launches):
    """Phase 6: B4 against its plain version on the LTI stage's FTOCPs
    (warm cache, batch 64) and the LTV stage's (cold build, batch 256), at
    every iteration precision. Returns (the variants' kernel entries, the
    kernel summary at highest; times of the LTV set)."""
    from racinglmpc_tpu_torch.runtime import kernel_bench, stage_path

    info, errs, variants = {}, [], {}
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
                                cfg.solver.check_every)[0]).sum())
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
        variants[stage] = b4_precisions(torch, qp_mod, cuda_qp,
                                        cuda_qp_fused, kernel_bench, f,
                                        cfg.solver, stage)
    sharp = sharp_check(qp_mod, cuda_qp, cuda_qp_fused, "fused_admm")
    entries = [dict(
        name=f"fused_admm_{prec}", route="cuda",
        source="racinglmpc_tpu_torch/csrc/cuda_qp_fused.cu",
        replaces="racinglmpc_tpu/ops/pallas_qp.py:424", launches=None,
        max_abs_err=sharp[prec],
        **{k: v for k, v in variants["ltv"][prec].items()
           if k != "ftocp_max_abs_err"},
        ftocp_max_abs_err=max(variants[st][prec]["ftocp_max_abs_err"]
                              for st in variants),
        library_ms=None, lti=variants["lti"][prec]) for prec in VARIANTS]
    return entries, dict(name="fused_admm", route="cuda",
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


# iteration precisions below "highest" (pallas_iter_precision), and the
# fixed iterations of each one's check against its plain version: bf16x3
# as the highest checks; default diverges on these FTOCPs (|x| ~ 400 after
# one iteration, NaN by 16), so one
VARIANTS = ("bf16x3", "default")
FIXED_ITERS = {"bf16x3": 16, "default": 1}


class float64_products:
    """Inside the block the plain ADMM loop's products of each class in
    ``classes`` (``cuda_qp.PRODUCTS``; all of them by default) accumulate
    in float64 and round once: the control of the variants' checks, how
    far another summation order moves the plain version itself, and which
    products' rounding sets the finish line's floor (ROADMAP C6). With
    ``rounded=False`` they stay float64, and so does the arithmetic that
    reads them (for the exit test's class: its whole test)."""

    def __init__(self, cuda_qp, classes=None, rounded=True):
        self.mod = cuda_qp
        self.classes = classes or cuda_qp.PRODUCT_CLASSES
        self.out = (lambda t: t.float()) if rounded else (lambda t: t)

    def __enter__(self):
        self.saved = dict(self.mod.PRODUCTS)
        out = self.out
        for c in self.classes:
            vm, mv = self.mod.products(c)
            self.mod.PRODUCTS[c] = (
                lambda v, M, vm=vm: out(vm(v.double(), M.double())),
                lambda M, v, mv=mv: out(mv(M.double(), v.double())))

    def __exit__(self, *exc):
        self.mod.PRODUCTS.update(self.saved)


def product_classes(cuda_qp, args, kw):
    """B1's plain version at tolerance on one batch (``admm_iterate``'s
    arguments) with float32 products, with one class of products at a time
    rounded once from float64, with the exit test wholly in float64
    ("check64"), and with every class rounded once ("all"): {name: its
    output}. Which of them certifies the lanes that float32 leaves at the
    floor names the products whose rounding sets it (ROADMAP C6)."""
    out = {"float32": cuda_qp.admm_iterate_plain(*args, **kw)}
    for name, classes, rounded in (
            *((c, (c,), True) for c in cuda_qp.PRODUCT_CLASSES),
            ("check64", ("check",), False), ("all", None, True)):
        with float64_products(cuda_qp, classes, rounded):
            out[name] = cuda_qp.admm_iterate_plain(*args, **kw)
    return out


def class_text(outs):
    """Solved lanes and mean iterations of :func:`product_classes`."""
    B = outs["float32"][5].numel()
    return ", ".join(f"{k} {int(o[5].sum())}/{B} (iters mean "
                     f"{float(o[4].float().mean()):.2f})"
                     for k, o in outs.items())


def variant_agrees(torch, prec, kx, px, cx):
    """(ok, detail, max |dx|): a kernel's x at a lowered precision against
    its plain version's px. bf16x3 rounds each operand to ~16 bits, so a
    last-bit difference of a float32 sum moves a product by ~2^-17 and the
    iteration amplifies it: the kernel must lie within twice the control
    (cx: the plain version with float64 accumulation) of px. default: x
    finite and the median lane within 1e-3 of its max|x| (a few lanes part
    whatever the order)."""
    err = float((kx - px).abs().max())
    if prec == "bf16x3":
        ctl = float((cx - px).abs().max())
        return (err <= 2.0 * ctl + 1e-4,
                f"(max |dx| {err:.3e}, control {ctl:.3e})", err)
    rel = (kx - px).abs().amax(-1) / px.abs().amax(-1).clamp(min=1e-30)
    med = float(rel.median())
    return (bool(torch.isfinite(kx).all()) and med < 1e-3,
            f"(median lane relative |dx| {med:.2e}, max |dx| {err:.3e})",
            err)


def variant_vs_plain(torch, name, prec, kx, px, cx):
    """Checks :func:`variant_agrees` under ``name``; returns max |dx|."""
    ok, detail, err = variant_agrees(torch, prec, kx, px, cx)
    check(name, ok, detail)
    return err


# The variants' sharp check: one fixed iteration on 64 random QPs (n = 30,
# ``utils/qp_cases.random_qps``), before the iteration amplifies a
# reordered sum. Per precision, limits on the mean over lanes of each
# lane's max |dx| and on the max over all lanes, kernel against plain; the
# other precisions' kernels must lie beyond the mean limit from this
# precision's plain version, so the check tells "highest" from "bf16x3",
# the closest pair. ``tests/test_torch_iter_precision.py`` holds the
# limits between the plain version in another summation order and the
# other precisions, and shows a dropped cross term refused.
SHARP = {"bf16x3": (5e-6, 1e-4), "default": (1e-3, 1e-2)}
SHARP_SOLVER = dict(max_iter=1, check_every=1, eps_abs=0.0, eps_rel=0.0,
                    rescue_max_iter=0, polish=False, adaptive_rho=False,
                    use_pallas=True)

# At "default" each vector operand of an iteration product is rounded to
# bf16 once. Where a float32 sum lands near a bf16 rounding boundary,
# another summation order can round it the other way, and that one rounding
# moves the lane by one bf16 step pushed through the rest of the iteration
# (up to ~5e-2 on the random QPs, above the max limit). So at "default" a
# lane beyond the max limit from the plain version's x passes only if it
# lies within the mean limit of the plain version's x with one such
# rounding taken the other way: an operand whose float32 value lies within
# FLIP_MARGIN of a bf16 step from the boundary (60 other orders on the CPU
# moved no operand that moved x by more than 1e-3 across a boundary farther
# than 0.086 of a step from it). A lane moved by 1.5e-2 to 5e-2 in one
# coordinate, or in all, matches no such variant. The mean limit, and the
# other precisions' distance, stay against the plain x.
FLIP_MARGIN = 0.125


def bf16_other(t, h):
    """The bfloat16 neighbour of float32 ``t`` on the other side of ``t``
    from its rounding ``h`` (both float32; ``t != h``, same sign)."""
    import torch

    up = (t.abs() > h.abs()).to(torch.int32)
    return (h.view(torch.int32) + (2 * up - 1) * (1 << 16)).view(
        torch.float32)


class bf16_flips:
    """Inside the block ``cuda_qp.bf16`` records each (lanes, k) vector it
    rounds, in call order (``self.calls``), and rounds the elements of
    ``flips`` {call index: (lane indices, column indices)} to the other
    bf16 neighbour (:func:`bf16_other`). Matrices (the operands made once
    per call) are rounded as they are."""

    def __init__(self, cuda_qp, flips=None):
        self.mod, self.flips, self.calls = cuda_qp, flips or {}, []

    def __enter__(self):
        rnd = self.saved = self.mod.bf16

        def bf16(t):
            h = rnd(t)
            if t.dim() != 2:
                return h
            c = len(self.calls)
            self.calls.append(t.detach().clone())
            if c in self.flips:
                lanes, cols = self.flips[c]
                h = h.clone()
                h[lanes, cols] = bf16_other(t[lanes, cols], h[lanes, cols])
            return h

        self.mod.bf16 = bf16
        return self

    def __exit__(self, *exc):
        self.mod.bf16 = self.saved


def flip_candidates(t, h):
    """Mask of the elements of ``t`` (rounded to ``h``) within
    :data:`FLIP_MARGIN` of a bf16 step from their rounding boundary."""
    import torch

    ok = torch.isfinite(t) & (t != h) & (h != 0)
    o = torch.where(ok, bf16_other(t, h), h + 1.0)
    dist = (t - 0.5 * (h + o)).abs() / (o - h).abs()
    return ok & (dist <= FLIP_MARGIN)


def sharp_plain(cuda_qp, run_p, prec):
    """(px, flipped): the plain version's x at ``prec`` (``run_p`` from
    :func:`sharp_runs`) and, at "default", its x with one rounding taken
    the other way, one tensor per round (each round flips the r-th
    candidate of every lane that has one; :func:`flip_candidates`)."""
    if prec != "default":
        return run_p(prec), []
    with bf16_flips(cuda_qp) as rec:
        px = run_p(prec)
    cands = [[] for _ in range(px.shape[0])]
    for c, t in enumerate(rec.calls):
        mask = flip_candidates(t, cuda_qp.bf16(t))
        for lane, j in mask.nonzero().tolist():
            cands[lane].append((c, j))
    flipped = []
    for r in range(max(map(len, cands), default=0)):
        flips = {}
        for lane, cs in enumerate(cands):
            if r < len(cs):
                c, j = cs[r]
                flips.setdefault(c, ([], []))
                flips[c][0].append(lane)
                flips[c][1].append(j)
        with bf16_flips(cuda_qp, flips):
            flipped.append(run_p(prec))
    return px, flipped


def lane_dist(a, b):
    """(mean over lanes, max) of each lane's max |a - b|."""
    d = (a - b).abs().amax(-1)
    return float(d.mean()), float(d.max())


def sharp_agrees(prec, xs, px, flipped=()):
    """(ok, detail, max |dx|): ``xs`` {precision: kernel x}, ``px`` the
    plain version's x at ``prec``, after one iteration (:data:`SHARP`);
    ``flipped``: px with one bf16 rounding taken the other way
    (:func:`sharp_plain`); a lane beyond the max limit passes if it lies
    within the mean limit of one of them."""
    mean_l, max_l = SHARP[prec]
    kx = xs[prec]
    mean_e, max_e = lane_dist(kx, px)
    d = (kx - px).abs().amax(-1)
    far = (d >= max_l).nonzero()[:, 0].tolist()
    flip_d = [min((float((kx[i] - fx[i]).abs().max()) for fx in flipped),
                  default=float("inf")) for i in far]
    others = {o: lane_dist(x, px)[0] for o, x in xs.items() if o != prec}
    ok = (mean_e < mean_l and all(f < mean_l for f in flip_d)
          and min(others.values()) > mean_l)
    return ok, (f"(lane mean {mean_e:.2e} < {mean_l:.0e}, max {max_e:.2e} "
                f"against {max_l:.0e}, lanes at or beyond it within "
                f"{mean_l:.0e} of one of {len(flipped)} one-flip variants: "
                + (", ".join(f"lane {i} {f:.2e}" for i, f in zip(far, flip_d))
                   or "none")
                + "; other precisions' kernels at lane mean "
                + ", ".join(f"{o} {d:.2e}" for o, d in others.items())
                + f" > {mean_l:.0e})"), max_e


def sharp_runs(qp_mod, cuda_qp, cuda_qp_fused, kernel, layout=None,
               device="cuda"):
    """(kernel(prec), plain(prec)) -> x after one fixed iteration on the
    random QPs of :data:`SHARP`: B1 (``kernel="admm"``, in ``layout``) or
    B4 (``"fused_admm"``: its ADMM phase, against the plain loop on B4's
    own refreshed inverse, which does not depend on the precision)."""
    from racinglmpc_tpu_torch.utils.config import SolverConfig
    from racinglmpc_tpu_torch.utils.qp_cases import random_qps

    cfg = SolverConfig(**SHARP_SOLVER, pallas_fused_ns=kernel != "admm")
    qps = random_qps(64, device=device)
    if kernel == "admm":
        pro, kinv, _ = qp_mod.admm_inputs(qps, cfg)
        kw = qp_mod.kernel_args(pro, kinv, cfg)
        args = [kw.pop(nm) for nm in ADMM_NAMES]
        return (lambda prec: cuda_qp.admm_iterate(
                    *args, **dict(kw, iter_precision=prec),
                    layout=layout)[0],
                lambda prec: cuda_qp.admm_iterate_plain(
                    *args, **dict(kw, iter_precision=prec))[0])
    kw = qp_mod.fused_inputs(qps, cfg)
    args = [kw.pop(nm) for nm in FUSED_NAMES]
    a = dict(zip(FUSED_NAMES, args))
    k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
    return (lambda prec: cuda_qp_fused.admm_iterate_fused(
                *args, **dict(kw, iter_precision=prec)).x,
            lambda prec: cuda_qp.admm_iterate_plain(
                a["P"], k.kinv, a["A"], a["q"], a["l"], a["u"], a["rho"],
                a["D"], a["E"], a["c"], a["x0"], a["z0"], a["y0"],
                kinv_pad=k.kinv_pad, **dict(kw, iter_precision=prec))[0])


def sharp_check(qp_mod, cuda_qp, cuda_qp_fused, kernel, layout=None):
    """Checks :func:`sharp_agrees` for each variant of B1 (in ``layout``)
    or B4; returns {precision: max |dx|}."""
    run_k, run_p = sharp_runs(qp_mod, cuda_qp, cuda_qp_fused, kernel,
                              layout)
    xs = {prec: run_k(prec) for prec in cuda_qp.ITER_PRECISIONS}
    errs = {}
    for prec in VARIANTS:
        ok, detail, errs[prec] = sharp_agrees(
            prec, xs, *sharp_plain(cuda_qp, run_p, prec))
        tag = kernel + (f"_{layout}" if layout else "")
        check(f"{tag}_{prec}_one_iteration_random_qps", ok, detail)
    return errs


# at the solvers' tolerance a variant's kernel and plain version solve as
# many scenarios, in as many iterations, within these shares (of the batch
# and of the plain version's mean); the solved counts also within two
# scenarios, since each is a chaotic lane's outcome at the tolerance's edge
# (2 of 16 main-path FTOCPs apart at bf16x3 on the card)
TOLERANCE_SHARE = 0.02
TOLERANCE_SOLVES = 2


def tolerance_agrees(k_solved, k_iters, p_solved, p_iters):
    """(ok, detail): solved flags and iteration counts of a kernel and its
    plain version at tolerance, within :data:`TOLERANCE_SHARE`."""
    B = k_solved.numel()
    ks, ps = int(k_solved.sum()), int(p_solved.sum())
    km, pm = float(k_iters.float().mean()), float(p_iters.float().mean())
    ok = (abs(ks - ps) <= max(TOLERANCE_SHARE * B, TOLERANCE_SOLVES)
          and abs(km - pm) <= TOLERANCE_SHARE * pm)
    return ok, (f"(solved kernel {ks} plain {ps} of {B}, iters mean kernel "
                f"{km:.2f} plain {pm:.2f}; within {TOLERANCE_SHARE:.0%}, "
                f"solves also within {TOLERANCE_SOLVES})")


def b1_precisions(torch, qp_mod, cuda_qp, cuda_qp_fused, kernel_bench,
                  admm_args, solver, fac, rescue_cfg, check_every):
    """Phase 3, B1 at bf16x3 and default: the sharp check
    (:func:`sharp_check`) and against the plain version on the main path's
    FTOCPs in both layouts, two calls bit-identical, the forced rescue
    (full precision whatever the main loop's), solves and iterations at
    tolerance as the plain version's (:func:`tolerance_agrees`), and every
    precision's time (events around 20 back-to-back launches and device
    time) at 16 fixed iterations and at the main path's tolerance, in one
    loop. Returns the kernel entries (launches filled in by phase 9)."""
    times = {}
    for prec in cuda_qp.ITER_PRECISIONS:
        sp = dataclasses.replace(solver, pallas_iter_precision=prec)
        f_args, f_kw = admm_args(dataclasses.replace(
            sp, eps_abs=0.0, eps_rel=0.0, max_iter=16, check_every=16,
            rescue_max_iter=0), fac)
        t_args, t_kw = admm_args(sp, fac)
        names = ("admm_main", "admm_rescue")
        times[prec] = dict(
            fixed16_ms=kernel_bench.event_ms(
                lambda: cuda_qp.admm_iterate(*f_args, **f_kw)),
            fixed16_device_ms=kernel_bench.device_ms(
                lambda: cuda_qp.admm_iterate(*f_args, **f_kw), names),
            ms=kernel_bench.event_ms(
                lambda: cuda_qp.admm_iterate(*t_args, **t_kw)),
            device_ms=kernel_bench.device_ms(
                lambda: cuda_qp.admm_iterate(*t_args, **t_kw), names))
    print(f"[chip_smoke] B1 by iteration precision (ms per call, 20 "
          f"back-to-back launches; device: torch.profiler): {times}")
    sharp = [sharp_check(qp_mod, cuda_qp, cuda_qp_fused, "admm", lay)
             for lay in cuda_qp.LAYOUTS]
    entries = []
    for prec in VARIANTS:
        its = FIXED_ITERS[prec]
        sp = dataclasses.replace(solver, pallas_iter_precision=prec)
        f_args, f_kw = admm_args(dataclasses.replace(
            sp, eps_abs=0.0, eps_rel=0.0, max_iter=its, check_every=its,
            rescue_max_iter=0), fac)
        p = cuda_qp.admm_iterate_plain(*f_args, **f_kw)
        with float64_products(cuda_qp):
            c = cuda_qp.admm_iterate_plain(*f_args, **f_kw)
        errs = []
        for lay in cuda_qp.LAYOUTS:
            k = cuda_qp.admm_iterate(*f_args, **f_kw, layout=lay)
            errs.append(variant_vs_plain(
                torch, f"admm_{prec}_{lay}_fixed{its}_vs_plain", prec, k[0],
                p[0], c[0]))
            check(f"admm_{prec}_{lay}_same_bits_twice", all(
                bool(torch.equal(a, b)) for a, b in zip(
                    k, cuda_qp.admm_iterate(*f_args, **f_kw, layout=lay))))
        r_args, r_kw = admm_args(dataclasses.replace(
            rescue_cfg, pallas_iter_precision=prec), None)
        kr = cuda_qp.admm_iterate(*r_args, **r_kw)
        pr = cuda_qp.admm_iterate_plain(*r_args, **r_kw)
        same = float((kr[4] == pr[4]).float().mean())
        flags = bool((kr[6] == pr[6]).all())
        # the rescue starts from the main loop's iterates, which differ
        # between kernel and plain by the amplified order noise above: a
        # lane at a check may move by one chunk. At default the loop ends
        # NaN on some lanes, and a NaN residual does not exceed the trigger
        # (nor in the reference): those lanes are not rescued
        check(f"admm_{prec}_forced_rescue",
              flags and same >= 0.95
              and (prec == "default" or bool(kr[6].all())),
              f"(rescued kernel {int(kr[6].sum())} plain "
              f"{int(pr[6].sum())} of {kr[6].numel()}, flags equal "
              f"{flags}, iteration counts equal on {100 * same:.1f}% of "
              f"lanes)")
        t_args, t_kw = admm_args(sp, fac)
        k = cuda_qp.admm_iterate(*t_args, **t_kw)
        pt = cuda_qp.admm_iterate_plain(*t_args, **t_kw)
        ok, detail = tolerance_agrees(k[5], k[4], pt[5], pt[4])
        check(f"admm_{prec}_tolerance_as_plain", ok, detail)
        pms = time_ms(torch, lambda: cuda_qp.admm_iterate_plain(
            *t_args, **t_kw), reps=3, warm=1)
        B, n = t_args[3].shape
        f32, b16 = admm_ops(torch, t_args[0], t_args[2], n,
                            t_args[4].shape[1], k[4], t_kw["refine_steps"],
                            check_every, prec, t_kw["max_iter"])
        bms, by = bound_ms(nbytes(*t_args, *k[:5]), float(f32.sum()),
                           float(b16.sum()))
        print(f"[chip_smoke] kernel admm_{prec} (batch {B}): "
              f"{times[prec]['ms']:.4f} ms at tolerance (highest "
              f"{times['highest']['ms']:.4f}; device "
              f"{times[prec]['device_ms']}), "
              f"{times[prec]['fixed16_ms']:.4f} ms at 16 fixed iterations "
              f"(highest {times['highest']['fixed16_ms']:.4f}), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms by {by}; solved "
              f"{int(k[5].sum())}/{B}, iters mean "
              f"{float(k[4].float().mean()):.1f}, rescued {int(k[6].sum())}")
        entries.append(dict(
            name=f"admm_{prec}", route="cuda",
            source="racinglmpc_tpu_torch/csrc/cuda_qp.cu",
            replaces="racinglmpc_tpu/ops/pallas_qp.py:391", launches=None,
            max_abs_err=max(e[prec] for e in sharp),
            ftocp_max_abs_err=max(errs), ms=times[prec]["ms"],
            device_ms=times[prec]["device_ms"], plain_ms=pms, bound_ms=bms,
            bound_by=by, library_ms=None,
            fixed16_ms=times[prec]["fixed16_ms"],
            fixed16_device_ms=times[prec]["fixed16_device_ms"],
            highest_ms=times["highest"]["ms"],
            highest_device_ms=times["highest"]["device_ms"],
            highest_fixed16_ms=times["highest"]["fixed16_ms"],
            highest_fixed16_device_ms=times["highest"]["fixed16_device_ms"]))
    return entries


def b4_precisions(torch, qp_mod, cuda_qp, cuda_qp_fused, kernel_bench, f,
                  solver, stage):
    """Phase 6, B4 at bf16x3 and default on a stage's FTOCPs ``f``: its
    prologue gives the bits it gives at highest, its ADMM phase is held to
    the plain loop (B1's, ``cuda_qp.admm_iterate_plain``) on B4's own
    refreshed inverse and pad scalars as ``variant_vs_plain`` says, two
    calls are bit-identical, and every precision is timed at the stage
    solver's tolerance in one loop. Returns {prec: summary}."""
    times = {}
    for prec in cuda_qp.ITER_PRECISIONS:
        kw = qp_mod.fused_inputs(f.qp, dataclasses.replace(
            solver, pallas_iter_precision=prec), f.warm, f.fac)
        args = [kw.pop(nm) for nm in FUSED_NAMES]
        times[prec] = dict(
            ms=kernel_bench.event_ms(
                lambda: cuda_qp_fused.admm_iterate_fused(*args, **kw)),
            device_ms=kernel_bench.device_ms(
                lambda: cuda_qp_fused.admm_iterate_fused(*args, **kw),
                ("admm_fused", "admm_main", "admm_rescue")))
    print(f"[chip_smoke] B4 ({stage}) by iteration precision (ms per call, "
          f"20 back-to-back launches; device: torch.profiler): {times}")
    out = {}
    for prec in VARIANTS:
        its = FIXED_ITERS[prec]
        fixed = dataclasses.replace(
            solver, eps_abs=0.0, eps_rel=0.0, max_iter=its, check_every=its,
            rescue_max_iter=0, pallas_iter_precision=prec)
        kw = qp_mod.fused_inputs(f.qp, fixed, f.warm, f.fac)
        args = [kw.pop(nm) for nm in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        kh = cuda_qp_fused.admm_iterate_fused(
            *args, **dict(kw, iter_precision="highest"))
        check(f"fused_admm_{prec}_{stage}_prologue_bits_as_highest", all(
            bool(torch.equal(getattr(k, t), getattr(kh, t))) for t in (
                "kinv", "ns_resid", "kinv_pad", "warm", "ns_iters")))
        check(f"fused_admm_{prec}_{stage}_same_bits_twice", all(
            bool(torch.equal(a, b)) for a, b in zip(
                k, cuda_qp_fused.admm_iterate_fused(*args, **kw))))
        a = dict(zip(FUSED_NAMES, args))

        def loop():
            return cuda_qp.admm_iterate_plain(
                a["P"], k.kinv, a["A"], a["q"], a["l"], a["u"], a["rho"],
                a["D"], a["E"], a["c"], a["x0"], a["z0"], a["y0"],
                kinv_pad=k.kinv_pad, **kw)

        p = loop()
        with float64_products(cuda_qp):
            c = loop()
        err = variant_vs_plain(
            torch, f"fused_admm_{prec}_{stage}_fixed{its}_vs_plain", prec,
            k.x, p[0], c[0])
        kw = qp_mod.fused_inputs(f.qp, dataclasses.replace(
            solver, pallas_iter_precision=prec), f.warm, f.fac)
        args = [kw.pop(nm) for nm in FUSED_NAMES]
        k = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        pt = cuda_qp_fused.admm_iterate_fused_plain(*args, **kw)
        ok, detail = tolerance_agrees(k.solved, k.iters, pt.solved, pt.iters)
        check(f"fused_admm_{prec}_{stage}_tolerance_as_plain", ok, detail)
        pms = time_ms(torch, lambda: cuda_qp_fused.admm_iterate_fused_plain(
            *args, **kw), reps=3, warm=1)
        a = dict(zip(FUSED_NAMES, args))
        B, n = a["q"].shape
        m = a["l"].shape[1]
        # as phase 6 counts B4 at highest (K build, warm test and
        # Newton-Schulz in float32), the main loop's products in bf16
        row = (a["A"] != 0).sum(2).double()
        k_build = (2.0 * (row * row).sum(1) + (a["P"] != 0).sum((1, 2)) + n)
        f32, b16 = admm_ops(torch, a["P"], a["A"], n, m, k.iters,
                            kw["refine_steps"], solver.check_every, prec,
                            kw["max_iter"])
        ops = float((k_build + a["warm_ok"].double() * 2.0 * n ** 3
                     + k.ns_iters.double() * 4.0 * n ** 3 + f32).sum())
        bms, by = bound_ms(nbytes(*args, k.x, k.y, k.pri, k.dua, k.iters,
                                  k.kinv, k.ns_resid), ops, float(b16.sum()))
        print(f"[chip_smoke] kernel fused_admm_{prec} ({stage}, batch {B}): "
              f"{times[prec]['ms']:.4f} ms (highest "
              f"{times['highest']['ms']:.4f}; device "
              f"{times[prec]['device_ms']}, highest "
              f"{times['highest']['device_ms']}), plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms by {by}; solved {int(k.solved.sum())}/{B}, ADMM "
              f"iters mean {float(k.iters.float().mean()):.1f}, rescued "
              f"{int(k.rescued.sum())}")
        out[prec] = dict(ftocp_max_abs_err=err, ms=times[prec]["ms"],
                         device_ms=times[prec]["device_ms"], plain_ms=pms,
                         bound_ms=bms, bound_by=by,
                         highest_ms=times["highest"]["ms"],
                         highest_device_ms=times["highest"]["device_ms"])
    return out


def precision_paths(torch, main_path, cuda_qp, cuda_qp_fused, counters,
                    layouts, B, pid, steps=20, fused_steps=5):
    """Phase 9: the batch-256 main path at each lowered precision
    (``throughput()`` with ``pallas_iter_precision`` replaced), ``steps``
    steps after phase 2's PID seed ``pid``, and ``fused_steps`` with B4
    (``pallas_fused_ns``), counters reset just before each run and read
    just after. Gates: finite states and inputs, B1 (then B4) launched at
    that precision on every step, no scenario streamed; the rejected share
    is the card's verdict, not a gate. Returns the launches per kernel
    entry name."""
    from racinglmpc_tpu_torch.utils.config import SolverConfig

    launches = {}
    for prec in VARIANTS:
        solver = dataclasses.replace(SolverConfig.throughput(),
                                     pallas_iter_precision=prec)
        for fused, n_steps in ((False, steps), (True, fused_steps)):
            tag = f"main_path_{'fused_' if fused else ''}{prec}"
            mp, state, plant, _ = main_path.setup(
                B, solver=dataclasses.replace(solver, pallas_fused_ns=fused),
                pid=pid)
            plist = (cuda_qp.precision_launches,
                     cuda_qp_fused.precision_launches)
            for c in (*counters, *layouts, *(q for d in plist
                                            for q in d.values())):
                c.reset()
            torch.cuda.synchronize()
            t0 = time.time()
            ch = main_path.run_chunk(mp, state, plant, n_steps)
            torch.cuda.synchronize()
            wall = time.time() - t0
            lay = {c.name: count(c) for c in layouts}
            it = ch.iters.float().cpu()
            solves = B * n_steps
            k_name = "fused_admm" if fused else "admm"
            mod = cuda_qp_fused if fused else cuda_qp
            n_prec = mod.precision_launches[prec].n
            launches[f"{k_name}_{prec}"] = n_prec
            print(f"[chip_smoke] {tag}: {solves / wall:.1f} solves/s (batch "
                  f"{B}, {n_steps} steps in {wall:.3f} s), rejected "
                  f"{int(ch.rejected)} of {solves} "
                  f"({100 * int(ch.rejected) / solves:.2f}%), not at "
                  f"tolerance {int(ch.unsolved)}, ADMM iters mean "
                  f"{float(it.mean()):.2f} p50 {float(it.quantile(0.5)):.0f} "
                  f"p99 {float(it.quantile(0.99)):.0f}, {k_name} launches "
                  f"at {prec} {n_prec}, all {k_name} {mod.launches.n}, "
                  f"layouts and streamed {lay}")
            check(f"{tag}_finite", bool(torch.isfinite(ch.plant.x).all())
                  and bool(torch.isfinite(ch.state.u_old).all()))
            other = cuda_qp.launches.n if fused else \
                cuda_qp_fused.launches.n
            check(f"{tag}_{k_name}_every_step",
                  n_prec == n_steps and other == 0, f"({n_prec})")
            check(f"{tag}_no_scenario_streamed",
                  lay["admm_stream"] == 0 and lay["admm_streamed"] == 0
                  and lay["fused_admm_streamed"] == 0, f"({lay})")
    return launches


def gate_phase(torch, bench, mp, pid, counters, layouts, B, steps):
    """Phase 10: the bench's quality gate at its defaults on the main
    path's preset, with B1-B3 launched in it and no scenario streamed;
    the ``throughput_max()`` secondary; and the converged phase again at
    the round-3 preset (``rescue_max_iter=0``), which must fail it."""
    def log(m):
        print(f"[chip_smoke]   {m}", flush=True)

    pid_lap = (pid.pid.x[0], pid.pid.u[0], pid.pid.x_glob[0],
               pid.pid.steps[0])
    for c in counters + layouts:
        c.reset()
    t0 = time.time()
    trace = []
    q = bench.quality_gate(mp.cfg, mp.trk, mp.vp, pid_lap, log=log,
                           conv_trace=trace)
    lay = {c.name: count(c) for c in layouts}
    launches = {c.name: c.n for c in counters}
    print(f"[chip_smoke] quality gate ({time.time() - t0:.1f} s, batch "
          f"{q['batch']}): {json.dumps(q)}; launches {launches}, B1 layouts "
          f"and streamed scenarios {lay}")
    where = unconverged_where(torch, trace, float(mp.trk.total_len),
                              mp.cfg.solver.max_iter)
    print(f"[chip_smoke] converged phase's solves not at tolerance (ROADMAP "
          f"C9): {where}")
    check("quality_gate_pass", q["pass"],
          f"({[k for k, v in q.items() if v is False]} failed)")
    check("quality_gate_used_kernels",
          all(launches[k] > 0 for k in ("admm", "sysid", "rollout")),
          f"({launches})")
    check("quality_gate_no_scenario_streamed",
          lay["admm_stream"] == 0 and lay["admm_streamed"] == 0, f"({lay})")

    t0 = time.time()
    try:
        sec = bench.secondary(B, steps, pid, log=log)
        print(f"[chip_smoke] throughput_max secondary: "
              f"{sec.solves_per_s:.1f} solves/s (batch {B}, best of "
              f"{[round(t, 3) for t in sec.rep_s]} s), ADMM iters mean "
              f"{float(sec.iters.mean()):.2f}, rejected {sec.rejected}, "
              f"each timed chunk's counts {sec.counts} "
              f"({time.time() - t0:.1f} s)")
        check("secondary_runs_on_the_kernels", True)
    except Exception as e:  # noqa: BLE001 - the bench's max_preset_error
        traceback.print_exc()
        check("secondary_runs_on_the_kernels", False,
              f"({type(e).__name__}: {e})")

    t0 = time.time()
    cfg3 = dataclasses.replace(mp.cfg, solver=dataclasses.replace(
        mp.cfg.solver, rescue_max_iter=0))
    (c_steps, c_rej, c_unc), seed_mean = bench.converged_laps(
        cfg3, mp.trk, mp.vp, log=log)
    crit = bench.converged_criteria(c_steps, c_rej, c_unc, q["batch"],
                                    seed_mean)
    failing = [k for k in bench.CONV_KEYS if not crit[k]]
    print(f"[chip_smoke] round-3 preset (rescue_max_iter=0), converged "
          f"phase ({time.time() - t0:.1f} s): {json.dumps(crit)}")
    check("round3_preset_fails_the_gate", bool(failing),
          f"(failing: {failing})")


# the record the reference's float32 controller set on the 40-lap
# criterion (lap step counts of its TPU run; no time of it is used here)
QUALITY_RECORD = "BENCH_solver_quality_40lap_tpu.json"
QUALITY_LAPS = 40
REJECTED_SHARE = 0.005      # the gate's own limit on rejected solves


def quality_laps(torch, device, laps=QUALITY_LAPS, solver=None,
                 dtype=None, lcfg=None, log=None, hook=None):
    """The 40-lap criterion's run (phase 11; ``device="cpu"`` runs the
    kernels' plain versions): the port's controller, by default the
    criterion's own configuration, the ``throughput()`` solver in float32
    with ``LMPCConfig()`` (B1 engaged; B2 not, by the reference's rule:
    ``use_pallas_sysid`` is off, as in the record's run), through the
    float64 NumPy plant of ``tests/oracles/ref_plant.py`` with the
    committed draws (``runtime/solver_quality``; ``hook`` as its
    ``run_laps``'). Returns (laps, fixture, wall s)."""
    from racinglmpc_tpu_torch.models.track import make_track
    from racinglmpc_tpu_torch.runtime import solver_quality as sq
    from racinglmpc_tpu_torch.utils.config import LMPCConfig, SolverConfig

    dtype = dtype or torch.float32
    cpu = torch.device(device).type == "cpu"
    solver = solver or dataclasses.replace(SolverConfig.throughput(),
                                           pallas_interpret=cpu)
    lcfg = lcfg or LMPCConfig()
    ref_plant = load_oracle("ref_plant")
    fx = sq.load_fixture()
    curv = ref_plant.np_curvature_fn(make_track(dtype=torch.float64,
                                                device="cpu"))
    t0 = time.time()
    out = sq.run_laps(make_track(dtype=dtype, device=device),
                      ref_plant.plant_step, curv, fx, laps, solver,
                      dtype=dtype, lcfg=lcfg, device=device,
                      log=log or (lambda _m: None), hook=hook)
    return out, fx, time.time() - t0


class SysidShadow:
    """A :func:`quality_laps` hook: on every step, B2 against its
    plain version on that step's store and horizon (the sys-ID the step
    is about to run). Keeps the largest |dA|, |dB|, |dC| (``max_abs``),
    that relative to the plain version's largest entry and the step it
    came at (``worst``), and per entry of A, B, C (summed over the
    horizon) the signed differences, the plain version's magnitudes and
    how often the kernel lies above: a kernel that rounds alike leaves no
    entry with a steady sign (:meth:`bias`)."""

    def __init__(self, cuda_sysid):
        self.mod, self.t = cuda_sysid, 0
        self.worst, self.calls, self.n = (0.0, None), 0, 1
        self.max_abs = 0.0
        self.diff = self.mag = self.above = None

    def __call__(self, ctrl, state, x):
        self.t += 1
        N = self.n = ctrl.cfg.N
        args = (state.store, ctrl.trk, state.x_lin[:, :N].contiguous(),
                state.u_lin.contiguous(), ctrl.cfg, ctrl.dt_ctrl)
        k = self.mod.local_linearization_horizon(*args, table=ctrl.table)
        p = self.mod.local_linearization_horizon_plain(*args)
        rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  for a, b in zip(k, p))
        self.max_abs = max([self.max_abs] + [float((a - b).abs().max())
                                             for a, b in zip(k, p)])
        d = [(a - b).double().sum((0, 1)).flatten().cpu()
             for a, b in zip(k, p)]
        m = [b.double().abs().sum((0, 1)).flatten().cpu() for b in p]
        up = [((a > b).double().sum((0, 1)) - (a < b).double().sum((0, 1)))
              .flatten().cpu() for a, b in zip(k, p)]
        if self.diff is None:
            self.diff, self.mag, self.above = d, m, up
        else:
            for acc, new in ((self.diff, d), (self.mag, m), (self.above, up)):
                for i, t in enumerate(new):
                    acc[i] = acc[i] + t
        self.calls += 1
        if rel >= self.worst[0]:
            self.worst = (rel, self.t - 1)

    def bias(self, top=4):
        """The ``top`` entries by |summed difference| over summed plain
        magnitude: (output, entry, that ratio, (above - below) / samples),
        the two ratios to 3 significant digits."""
        rows = []
        for name, d, m, up in zip("ABC", self.diff, self.mag, self.above):
            for e in range(d.numel()):
                if float(m[e]) > 0:
                    ratio = float(d[e] / m[e])
                    sign = float(up[e]) / (self.calls * self.n)
                    rows.append((name, e, float(f"{ratio:.3g}"),
                                 float(f"{sign:.3g}")))
        return sorted(rows, key=lambda r: -abs(r[2]))[:top]


class Nudge:
    """A :func:`quality_laps` hook that moves the controller's view of the
    state one float32 ulp up in component ``i`` at step ``t`` (the plant
    keeps its float64 state): how far the 40-lap criterion moves under the
    smallest change the controller can see."""

    def __init__(self, torch, t, i):
        self.torch, self.at, self.i, self.t = torch, t, i, 0

    def __call__(self, ctrl, state, x):
        if self.t == self.at:
            v = x[0, self.i]
            x[0, self.i] = self.torch.nextafter(v, v + 1)
        self.t += 1


# the one-ulp nudges of the triage (step, state component): with the
# unnudged run, 16 draws a configuration
NUDGES = ((0, 0), (1000, 4), (2000, 5), (500, 1), (1500, 2), (2500, 3),
          (250, 0), (750, 1), (1250, 2), (1750, 3), (2250, 4), (2750, 5),
          (100, 5), (3000, 0), (1100, 3))
# worker processes of the triage at once (one card, eight CPU cores)
TRIAGE_WORKERS = 8


def quality_draw(torch, b2, nudge):
    """One draw of the triage (``--quality-draw B2 STEP COMPONENT``, a
    worker process): phase 11's run with B2 engaged or not, nudged by
    :class:`Nudge` unless STEP is -1, and with B2 engaged held against its
    plain version on every step (:class:`SysidShadow`); one JSON line."""
    from racinglmpc_tpu_torch.ops import cuda_sysid
    from racinglmpc_tpu_torch.runtime import solver_quality as sq
    from racinglmpc_tpu_torch.utils.config import LMPCConfig

    hook = (Nudge(torch, *nudge) if nudge[0] >= 0
            else SysidShadow(cuda_sysid) if b2 else None)
    r, fx, wall = quality_laps(torch, "cuda",
                               lcfg=LMPCConfig(use_pallas_sysid=b2),
                               hook=hook)
    line = dict(b2=b2, nudge=list(nudge), steps=r.steps,
                total=sum(r.steps), **sq.summary(r.steps, fx.oracle),
                rerun=sq.summary(r.steps, fx.oracle_rerun),
                rejected=sum(r.rejected), unconverged=sum(r.unconverged),
                wall_s=wall)
    if isinstance(hook, SysidShadow):
        line["shadow"] = dict(samples=hook.calls, max_abs=hook.max_abs,
                              worst=hook.worst, bias=hook.bias())
    print(json.dumps(line), flush=True)


def rank_sum_z(a, b):
    """Mann-Whitney's normal approximation: how far ``a``'s rank sum in
    ``a + b`` lies above its mean under no difference, in standard
    deviations (ties share their mean rank)."""
    vals = sorted(a + b)
    rank = {v: sum(i + 1 for i, w in enumerate(vals) if w == v)
            / vals.count(v) for v in vals}
    n, m = len(a), len(b)
    return ((sum(rank[v] for v in a) - n * (n + m + 1) / 2)
            / (n * m * (n + m + 1) / 12) ** 0.5)


def quality_triage(torch):
    """``python3 chip_smoke.py --quality-triage``: how far the 40-lap
    criterion moves with float32's rounding on the card. For B2 engaged
    (``use_pallas_sysid``) and not (the plain sys-ID), the run itself and
    one :class:`Nudge` run per entry of :data:`NUDGES`, each in a worker
    process (:func:`quality_draw`), :data:`TRIAGE_WORKERS` at once; one
    JSON line a draw, then per configuration the cumulative differences
    (% of the record's oracle) and the draws within 1%, and the rank-sum z
    of B2 engaged against not."""
    import subprocess

    from racinglmpc_tpu_torch.ops import cuda_build

    cuda_build.build()
    jobs = [(b2, nudge) for b2 in (True, False)
            for nudge in ((-1, 0),) + NUDGES]
    running, lines = [], []

    def reap(p):
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"a triage draw exited {p.returncode}")
        lines.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)

    try:
        for b2, (t, i) in jobs:
            if len(running) == TRIAGE_WORKERS:
                reap(running.pop(0))
            running.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()),
                 "--quality-draw", str(int(b2)), str(t), str(i)],
                stdout=subprocess.PIPE, text=True))
        while running:
            reap(running.pop(0))
    finally:
        for p in running:
            p.kill()
            p.wait()
    pct = {b2: [ln["total_rel_diff_pct"] for ln in lines if ln["b2"] == b2]
           for b2 in (True, False)}
    for b2, v in pct.items():
        print(json.dumps(dict(
            b2=b2, draws=len(v), within_1pct=sum(x <= 1 for x in v),
            median=statistics.median(v), mean=statistics.fmean(v),
            pct=sorted(v))), flush=True)
    print(json.dumps(dict(rank_sum_z_b2_engaged=rank_sum_z(pct[True],
                                                           pct[False]))))


def quality_phase(torch, counters, layouts):
    """Phase 11: :func:`quality_laps` on the card in the criterion's own
    configuration (the reference's: B1 drives the QP, the plain sys-ID the
    linearization), its counters reset just before and read just after;
    the criterion: cumulative lap steps within 1% of the oracle's
    (``solver_quality.CRITERION``), the record's and the rerun's, every
    lap under 1000 steps, no NaN, rejected <= 0.5%, B1 once a step, 0
    streamed; and B2 launched on every step's sys-ID inputs and held
    against the plain version the step runs (:class:`SysidShadow`) within
    phase 3's 1e-3, once a step."""
    from racinglmpc_tpu_torch.ops import cuda_sysid
    from racinglmpc_tpu_torch.runtime import solver_quality as sq

    shadow = SysidShadow(cuda_sysid)
    for c in counters + layouts:
        c.reset()
    r, fx, wall = quality_laps(torch, "cuda", hook=shadow)
    launches = {c.name: c.n for c in counters}
    lay = {c.name: count(c) for c in layouts}
    rec = json.loads((pathlib.Path(__file__).resolve().parent
                      / QUALITY_RECORD).read_text())["presets"]
    tpu = rec["throughput_f32"]["lap_steps"]
    n = sum(r.steps)
    summ = sq.summary(r.steps, fx.oracle)
    rerun = sq.summary(r.steps, fx.oracle_rerun)
    print(f"[chip_smoke] 40-lap criterion ({wall:.1f} s, {n} steps, "
          f"{1e3 * wall / n:.2f} ms a step): lap, port float32 on the "
          f"card, float64 oracle (the record's; the rerun's, "
          f"{fx.rerun_env}), the reference's float32 controller "
          f"({QUALITY_RECORD}, throughput_f32):")
    for lap, row in enumerate(zip(r.steps, fx.oracle, fx.oracle_rerun,
                                  tpu)):
        print(f"[chip_smoke]   lap {lap}: {' '.join(map(str, map(int, row)))}"
              f" (rejected {r.rejected[lap]}, unconverged "
              f"{r.unconverged[lap]}, iters p99 {r.iters_p99[lap]})")
    line = dict(steps=n, oracle_steps=int(fx.oracle.sum()),
                oracle_rerun_steps=int(fx.oracle_rerun.sum()), **summ,
                rerun=rerun, rejected_rate=sum(r.rejected) / n,
                unconverged_rate=sum(r.unconverged) / n, wall_s=wall,
                launches=launches, layouts=lay)
    print(f"[chip_smoke] 40-lap criterion: {json.dumps(line)}")
    check("quality40_kernels_once_a_step",
          launches["admm"] == n and launches["sysid"] == shadow.calls == n
          and lay["admm_stream"] == 0 and lay["admm_streamed"] == 0,
          f"({n} steps, {shadow.calls} sys-ID comparisons; {launches}, "
          f"{lay})")
    check("quality40_sysid_vs_plain", shadow.max_abs < 1e-3,
          f"(every step, {shadow.calls} calls: max "
          f"|dA|,|dB|,|dC| {shadow.max_abs:.2e}, relative "
          f"{shadow.worst[0]:.2e} at step {shadow.worst[1]}; steadiest "
          f"entries {shadow.bias()})")
    check("quality40_laps_finished", len(r.steps) == QUALITY_LAPS
          and max(r.steps) < sq.MAX_STEPS, f"(longest {max(r.steps)})")
    check("quality40_finite", r.finite)
    check("quality40_rejected", sum(r.rejected) <= REJECTED_SHARE * n,
          f"({sum(r.rejected)} of {n})")
    check("quality40_within_1pct_of_oracle",
          max(summ["total_rel_diff_pct"], rerun["total_rel_diff_pct"])
          <= 100 * sq.CRITERION,
          f"(cumulative {summ['total_rel_diff_pct']:.4f}% of the record's, "
          f"{rerun['total_rel_diff_pct']:.4f}% of the rerun's; last lap "
          f"{summ['final_lap_rel_diff_pct']:.4f}%, "
          f"{rerun['final_lap_rel_diff_pct']:.4f}%)")


# C6's regime: the solves within this distance of the finish line (m)
FINISH_LINE_M = 1.5


def unconverged_where(torch, trace, track_len, max_iter):
    """Where a gate phase's solves not at tolerance sit
    (``bench.gate_laps``' ``trace``): by the arc length left to the finish
    line, in bins of 1 m (solves, of which not at tolerance), how many lie
    within :data:`FINISH_LINE_M`, and their ADMM iterations (mean, p50,
    p99, at max_iter, past it: rescued)."""
    s, it, unc = (torch.cat([t[k] for t in trace]) for k in range(3))
    left = track_len - s.double()
    bins = torch.clamp(left.floor().long(), min=0)
    rows = {f"{k}-{k + 1} m": (int((bins == k).sum()),
                               int(((bins == k) & unc).sum()))
            for k in range(int(bins.max()) + 1) if bool((bins == k).any())}
    n = int(unc.sum())
    near = int((unc & (left < FINISH_LINE_M)).sum())
    iu = it[unc].float()
    its = ({} if n == 0 else dict(
        mean=round(float(iu.mean()), 2), p50=float(iu.quantile(0.5)),
        p99=float(iu.quantile(0.99)),
        at_max_iter=int((iu == max_iter).sum()),
        rescued=int((iu > max_iter).sum())))
    return json.dumps(dict(
        solves=int(unc.numel()), not_at_tolerance=n,
        within_finish_line=near, within_m=FINISH_LINE_M,
        by_m_to_line_solves_and_not_at_tolerance=rows, iters=its))


def load_oracle(name: str):
    """``tests/oracles/<name>.py`` of this checkout, loaded from its path
    (an installed package named ``tests`` would shadow the directory)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "tests" / "oracles" \
        / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_oracle_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pid_lap(trk):
    """One noise-free PID lap of the float64 NumPy plant (the lap of
    ``tests/test_giant_ftocp.py``): (x (T, 6), u (T, 2)). ``trk`` on the
    CPU."""
    import numpy as np

    ref_plant = load_oracle("ref_plant")

    curv = ref_plant.np_curvature_fn(trk)
    L = float(trk.total_len)
    x = np.array([0.5, 0, 0, 0, 0, 0.0])
    g = x.copy()
    xs, us = [], []
    for _ in range(420):
        u = np.array([-0.6 * x[5] - 0.9 * x[3], 1.5 * (0.8 - x[0])])
        xs.append(x.copy())
        us.append(u.copy())
        x, g = ref_plant.plant_step(x, g, u, curv)
        if x[4] > L:
            break
    return np.asarray(xs), np.asarray(us)


def mesh_phase(torch, exp, loop_cfg, loop_steps, trk, counters, layouts):
    """Phase 8 (a): the one-rank NCCL mesh runs phase 4's LMPC run."""
    import torch.distributed as dist

    from racinglmpc_tpu_torch.parallel import cross_scenario_metrics, make_mesh

    mesh = make_mesh()
    check("mesh_is_one_rank_nccl_on_the_card",
          dist.get_backend() == "nccl" and mesh.size == 1
          and mesh.device.type == "cuda", f"({mesh})")
    for c in counters + layouts:
        c.reset()
    t0 = time.time()
    res = exp.run_experiment(loop_cfg, batch=4, stages="pid,lmpc", trk=trk,
                             seed=0, mesh=mesh)
    torch.cuda.synchronize()
    launches = {c.name: count(c) for c in counters + layouts}
    walls = {k: round(v, 3) for k, v in res.stage_wall_s.items()}
    print(f"[chip_smoke] mesh run (one NCCL rank, {time.time() - t0:.1f} s, "
          f"stage walls {walls} s, lap walls "
          f"{[round(float(v), 3) for v in res.lap_wall_s]} s): lap steps "
          f"{res.lap_steps.tolist()} (phase 4 {loop_steps.tolist()}), "
          f"launches {launches}")
    check("mesh_run_equals_phase4", res.lap_steps.shape == loop_steps.shape
          and bool((res.lap_steps == loop_steps).all()))
    check("mesh_run_launched_b1_b2_b3",
          all(launches[k] > 0 for k in ("admm", "sysid", "rollout")),
          f"({launches})")
    check("mesh_run_no_scenario_streamed",
          launches["admm_stream"] == 0 and launches["admm_streamed"] == 0)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    vals = torch.rand(256, generator=g, device="cuda")
    met = cross_scenario_metrics(vals, mesh)
    rel = abs(float(met["mean"]) - float(vals.mean())) / float(vals.mean())
    print(f"[chip_smoke] cross_scenario_metrics over NCCL: "
          f"{ {k: float(v) for k, v in met.items()} }, torch mean "
          f"{float(vals.mean())} (rel {rel:.2e})")
    check("cross_scenario_metrics_equal_torch",
          rel < 1e-6 and bool(met["min"] == vals.min())
          and bool(met["max"] == vals.max()))
    return mesh


def giant_phase(torch, np, exp):
    """Phase 8 (b), (c): the giant FTOCP through the sharded solver on a
    one-rank NCCL mesh (the group phase 8 (a) made)."""
    from racinglmpc_tpu_torch.controllers import giant_ftocp
    from racinglmpc_tpu_torch.models.track import make_track
    from racinglmpc_tpu_torch.ops import qp_sharded
    from racinglmpc_tpu_torch.parallel import make_mesh
    from racinglmpc_tpu_torch.utils.config import LMPCConfig

    qp_ip = load_oracle("qp_ip")
    bmesh = make_mesh(axis_name=qp_sharded.BLOCK_AXIS)
    xs, us = pid_lap(make_track(dtype=torch.float64, device="cpu"))
    print(f"[chip_smoke] giant FTOCP lap: {len(xs)} steps (float64 NumPy "
          f"PID lap)")

    def build(N, dtype, x, u, steps):
        t0 = time.time()
        g = giant_ftocp.assemble_giant_ftocp(
            make_track(dtype=dtype, device="cuda"), x, u, steps, N=N, K=48,
            cfg=LMPCConfig(), dtype=dtype)
        torch.cuda.synchronize()
        return g, time.time() - t0

    def solve(g, cfg, graph=True):
        torch.cuda.synchronize()
        t0 = time.time()
        sol = qp_sharded.solve_sharded(g.qp, bmesh, cfg, graph=graph)
        torch.cuda.synchronize()
        return sol, time.time() - t0

    # (b) N = 40, float64, against the interior-point oracle
    g, t_asm = build(40, torch.float64, torch.from_numpy(xs).cuda(),
                     torch.from_numpy(us).cuda(), len(xs))
    sol, wall = solve(g, qp_sharded.ShardedSolverConfig(
        max_iter=4000, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10,
        cg_max_iter=500))
    H, q, A, l, u = (t[0].cpu().numpy() for t in g.qp)
    eq = np.isfinite(l) & (u - l < 1e-12)
    z_ref, *_, ok = qp_ip.solve_qp(H, q, A[eq], u[eq], A[~eq], u[~eq])
    x = sol.x.cpu().numpy()

    def obj(z):
        return 0.5 * z @ H @ z + q @ z

    gap = abs(obj(x) - obj(z_ref)) / max(abs(obj(z_ref)), 1.0)
    feas = max(float((A @ x - u).max()), float((l - A @ x).max()))
    d = g.dims
    lam = x[d.off_lambda:d.off_lambda + d.K]
    print(f"[chip_smoke] giant N=40 float64 (n {d.nz}, m {A.shape[0]}): "
          f"assembly {t_asm:.2f} s, solve {wall:.2f} s, solved "
          f"{bool(sol.solved)}, iters {int(sol.iters)}, cg {int(sol.cg_iters)}"
          f", pri {float(sol.pri_res):.3e}, dua {float(sol.dua_res):.3e}; "
          f"oracle converged {ok}, objective gap {gap:.3e}, feasibility "
          f"{feas:.3e}, sum(lambda) {lam.sum():.9f}, min {lam.min():.3e}")
    check("giant_n40_float64_matches_oracle",
          ok and bool(sol.solved) and gap < 1e-6 and feas < 1e-6
          and abs(lam.sum() - 1.0) < 1e-5 and lam.min() > -1e-6)
    # the CG iteration replayed as a CUDA graph against its operations
    # launched one by one: one check chunk, the same bits
    short = qp_sharded.ShardedSolverConfig(
        max_iter=25, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10,
        cg_max_iter=500, polish=False)
    s_g, w_g = solve(g, short)
    s_e, w_e = solve(g, short, graph=False)
    cg = int(s_g.cg_iters)
    print(f"[chip_smoke] giant N=40 CG loop, {cg} iterations: CUDA graph "
          f"{w_g:.3f} s ({w_g / cg * 1e6:.1f} us an iteration), one by one "
          f"{w_e:.3f} s ({w_e / max(int(s_e.cg_iters), 1) * 1e6:.1f} us)")
    check("giant_cg_graph_equals_eager",
          cg == int(s_e.cg_iters) and bool(torch.equal(s_g.x, s_e.x)))

    # (c) N = 512, float32: the full width, on a lap of the port's own PID
    # stage (420 steps, PID and plant noise on, as the reference's sharded
    # dry run takes it): the noise-free lap's repeated features leave some
    # of the float32 5x5 regressions singular, in the reference as here
    pid = exp.run_experiment(exp.ExperimentConfig(stage_steps=420), batch=1,
                             stages="pid", seed=0)
    g, t_asm = build(512, torch.float32, pid.pid.x[0], pid.pid.u[0],
                     int(pid.pid.steps[0]))
    d = g.dims
    m = g.qp.A.shape[1]
    blk = qp_sharded.local_blocks(g.qp, bmesh)
    mb = (blk.P_l.numel() + blk.A_l.numel()) * blk.P_l.element_size() / 1e6
    del blk
    sol, wall = solve(g, qp_sharded.ShardedSolverConfig(max_iter=500))
    x = sol.x
    lam = x[d.off_lambda:d.off_lambda + d.K]
    pri = float(sol.pri_res)
    print(f"[chip_smoke] giant N=512 float32 (n {d.nz}, m {m}): assembly "
          f"{t_asm:.2f} s, solve {wall:.2f} s, solved {bool(sol.solved)}, "
          f"iters {int(sol.iters)}, cg {int(sol.cg_iters)}, pri {pri:.3e}, "
          f"dua {float(sol.dua_res):.3e}, sum(lambda) "
          f"{float(lam.sum()):.6f}, min(lambda) {float(lam.min()):.3e}, "
          f"rank block {mb:.1f} MB")
    check("giant_n512_dims", (d.nz, m) == (5180, 7229), f"({d.nz}, {m})")
    check("giant_n512_float32_solution",
          bool(torch.isfinite(x).all()) and pri <= 1e-2
          and abs(float(lam.sum()) - 1.0) <= pri)


# The inverses' floors: the float64 true residual max|I - K X| of a float32
# inverse on the first FLOOR_LANES lanes. The kernel path's inverse (the
# torch prologue's Newton-Schulz, its final squaring's products in float64)
# must land below the reference's float32 floor on the TPU, ~3e-4 on the
# main path's FTOCPs (``racinglmpc_tpu/ops/qp.py:287-295``): B1's
# iteration tail follows that residual (ROADMAP C6).
FLOOR_LANES = 8
REFERENCE_FLOOR = 3e-4


def true_residual(torch, K, X):
    """max|I - K X| per lane, both in float64."""
    K, X = K.double(), X.double()
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (eye - K @ X).abs().amax((1, 2))


def floor_text(r):
    return (f"mean {float(r.mean()):.3e} max {float(r.max()):.3e} "
            f"{[float(f'{v:.3e}') for v in r.tolist()]}")


def b1_inverse_floor(torch, qp_mod, ctrl, chunk, solver):
    """The float64 true residual of the inverse the kernel path hands B1 at
    the step after ``chunk`` (``admm_inputs``, as ``qp.solve`` makes it),
    on the first ``FLOOR_LANES`` lanes; also the K and inverse of the
    whole batch."""
    st = chunk.state
    qp = ctrl.build_qp(st, chunk.plant.x)[0]
    pro, kinv, _ = qp_mod.admm_inputs(qp, solver, (st.warm_x, st.warm_y),
                                      st.fac)
    K = qp_mod._build_K(pro.qp_s, pro.rho0, solver.sigma)
    return true_residual(torch, K[:FLOOR_LANES], kinv[:FLOOR_LANES]), K, kinv


def squaring_ms(torch, K, X):
    """CUDA-event ms of the final Newton-Schulz squaring X + X (I - K X) on
    the batch's K and X: as the port computes it for float32 K (both
    products in float64, X rounded back once, the casts included) and in
    float32 (the reference's form)."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    Kd, Xd = K.double(), X.double()
    eye32 = eye.float()

    def port():
        K64, X64 = K.double(), X.double()
        return (X64 + X64 @ (eye - K64 @ X64)).float()

    return dict(
        float64=time_ms(torch, port),
        float32=time_ms(torch, lambda: X + X @ (eye32 - K @ X)),
        float64_products_only=time_ms(torch, lambda: Xd @ (eye - Kd @ Xd)))


def inverse_floors(torch, qp_mod, cuda_qp, cuda_qp_fused, qp, warm, fac,
                   solver):
    """Phase 3: the float64 true residuals, on the first ``FLOOR_LANES``
    lanes of the main path's FTOCPs, of the two float32 inverses the
    kernels build themselves (phase 2 prints the one the prologue hands
    B1): B1's in-kernel rescue inverse (every lane rescued:
    ``rescue_trigger`` 0, K2 at the main path's rho times
    ``rescue_rho_scale``; read from the rescue's workspace) and B4's
    prologue (``pallas_fused_ns``)."""
    L = FLOOR_LANES
    pro, kinv, _ = qp_mod.admm_inputs(qp, solver, warm, fac)
    out = {}
    rescue = dataclasses.replace(solver, rescue_trigger=0.0)
    kw = qp_mod.kernel_args(pro, kinv, rescue)
    args = [kw.pop(n) for n in ("P", "Kinv", "A", "q", "l", "u", "rho", "D",
                                "E", "c", "x0", "z0", "y0")]
    Bsz, n = kinv.shape[0], kinv.shape[1]
    ws = torch.zeros((Bsz, 4, n, n), dtype=torch.float32, device=kinv.device)
    rescued = cuda_qp.admm_iterate(*args, **kw, workspace=ws)[6][:L]
    P, A, rho = (t[:L].double() for t in (args[0], args[2], args[6]))
    eye = torch.eye(n, dtype=torch.float64, device=kinv.device)
    K2 = (P + solver.sigma * eye + solver.rescue_rho_scale
          * A.transpose(1, 2) @ (A * rho[:, :, None]))
    out["b1_rescue"] = true_residual(torch, K2, ws[:L, 0])
    out["b1_rescue_lanes_rescued"] = int(rescued.sum())

    fused = dataclasses.replace(solver, pallas_fused_ns=True)
    fpro = qp_mod._prologue(qp, fused, warm, fac)
    r = cuda_qp_fused.admm_iterate_fused(**qp_mod.fused_args(fpro, fused))
    K1 = qp_mod._build_K(fpro.qp_s, fpro.rho0, solver.sigma)
    out["b4_prologue"] = true_residual(torch, K1[:L], r.kinv[:L])
    return out


# the float32 check's own rounding against its float64 recompute: <= 7.6e-6
# of the dual residual on the main path's FTOCPs (the plain version, CPU)
SOUND_MARGIN = 1e-3


def unsound_lanes(torch, args, kw, out):
    """Lanes that ``out`` (an ``admm_iterate`` result on ``args``) reports
    solved whose returned (x, y) do not meet the solver's tolerance under
    the plain version's residuals recomputed in float64 (within
    :data:`SOUND_MARGIN` of the limit); a rescued lane may meet the
    rescue's primal-only exit instead."""
    P, _, A, q, l, u, rho, D, E, c = (a.double() for a in args[:10])
    x, y = out[0].double(), out[1].double()
    Ax = (A @ x[..., None])[..., 0]
    zc = torch.maximum(torch.minimum(Ax, u), l)
    Px = (P @ x[..., None])[..., 0]
    Aty = (y[:, None] @ A)[:, 0]
    ci = 1.0 / c.reshape(-1)
    pri = ((Ax - zc) / E).abs().amax(-1)
    dua = ((Px + q + Aty) * D).abs().amax(-1) * ci
    pri_sc = torch.maximum((Ax / E).abs().amax(-1), (zc / E).abs().amax(-1))
    dua_sc = torch.maximum(torch.maximum((Px * D).abs().amax(-1),
                                         (Aty * D).abs().amax(-1)),
                           (q * D).abs().amax(-1)) * ci
    m = 1.0 + SOUND_MARGIN
    ok = ((pri < m * (kw["eps_abs"] + kw["eps_rel"] * pri_sc))
          & (dua < m * (kw["eps_abs"] + kw["eps_rel"] * dua_sc)))
    ok = ok | (out[6] & (pri < m * kw["rescue_exit"]))
    return (out[5] & ~ok).nonzero()[:, 0].tolist()


def floor_tolerance_agrees(torch, args, kw, kt, pt, pc):
    """(ok, detail): B1 at tolerance on FTOCPs where most solves sit at
    float32's floor of the dual residual (after step 200, ~1 m before the
    finish line: ROADMAP C6). There which lanes reach the tolerance is
    decided by how the products round: the plain version with float32
    products (``pt``) and with each product rounded once from float64
    (``pc``, :class:`float64_products`) solved 6 and 94 of 256 on an
    H100 after step 200, and the kernel, the plain version and the plain
    version of a lane alone on the CPU, three float32 summation orders,
    agreed on no common set of lanes. So the kernel's solved count and mean iterations
    must lie within :data:`TOLERANCE_SHARE` (solves also
    :data:`TOLERANCE_SOLVES`) of the interval the two plain versions span,
    and every lane it calls solved must meet the tolerance
    (:func:`unsound_lanes`)."""
    B = kt[5].numel()
    ks = int(kt[5].sum())
    km = float(kt[4].float().mean())
    pts = [int(r[5].sum()) for r in (pt, pc)]
    pms = [float(r[4].float().mean()) for r in (pt, pc)]
    slack = max(TOLERANCE_SHARE * B, TOLERANCE_SOLVES)
    bad = unsound_lanes(torch, args, kw, kt)
    ok = (min(pts) - slack <= ks <= max(pts) + slack
          and (1 - TOLERANCE_SHARE) * min(pms) <= km
          <= (1 + TOLERANCE_SHARE) * max(pms) and not bad)
    return ok, (f"(solved kernel {ks}, plain {pts[0]}, plain with products "
                f"rounded once {pts[1]} of {B}; iters mean kernel {km:.2f}, "
                f"plain {pms[0]:.2f} and {pms[1]:.2f}; within "
                f"{TOLERANCE_SHARE:.0%} of that interval, solves also within "
                f"{TOLERANCE_SOLVES}; solved lanes off tolerance in float64: "
                f"{bad})")


def last_chunk_b1(torch, cuda_qp, rescue_replay, ctrl, chunk, solver, tag):
    """Phase 3, B1 on the FTOCPs after the last timed chunk ``chunk`` (a
    :class:`main_path.Chunk`), whose solves reach max_iter most often: 16
    fixed iterations against the plain version in both layouts, at
    tolerance as its plain versions (:func:`floor_tolerance_agrees`), two
    calls and the two layouts bit-identical, and the forced rescue: every
    lane rescued, the plain version's flags, and its iteration count on every
    lane where that count does not hang on the summation order. A lane
    whose exit margin comes within the order's noise of the threshold
    leaves where the order lets it (ROADMAP C7), so on a lane whose count
    differs the plain version runs again, the lane alone on the CPU with
    one thread: if it gives the card's count, the kernel must too; if not,
    the lane's count is the order's, and such lanes may be at most
    ``TOLERANCE_SHARE`` of the batch (or ``TOLERANCE_SOLVES``)."""
    st = chunk.state
    qp = ctrl.build_qp(st, chunk.plant.x)[0]
    warm = (st.warm_x, st.warm_y)
    fixed = dataclasses.replace(solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    f_args, f_kw = rescue_replay.admm_args(qp, fixed, warm, st.fac)
    t_args, t_kw = rescue_replay.admm_args(qp, solver, warm, st.fac)
    r_args, r_kw = rescue_replay.admm_args(
        qp, rescue_replay.forced_rescue(solver), warm, None)
    pf = cuda_qp.admm_iterate_plain(*f_args, **f_kw)
    classes = product_classes(cuda_qp, t_args, t_kw)
    pt, pc = classes["float32"], classes["all"]
    print(f"[chip_smoke] B1's plain version at tolerance {tag}, by the "
          f"products rounded once from float64: {class_text(classes)}")
    pr = cuda_qp.admm_iterate_plain(*r_args, **r_kw)
    B = pr[4].numel()
    alone, outs = {}, {}
    for name in cuda_qp.LAYOUTS:
        k = cuda_qp.admm_iterate(*f_args, **f_kw, layout=name)
        err = float((k[0] - pf[0]).abs().max())
        check(f"admm_{name}_fixed16_vs_plain_{tag}", err < 3e-2,
              f"(max |dx| {err:.2e})")
        kt = cuda_qp.admm_iterate(*t_args, **t_kw, layout=name)
        ok, detail = floor_tolerance_agrees(torch, t_args, t_kw, kt, pt, pc)
        check(f"admm_{name}_tolerance_as_plain_{tag}", ok, detail)
        kr = cuda_qp.admm_iterate(*r_args, **r_kw, layout=name)
        diff = (kr[4] != pr[4]).nonzero()[:, 0].tolist()
        for i in diff:
            if i not in alone:
                one = [a[i:i + 1].cpu() for a in r_args]
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    alone[i] = int(cuda_qp.admm_iterate_plain(
                        *one, **r_kw)[4][0])
                finally:
                    torch.set_num_threads(threads)
        flags = bool((kr[6] == pr[6]).all())
        held = [i for i in diff if alone[i] == int(pr[4][i])]
        order = [i for i in diff if i not in held]
        check(f"admm_{name}_forced_rescue_{tag}",
              bool(kr[6].all()) and flags and not held
              and len(order) <= max(TOLERANCE_SHARE * B, TOLERANCE_SOLVES),
              f"(rescued {int(kr[6].sum())}/{B}, flags equal {flags}, "
              f"iteration counts equal on {B - len(diff)} of {B} lanes; "
              f"each other lane (kernel, plain on the card, plain of the "
              f"lane alone on the CPU): "
              f"{[(i, int(kr[4][i]), int(pr[4][i]), alone[i]) for i in diff]}"
              f"; the plain version reproduced its count on {held})")
        outs[name] = (kt, kr)
    k2 = cuda_qp.admm_iterate(*t_args, **t_kw)
    check(f"admm_resident_same_bits_twice_{tag}",
          all(bool(torch.equal(a, b)) for a, b in zip(outs["resident"][0],
                                                       k2)))
    check(f"admm_resident_same_bits_as_stream_{tag}", all(
        bool(torch.equal(a, b)) for r, s in zip(outs["resident"],
                                                 outs["stream"])
        for a, b in zip(r, s)), "(at tolerance and under the forced rescue)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from racinglmpc_tpu_torch.models import sysid
    from racinglmpc_tpu_torch.ops import (cuda_build, cuda_qp, cuda_qp_fused,
                                          cuda_rollout, cuda_sysid)
    from racinglmpc_tpu_torch.ops import qp as qp_mod
    from racinglmpc_tpu_torch.runtime import bench
    from racinglmpc_tpu_torch.runtime import experiment as exp
    from racinglmpc_tpu_torch.runtime import (kernel_bench, main_path,
                                              rescue_replay)
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                                   SolverConfig)

    dev = "cuda"
    B, STEPS = 256, 50
    counters = (cuda_qp.launches, cuda_sysid.launches, cuda_rollout.launches,
                cuda_qp_fused.launches)
    # B1's launches per layout and the scenarios B1 and B4 streamed
    layouts = (*cuda_qp.layout_launches.values(), cuda_qp.streamed,
               cuda_qp_fused.streamed)

    phase_walls = {}
    current = [None, time.time()]

    def phase(name):
        """Print the wall of the phase that ends here; start ``name``."""
        now = time.time()
        if current[0] is not None:
            phase_walls[current[0]] = round(now - current[1], 1)
            print(f"[chip_smoke] phase {current[0]} wall "
                  f"{phase_walls[current[0]]} s", flush=True)
        current[:] = [name, now]

    # ---- phase 1: device, build ------------------------------------------
    phase(1)
    smi = bench.card()
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
    phase(2)
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

    # the bench's headline: a warm-up chunk, then 3 timed chunks, each
    # holding B1-B3 to one launch a step and no scenario streamed
    for c in counters + layouts:
        c.reset()
    try:
        head = bench.time_chunks(
            mp, state, plant, steps=STEPS, reps=3,
            log=lambda m: print(f"[chip_smoke]   {m}", flush=True))
    except bench.KernelPathError as e:
        check("main_path_on_the_kernels_every_step", False, f"({e})")
        raise
    launches = {c.name: c.n for c in counters}
    lay = {c.name: count(c) for c in layouts}
    it = torch.from_numpy(head.iters).float()
    print(f"[chip_smoke] main path: {head.solves_per_s:.1f} solves/s (batch "
          f"{B}, best of {len(head.rep_s)} chunks of {STEPS} steps: "
          f"{[round(t, 3) for t in head.rep_s]} s), ADMM iters mean "
          f"{float(it.mean()):.2f} p50 {float(it.quantile(0.5)):.0f} "
          f"p99 {float(it.quantile(0.99)):.0f}, rejected {head.rejected}, "
          f"not solved to tolerance {head.unsolved} of {it.numel()}, "
          f"launches {launches}, B1 layouts and streamed scenarios {lay}, "
          f"each timed chunk's counts {head.counts}")
    for r, ch in enumerate(head.chunks):
        ci = ch.iters.float().cpu()
        print(f"[chip_smoke]   timed chunk {r}: ADMM iters mean "
              f"{float(ci.mean()):.2f} p50 {float(ci.quantile(0.5)):.0f} "
              f"p99 {float(ci.quantile(0.99)):.0f}, rejected "
              f"{int(ch.rejected)}, not solved to tolerance "
              f"{int(ch.unsolved)} of {ci.numel()}")
    # the solved-share check holds the timed chunks before the finish
    # line (steps 51-150); from ~1.5 m before it (steps ~175-200 here)
    # float32's dual residual cannot certify the tolerance and most solves
    # run the main loop to max_iter, the reference's own too, though their
    # inputs lie within 1e-2 of the exact ones (ROADMAP C6), so the
    # window's share (steps 51-200) is printed beside it; phase 3's kernel
    # checks hold the FTOCPs after the first timed chunk (steps 51-100,
    # where earlier slices timed one chunk) and B1 after the last one too
    first = head.chunks[0]
    state, plant = first.state, first.plant
    held = head.chunks[:-1]
    solves = B * STEPS * len(held)
    unc_n = sum(int(c.unsolved) for c in held)
    print(f"[chip_smoke] not solved to tolerance: {head.unsolved} of "
          f"{it.numel()} ({100 * head.unsolved / it.numel():.2f}%) in all "
          f"{len(head.chunks)} timed chunks (the bench's window), {unc_n} "
          f"of {solves} in the first {len(held)}; solves at max_iter "
          f"{int((it == cfg.solver.max_iter).sum())}, past it (rescued) "
          f"{int((it > cfg.solver.max_iter).sum())}")
    last = head.chunks[-1]
    t1 = STEPS * len(head.chunks) + 1
    s_end = last.plant.x[:, 4].cpu()
    print(f"[chip_smoke] solves at max_iter per step of the last timed chunk "
          f"(steps {t1}-{t1 + STEPS - 1}): "
          f"{(last.iters >= cfg.solver.max_iter).sum(-1).tolist()}; arc "
          f"length after it min {float(s_end.min()):.2f} mean "
          f"{float(s_end.mean()):.2f} max {float(s_end.max()):.2f} of a "
          f"{float(trk.total_len):.2f} m lap")
    for name, n in launches.items():
        if name != "fused_admm":      # B4 is off on the main path
            check(f"main_path_launched_{name}", n > 0, f"({n})")
    check("main_path_admm_resident_no_scenario_streamed",
          lay["admm_resident"] > 0 and lay["admm_stream"] == 0
          and lay["admm_streamed"] == 0, f"({lay})")
    check("main_path_solved_90pct", unc_n <= 0.1 * solves,
          f"({solves - unc_n}/{solves} over steps {STEPS + 1}-"
          f"{STEPS * (len(held) + 1)})")
    check("main_path_finite", bool(torch.isfinite(plant.x).all()))
    # the floor of the inverse handed to B1 after each timed chunk
    for r, ch in enumerate(head.chunks):
        res, K, kinv = b1_inverse_floor(torch, qp_mod, ctrl, ch, cfg.solver)
        print(f"[chip_smoke]   after timed chunk {r} (step "
              f"{STEPS * (r + 2) + 1}): float64 max|I - K Kinv| of the "
              f"inverse handed to B1, {FLOOR_LANES} lanes: {floor_text(res)}")
        check(f"b1_inverse_below_reference_floor_chunk{r}",
              float(res.max()) < REFERENCE_FLOOR,
              f"(max {float(res.max()):.3e}, reference {REFERENCE_FLOOR})")
    sq = squaring_ms(torch, K, kinv)
    print(f"[chip_smoke] final Newton-Schulz squaring at batch {B}, n = "
          f"{K.shape[-1]} (CUDA events, ms): {json.dumps(sq)}")

    kernels = []

    # ---- phase 3: B1-B3 against their plain versions ----------------------
    phase(3)
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

    def admm_args(scfg, fac):
        return rescue_replay.admm_args(qp, scfg, warm, fac)

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
    rescue_cfg = rescue_replay.forced_rescue(cfg.solver)
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
    last_chunk_b1(torch, cuda_qp, rescue_replay, ctrl, head.chunks[-1],
                  cfg.solver, f"step{STEPS * (len(head.chunks) + 1)}")
    floors = inverse_floors(torch, qp_mod, cuda_qp, cuda_qp_fused, qp, warm,
                            state.fac, cfg.solver)
    for name in ("b1_rescue", "b4_prologue"):
        print(f"[chip_smoke] float64 max|I - K X| of the {name} inverse, "
              f"{FLOOR_LANES} lanes after step {2 * STEPS}: "
              f"{floor_text(floors[name])}")
    print(f"[chip_smoke]   B1 rescued {floors['b1_rescue_lanes_rescued']} of "
          f"those lanes")
    check("b1_rescue_inverse_read_on_every_lane",
          floors["b1_rescue_lanes_rescued"] == FLOOR_LANES)
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
                         kw["refine_steps"], cfg.solver.check_every)[0].sum())
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
    variants = b1_precisions(torch, qp_mod, cuda_qp, cuda_qp_fused,
                             kernel_bench, admm_args, cfg.solver, state.fac,
                             rescue_cfg, cfg.solver.check_every)
    for kinfo in kernels:
        print(f"[chip_smoke] kernel {kinfo['name']}: {kinfo['ms']:.4f} ms "
              f"(device {kinfo['device_ms']}, plain "
              f"{kinfo['plain_ms']:.4f} ms, bound "
              f"{kinfo['bound_ms']:.4f} ms by {kinfo['bound_by']}), "
              f"{kinfo['launches']} launches on the main path")

    # ---- phase 4: closed loop, all four stages -----------------------------
    phase(4)
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
    phase(5)
    runs = stage_runs(torch, qp_mod, counters + layouts, cuda_qp,
                      cuda_qp_fused)
    fused_launches = sum(r["launches"]["fused_admm"] for r in runs.values()
                         if r["fused"])

    # ---- phase 6: B4 against its plain version; structured inverse -------
    phase(6)
    fused_variants, fused = fused_phase(torch, qp_mod, cuda_qp,
                                        cuda_qp_fused, runs, trk,
                                        fused_launches)
    kernels.append(fused)
    variants += fused_variants
    structured_phase(torch, qp_mod, runs["config3_ltv/max"], trk)

    # ---- phase 7: checkpoint and resume -----------------------------------
    phase(7)
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

    # ---- phase 8: the mesh and the giant path ----------------------------
    phase(8)
    import numpy as np

    mesh = mesh_phase(torch, exp, loop_cfg, loop_steps, trk, counters,
                      layouts)
    try:
        giant_phase(torch, np, exp)
    finally:
        mesh.close()

    # ---- phase 9: the main path at each lowered iteration precision ------
    phase(9)
    prec_launches = precision_paths(torch, main_path, cuda_qp, cuda_qp_fused,
                                    counters, layouts, B, pid)
    for kinfo in variants:
        kinfo["launches"] = prec_launches[kinfo["name"]]
    kernels += variants

    # ---- phase 10: the bench's quality gate and secondary ----------------
    phase(10)
    gate_phase(torch, bench, mp, pid, counters, layouts, B, STEPS)

    # ---- phase 11: the 40-lap criterion against the float64 oracle ------
    phase(11)
    quality_phase(torch, counters, layouts)
    phase(None)
    print(f"[chip_smoke] phase walls {phase_walls} s, total "
          f"{sum(phase_walls.values()):.1f} s")

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
    if sys.argv[1:2] in (["--quality-triage"], ["--quality-draw"]):
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        if sys.argv[1] == "--quality-draw":
            quality_draw(torch, bool(int(sys.argv[2])),
                         (int(sys.argv[3]), int(sys.argv[4])))
        else:
            quality_triage(torch)
        sys.exit(0)
    sys.exit(main())
