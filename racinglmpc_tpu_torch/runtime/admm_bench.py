"""Kernels B1 and B4 timed on saved inputs, so that two checkouts of the
port can be timed, and B4 compared bit for bit, on the same FTOCPs in one
call on one card.

    python racinglmpc_tpu_torch/runtime/admm_bench.py --save build/b1.pt
    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/admm_bench.py \\
        --load build/b1.pt
    PYTHONPATH=<other checkout> python \\
        racinglmpc_tpu_torch/runtime/admm_bench.py --load build/b1.pt
    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/admm_bench.py \\
        --kernel b4 --save build/b4.pt --load build/b4.pt --phases build/b4.pt

``--save`` drives the main path (batch 256, 100 steps, as ``chip_smoke.py``
phase 2 does) and stores the kernel inputs of the next step's solve, at the
solver's tolerance, at 16 fixed iterations (no early exit, no rescue: the
time per iteration) and under ``chip_smoke.py`` phase 3's forced rescue
(every lane rescued). ``--load`` times ``cuda_qp.admm_iterate`` of
whichever package is imported on them (CUDA events, median of 20 launches
after 3), in every layout that package offers, and prints one JSON line
per configuration and layout with the iterations (mean, max), the rescued
lanes and a SHA-256 of the outputs. ``--phases`` builds the kernels with their phase clocks
(``-DQP_PHASES``) and prints, per configuration, the SM cycles scenario 0
spent in each phase of the resident layout's loop.

With ``--kernel b4`` the same three act on B4 (the fused-prologue ADMM).
``--save`` runs the ``config3_ltv`` and ``config2_lti`` presets with
``pallas_fused_ns=True`` (as ``chip_smoke.py`` phase 5 does) and stores
the B4 inputs of each stage's next solve (``stage_path.stage_ftocps``;
LTV: a cold build, its warm test fails; LTI: the warm cache), of the main
path's next solve (n = 200) and of 64 random QPs of n = 30, cold and warm
(P and A stored sparse, exactly). ``--load`` prints one JSON line per input set:
the event time per launch (CUDA events around 20 back-to-back launches,
divided by 20; median of 5 such runs), the device time per launch (a
``torch.profiler`` window), the Newton-Schulz iterations (mean, max), the
warm decisions, a SHA-256 of every output (x, y, residuals, iterations,
flags, the refreshed inverse, ns_resid, the pad scalar, warm decisions and
NS counts: equal checksums = equal bits across checkouts), the layout's
CTAs per SM on the card and the waves of the batch, and as a yardstick the
time of the same number of float32 products as ``torch.bmm`` (TF32 off)
over the whole batch (no per-scenario exits). ``--phases`` prints scenario
0's SM cycles in B4's prologue: the K build, the warm test, the residual
and update products of its Newton-Schulz iterations (sums and per
product) and both passes as a whole, and over all its products the
cycles a cell thread spent at the slab barriers, multiplying and in the
epilogues, and a producer's issuing and waiting. On the resident core
(n <= 152) a cell thread's slab barriers are its waits for K's slabs and
the barrier after each, and the producer is the thread that issues the
bulk copies: its issue and its time between them.

``--rescue-lanes F1,F2,...`` with ``--load`` times B1's rescue prologue
alone on the saved forced rescue (every lane rescued) cut to F lanes (the
first F, cycled past the batch): one JSON line per F with its device time
per call (``torch.profiler``, every ``admm_rescue_prologue`` launch) and,
where the package counts them, its Newton-Schulz iterations and the CTAs
that worked on the lanes; with ``--phases`` in place of ``--load`` (a
``-DQP_PHASES`` build), the SM cycles of the first CTA that works on lane
0 in the prologue's phases (B4's: K build, warm test, the products of
the Newton-Schulz iterations, and over every product its cell thread's
and producer's waits).

``--iter-precision`` (``highest``, the default, ``bf16x3`` or ``default``:
the reference's ``pallas_iter_precision``) runs ``--load`` and
``--phases`` with the ADMM loop's products at that precision, on the same
saved inputs (they are stored without it); a checkout whose wrappers take
no ``iter_precision`` runs ``highest`` only.
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

FUSED_NAMES = ("P", "A", "kinv0", "warm_ok", "q", "l", "u", "rho", "D", "E",
               "c", "x0", "z0", "y0")
FUSED_PHASES = ("K build", "warm test", "NS residual products",
                "NS update products", "NS passes",
                "cell thread: slab barriers", "cell thread: multiply",
                "cell thread: epilogues", "producer: issue",
                "producer: wait")    # qp_common.cuh: FPH_*
SPARSE = ("P", "A")              # stored sparse by --kernel b4 --save
# the kernels of a B4 call (its prologue and ADMM launches, then B1's
# rescue), as torch.profiler names them
B4_KERNELS = ("admm_fused", "admm_main", "admm_rescue")
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


def _precision_kw(fn, iter_precision: str) -> dict:
    """``iter_precision`` as a keyword argument of ``fn`` (a checkout's
    kernel wrapper), or none where the wrapper predates it (then only
    "highest" runs)."""
    if "iter_precision" in inspect.signature(fn).parameters:
        return {"iter_precision": iter_precision}
    if iter_precision != "highest":
        raise SystemExit(f"{fn.__module__}.{fn.__name__} takes no "
                         f"iter_precision")
    return {}


def _stored(kw: dict) -> dict:
    """Keyword arguments as stored: on the CPU, without the iteration
    precision (``--iter-precision`` chooses it when they are loaded)."""
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()
            if k != "iter_precision"}


def save(path: str, batch: int = 256, steps: int = 100) -> None:
    from racinglmpc_tpu_torch.ops import qp as qp_mod
    from racinglmpc_tpu_torch.runtime import main_path, rescue_replay

    mp, st, plant, _ = main_path.setup(batch)
    st, plant = main_path.run_chunk(mp, st, plant, steps)[:2]
    qp = mp.ctrl.build_qp(st, plant.x)[0]
    fixed = dataclasses.replace(mp.cfg.solver, eps_abs=0.0, eps_rel=0.0,
                                max_iter=16, check_every=16,
                                rescue_max_iter=0)
    # every lane rescued (chip_smoke.py phase 3's forced rescue)
    rescue = rescue_replay.forced_rescue(mp.cfg.solver)
    out = {}
    for key, scfg, fac in (("tolerance", mp.cfg.solver, st.fac),
                           ("fixed16", fixed, st.fac),
                           ("rescue", rescue, None)):
        pro, kinv, _ = qp_mod.admm_inputs(qp, scfg, (st.warm_x, st.warm_y),
                                          fac)
        out[key] = _stored(qp_mod.kernel_args(pro, kinv, scfg))
    torch.save(out, path)


def _card(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def phases(path: str, iter_precision: str = "highest") -> None:
    cuda_build.DEFINES = ("QP_PHASES",)
    lib = cuda_build.library()
    lib.rl_admm_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rl_admm_phases.restype = ctypes.c_int
    buf = (ctypes.c_longlong * len(PHASES))()
    prec = _precision_kw(cuda_qp.admm_iterate, iter_precision)
    for key, kw in torch.load(path).items():
        kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
        cuda_build.check(lib.rl_admm_phases(buf, 1))
        out = cuda_qp.admm_iterate(**kw, **prec, layout="resident")
        torch.cuda.synchronize()
        cuda_build.check(lib.rl_admm_phases(buf, 0))
        print(json.dumps(dict(
            config=key, iter_precision=iter_precision,
            scenario0_iters=int(out[4][0]),
            cycles=dict(zip(PHASES, list(buf))),
            sm_clock=_card("clocks.sm"), card=_card())), flush=True)


def load(path: str, iter_precision: str = "highest") -> None:
    from racinglmpc_tpu_torch.runtime import kernel_bench

    card = _card()
    layouts = [None]
    if "layout" in inspect.signature(cuda_qp.admm_iterate).parameters:
        layouts = list(cuda_qp.LAYOUTS)
    prec = _precision_kw(cuda_qp.admm_iterate, iter_precision)
    for key, kw in torch.load(path).items():
        kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
        for layout in layouts:
            extra = dict(prec) if layout is None else dict(prec,
                                                            layout=layout)
            out = cuda_qp.admm_iterate(**kw, **extra)
            ms = _time_ms(lambda: cuda_qp.admm_iterate(**kw, **extra))
            it = out[4].float()
            print(json.dumps(dict(
                config=key, layout=layout or "default",
                iter_precision=iter_precision, ms=ms,
                iters_mean=float(it.mean()), iters_max=int(it.max()),
                rescued=int(out[6].sum()), batch=int(it.numel()),
                checksum=kernel_bench.checksum(out),
                package=cuda_qp.__file__, card=card)), flush=True)


def _rescue_sets(path: str, counts):
    """(F, keyword arguments of ``admm_iterate``) of the saved forced rescue
    cut to each count of lanes F in ``counts`` (the first F, cycled past
    the batch)."""
    kw = torch.load(path)["rescue"]
    kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
    B = kw["P"].shape[0]
    for F in counts:
        idx = torch.arange(F, device="cuda") % B
        yield F, {k: v[idx].contiguous() if torch.is_tensor(v)
                  and v.dim() > 0 and v.shape[0] == B else v
                  for k, v in kw.items()}


def rescue_lanes(path: str, counts) -> None:
    """B1's rescue prologue on the saved forced rescue cut to each count of
    lanes in ``counts`` (see the module's docstring)."""
    from racinglmpc_tpu_torch.runtime import kernel_bench, tracing

    card = _card()
    for F, kf in _rescue_sets(path, counts):

        def fn():
            return cuda_qp.admm_iterate(**kf)

        with tracing.session() as rec:
            out = fn()
            torch.cuda.synchronize()
        work = {k.split(".")[-1]: v for k, v in rec.counts.items()
                if k.startswith("admm.rescue.")}
        print(json.dumps(dict(
            config="rescue", lanes=F, rescued=int(out[6].sum()),
            prologue_device_ms=kernel_bench.device_ms(
                fn, ("admm_rescue_prologue",), launches=3),
            rescue_device_ms=kernel_bench.device_ms(
                fn, ("admm_rescue<",), launches=3),
            work=work, package=cuda_qp.__file__, card=card)), flush=True)


def rescue_phases(path: str, counts) -> None:
    """The rescue prologue's phase clocks on the saved forced rescue cut to
    each count of lanes in ``counts`` (see the module's docstring)."""
    cuda_build.DEFINES = ("QP_PHASES",)
    f = cuda_build.bind(cuda_build.library(), "rl_rescue_phases",
                        [ctypes.c_void_p, ctypes.c_int])
    buf = (ctypes.c_longlong * len(FUSED_PHASES))()
    for F, kf in _rescue_sets(path, counts):
        cuda_qp.admm_iterate(**kf)
        torch.cuda.synchronize()
        cuda_build.check(f(buf, 1))
        cuda_qp.admm_iterate(**kf)
        torch.cuda.synchronize()
        cuda_build.check(f(buf, 0))
        cyc = dict(zip(FUSED_PHASES, list(buf)))
        print(json.dumps(dict(
            config="rescue", lanes=F, cycles=cyc,
            sm_clock=_card("clocks.sm"), card=_card())), flush=True)


def save_b4(path: str) -> None:
    """B4's inputs: the LTV (cold) and LTI (warm) stages' next solves, the
    main path's LMPC FTOCPs (n = 200) and 64 random QPs of n = 30, cold and
    warm (the cold solve's cache)."""
    from racinglmpc_tpu_torch.models.track import make_track
    from racinglmpc_tpu_torch.ops import qp as qp_mod
    from racinglmpc_tpu_torch.runtime import main_path, presets, stage_path
    from racinglmpc_tpu_torch.utils.qp_cases import random_qps

    def keep(kw):
        return _stored({k: v.to_sparse() if k in SPARSE else v
                        for k, v in kw.items()})

    trk = make_track(device="cuda")
    out = {}
    for name, stage in (("config3_ltv", "ltv"), ("config2_lti", "lti")):
        base = presets.PRESETS[name]["cfg"]
        cfg = dataclasses.replace(
            base, solver=dataclasses.replace(base.solver,
                                             pallas_fused_ns=True),
            sim=dataclasses.replace(base.sim, use_pallas_rollout=True))
        res = presets.run_preset(name, cfg=cfg, device="cuda")["result"]
        f = stage_path.stage_ftocps(res, cfg, stage, trk)
        out[stage] = keep(qp_mod.fused_inputs(f.qp, cfg.solver, f.warm,
                                              f.fac))
    mp, st, plant, _ = main_path.setup(256)
    st, plant = main_path.run_chunk(mp, st, plant, 10)[:2]
    fused = dataclasses.replace(mp.cfg.solver, pallas_fused_ns=True)
    out["lmpc"] = keep(qp_mod.fused_inputs(
        mp.ctrl.build_qp(st, plant.x)[0], fused, (st.warm_x, st.warm_y),
        st.fac))
    small = dataclasses.replace(fused, max_iter=200, polish=False,
                                eps_abs=3e-4, eps_rel=3e-4)
    qps = random_qps(64)
    out["small_cold"] = keep(qp_mod.fused_inputs(qps, small))
    fac = qp_mod.solve(qps, small).fac
    out["small_warm"] = keep(qp_mod.fused_inputs(qps, small, fac=fac))
    torch.save(out, path)


def _b4_sets(path: str):
    """(config, positional arguments on the card, keyword arguments) of each
    saved B4 input set."""
    for key, kw in torch.load(path).items():
        kw = {k: (v.to_dense() if v.is_sparse else v).cuda()
              if torch.is_tensor(v) else v for k, v in kw.items()}
        yield key, [kw.pop(k) for k in FUSED_NAMES], kw


def _bmm_ms(args, out) -> tuple:
    """(ms, products per scenario): the K build and, per scenario on
    average, the warm test and two products per Newton-Schulz iteration, as
    float32 ``torch.bmm`` calls over the whole batch."""
    from racinglmpc_tpu_torch.runtime import kernel_bench

    assert not torch.backends.cuda.matmul.allow_tf32
    P, A, X = args[0], args[1], args[2]
    per = float((args[3].float() + 2.0 * out.ns_iters.float()).mean())
    k = max(1, round(per))
    At = A.transpose(1, 2).contiguous()

    def run():
        torch.bmm(At, A)
        for _ in range(k):
            torch.bmm(P, X)

    return kernel_bench.event_ms(run), 1 + k


def load_b4(path: str, iter_precision: str = "highest") -> None:
    from racinglmpc_tpu_torch.ops import cuda_qp_fused
    from racinglmpc_tpu_torch.runtime import kernel_bench

    card = _card()
    prec = _precision_kw(cuda_qp_fused.admm_iterate_fused, iter_precision)
    for key, args, kw in _b4_sets(path):
        kw.update(prec)

        def fn():
            return cuda_qp_fused.admm_iterate_fused(*args, **kw)

        out = fn()
        torch.cuda.synchronize()
        B, n = args[4].shape
        m = args[5].shape[1]
        ctas = None
        if hasattr(cuda_qp_fused, "ctas_per_sm_on_card"):
            ctas = cuda_qp_fused.ctas_per_sm_on_card(n, m)
        ns = out.ns_iters.float()
        bmm, products = _bmm_ms(args, out)
        print(json.dumps(dict(
            kernel="B4", config=key, iter_precision=iter_precision,
            batch=B, n=n, m=m,
            ms=kernel_bench.event_ms(fn),
            device_ms=kernel_bench.device_ms(fn, B4_KERNELS),
            ns_iters_mean=float(ns.mean()), ns_iters_max=int(ns.max()),
            warm=int(out.warm.sum()), warm_ok=int(args[3].sum()),
            admm_iters_mean=float(out.iters.float().mean()),
            rescued=int(out.rescued.sum()),
            checksum=kernel_bench.checksum(out), ctas_per_sm=ctas,
            waves=-(-B // (ctas * cuda_build.N_SM)) if ctas else None,
            bmm_ms=bmm, bmm_products=products,
            package=cuda_qp_fused.__file__, card=card)), flush=True)


def phases_b4(path: str, iter_precision: str = "highest") -> None:
    from racinglmpc_tpu_torch.ops import cuda_qp_fused

    cuda_build.DEFINES = ("QP_PHASES",)
    f = cuda_build.bind(cuda_build.library(), "rl_fused_phases",
                        [ctypes.c_void_p, ctypes.c_int])
    buf = (ctypes.c_longlong * len(FUSED_PHASES))()
    prec = _precision_kw(cuda_qp_fused.admm_iterate_fused, iter_precision)
    for key, args, kw in _b4_sets(path):
        kw.update(prec)
        cuda_build.check(f(buf, 1))
        out = cuda_qp_fused.admm_iterate_fused(*args, **kw)
        torch.cuda.synchronize()
        cuda_build.check(f(buf, 0))
        its = int(out.ns_iters[0])
        cyc = dict(zip(FUSED_PHASES, list(buf)))
        print(json.dumps(dict(
            kernel="B4", config=key, iter_precision=iter_precision,
            scenario0_ns_iters=its,
            scenario0_warm=bool(out.warm[0]),
            scenario0_admm_iters=int(out.iters[0]), cycles=cyc,
            residual_product=cyc["NS residual products"] / max(its, 1),
            update_product=cyc["NS update products"] / max(its, 1),
            sm_clock=_card("clocks.sm"), card=_card())), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("b1", "b4"), default="b1")
    ap.add_argument("--save", help="drive the main path (B1) or the MPC "
                    "stage presets (B4), store the inputs")
    ap.add_argument("--load", help="time the kernel on stored inputs")
    ap.add_argument("--phases", help="phase clocks of the kernel on stored "
                    "inputs")
    ap.add_argument("--iter-precision", default="highest",
                    choices=("highest", "bf16x3", "default"),
                    help="the ADMM loop's products in --load and --phases")
    ap.add_argument("--rescue-lanes", help="with --load or --phases (B1): "
                    "the rescue prologue on the forced rescue cut to these "
                    "counts of lanes (comma-separated)")
    a = ap.parse_args()
    b4 = a.kernel == "b4"
    if a.save:
        (save_b4 if b4 else save)(a.save)
    if a.load and a.rescue_lanes:
        rescue_lanes(a.load, [int(f) for f in a.rescue_lanes.split(",")])
    elif a.load:
        (load_b4 if b4 else load)(a.load, a.iter_precision)
    if a.phases and a.rescue_lanes:
        rescue_phases(a.phases, [int(f) for f in a.rescue_lanes.split(",")])
    elif a.phases:
        (phases_b4 if b4 else phases)(a.phases, a.iter_precision)
