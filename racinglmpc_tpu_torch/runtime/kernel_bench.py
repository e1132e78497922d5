"""Kernels B2 (local sys-ID) and B3 (plant rollout) timed on saved
main-path inputs, so that two checkouts of the port can be timed, and
compared bit for bit, on the same inputs in one call on one card.

    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/kernel_bench.py \\
        --save build/b23.pt
    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/kernel_bench.py \\
        --load build/b23.pt
    PYTHONPATH=<other checkout> python \\
        racinglmpc_tpu_torch/runtime/kernel_bench.py --load build/b23.pt
    PYTHONPATH=. python racinglmpc_tpu_torch/runtime/kernel_bench.py \\
        --sass build/sass --phases build/b23.pt

``--save`` drives the main path (batch 256, 100 steps, as ``chip_smoke.py``
phase 2 does) and stores the inputs of the next step's B2 and B3 launches.
``--load`` runs the kernels of whichever package is imported on them, and
on the same lap store zero-padded to T = 1024 rows (the store that
``LMPCConfig``'s default ``model_pts`` holds after the same laps), and
B2 with ``knn_max = MAX_KNN + 1`` (its rescan instance) on the saved store,
and prints one JSON line per case: the event time per launch (CUDA events
around 20 back-to-back launches, divided by 20; median of 5 such runs), the
device time per launch (a ``torch.profiler`` window of 20 launches), the
host time per call (wall time of 200 calls that only enqueue) and a
SHA-256 of the outputs' bytes. ``--sass DIR`` writes the SASS of B2's and
B3's kernels (``cuobjdump``) into DIR and prints, per kernel, its
registers, stack and spills (``-Xptxas -v``) and, for each of its loops,
the instructions, the MUFU and local-memory instructions and the longest
chain of dependent instructions in one pass of the body. ``--phases``
builds the kernels with their phase clocks (``-DRL_PHASES``) and prints
them: B3's SM cycles per substep of scenario 0, B2's SM cycles of warp 0
of scenario 0 in each phase.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import time

import torch

from racinglmpc_tpu_torch.ops import cuda_build, cuda_rollout, cuda_sysid

ROLLOUT_PHASES = ("tire forces", "curvature lookup", "kinematics")
SYSID_PHASES = ("staging", "distances", "selection",
                "gathers + accumulation", "Gauss-Jordan", "kinematic rows")
KERNELS = {"rollout": ("rollout",), "sysid": ("sysid",)}   # name matches


def event_ms(fn, launches: int = 20, runs: int = 5, warm: int = 3) -> float:
    """Event time per launch: CUDA events around ``launches`` back-to-back
    calls of ``fn``, divided by their count; median of ``runs``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / launches)
    return statistics.median(ts)


def host_ms(fn, calls: int = 200) -> float:
    """Host time per call of ``fn``: the wall time of ``calls`` calls that
    only enqueue work (no synchronization inside), over the count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(fn, names, launches: int = 20):
    """Device time per call of ``fn``: the summed durations of the kernels
    whose names contain one of ``names`` in a ``torch.profiler`` window of
    ``launches`` calls, over the count (None when the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in names)]
    return sum(us) / 1e3 / launches if us else None


def checksum(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _card(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def save(path: str, batch: int = 256, steps: int = 100,
         device="cuda") -> None:
    from racinglmpc_tpu_torch.runtime import main_path

    mp, st, plant, _ = main_path.setup(batch, device=device)
    st, plant = main_path.run_chunk(mp, st, plant, steps)[:2]
    seen = {}
    sysid_fn = cuda_sysid.local_linearization_horizon
    rollout_fn = cuda_rollout.plant_step_batch

    def sysid(store, trk, x_lin, u_lin, cfg, dt_ctrl=0.1, table=None):
        seen.setdefault("sysid", (store, x_lin, u_lin, cfg, dt_ctrl))
        return sysid_fn(store, trk, x_lin, u_lin, cfg, dt_ctrl, table=table)

    def rollout(x, x_glob, u, vp, trk, cfg, table=None):
        seen.setdefault("rollout", (x, x_glob, u, vp, cfg))
        return rollout_fn(x, x_glob, u, vp, trk, cfg, table=table)

    cuda_sysid.local_linearization_horizon = sysid
    cuda_rollout.plant_step_batch = rollout
    try:
        main_path.run_chunk(mp, st, plant, 1)
    finally:
        cuda_sysid.local_linearization_horizon = sysid_fn
        cuda_rollout.plant_step_batch = rollout_fn
    store, x_lin, u_lin, lcfg, dt = seen["sysid"]
    x, xg, u, vp, sim = seen["rollout"]
    cpu = {k: v.detach().cpu() for k, v in dict(
        store_x=store.x, store_u=store.u, store_steps=store.steps,
        x_lin=x_lin, u_lin=u_lin, x=x, x_glob=xg, u=u).items()}
    torch.save(dict(cpu, table=dataclasses.asdict(mp.table), vp=tuple(vp),
                    sim=dataclasses.asdict(sim),
                    lmpc=dataclasses.asdict(lcfg), dt=dt), path)


def cases(path: str):
    """(name, launch, kernel-name matches, substeps) of each saved case."""
    from racinglmpc_tpu_torch.models import sysid
    from racinglmpc_tpu_torch.models.track import TrackTable, make_track
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                                   VehicleParams)

    d = torch.load(path)
    g = {k: v.cuda() for k, v in d.items() if torch.is_tensor(v)}
    trk = make_track(device="cuda")
    table = TrackTable(**d["table"])
    vp, sim = VehicleParams(*d["vp"]), SimConfig(**d["sim"])
    cfg = LMPCConfig(**d["lmpc"])
    yield ("rollout", lambda: cuda_rollout.plant_step_batch(
        g["x"], g["x_glob"], g["u"], vp, trk, sim, table=table),
        KERNELS["rollout"], sim.substeps)
    B, K, T, _ = g["store_x"].shape
    for rows in sorted({T, max(T, 1024)}):
        pad = (0, 0, 0, rows - T)
        store = sysid.LapStore(
            torch.nn.functional.pad(g["store_x"], pad).contiguous(),
            torch.nn.functional.pad(g["store_u"], pad).contiguous(),
            g["store_steps"])
        yield (f"sysid_T{rows}",
               lambda s=store: cuda_sysid.local_linearization_horizon(
                   s, trk, g["x_lin"], g["u_lin"], cfg, d["dt"],
                   table=table), KERNELS["sysid"], None)
    # B2's rescan instance (knn_max above a lane's list) on the same store
    wide = dataclasses.replace(cfg, knn_max=cuda_sysid.MAX_KNN + 1)
    store = sysid.LapStore(g["store_x"], g["store_u"], g["store_steps"])
    yield (f"sysid_T{T}_knn{wide.knn_max}",
           lambda: cuda_sysid.local_linearization_horizon(
               store, trk, g["x_lin"], g["u_lin"], wide, d["dt"],
               table=table), KERNELS["sysid"], None)


def load(path: str) -> None:
    card = _card()
    for name, fn, match, _ in cases(path):
        outs = fn()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            case=name, ms=event_ms(fn), device_ms=device_ms(fn, match),
            host_ms=host_ms(fn),
            checksum=checksum(outs), package=cuda_rollout.__file__,
            card=card)), flush=True)


# --- SASS: loops, MUFU and local-memory instructions, dependency chains ---

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "EXIT", "BAR", "BSSY",
            "BSYNC", "CALL", "RET", "NOP", "WARPSYNC", "MEMBAR", "FENCE",
            "DEPBAR", "YIELD", "ERRBAR", "CCTL", "BPT", "RPCMOV")
_TWO_PRED = ("ISETP", "FSETP", "DSETP", "HSETP2", "PSETP", "PLOP3")


def _parse(text: str):
    """[(address, opcode, dests, sources, branch target)] of one function."""
    insns, labels, pending = [], {}, []
    for line in text.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        for lab in pending:
            labels[lab] = addr
        pending = []
        guard = []
        if body.startswith("@"):
            g, body = body.split(None, 1)
            guard = _REG.findall(g)
        op, _, rest = body.partition(" ")
        ops = [o.strip() for o in rest.split(",")] if rest else []
        base = op.split(".")[0]
        n_dest = 0
        if ops and base not in _NO_DEST:
            n_dest = 2 if base in _TWO_PRED else 1
            if (len(ops) > 1 and re.fullmatch(r"U?P\d", ops[1])
                    and base in ("IADD3", "LEA", "IMAD")):
                n_dest = 2       # a carry-out predicate
        dests = [o for o in ops[:n_dest] if re.fullmatch(r"U?[RP]\d+", o)]
        if ".64" in op or ".WIDE" in op:
            dests += [f"R{int(r[1:]) + 1}" for r in dests if r[0] == "R"]
        srcs = guard + [r for o in ops[n_dest:] for r in _REG.findall(o)]
        target = None
        if base == "BRA":
            t = re.search(r"\((\.L_x_\d+)\)|0x([0-9a-f]+)", rest)
            if t:
                target = t.group(1) or int(t.group(2), 16)
        insns.append((addr, op, dests, srcs, target))
    return [(a, op, d, s, labels.get(t, t) if isinstance(t, str) else t)
            for a, op, d, s, t in insns]


def _loop_stats(insns, lo: int, hi: int) -> dict:
    body = [i for i in insns if lo <= i[0] <= hi and i[1] != "NOP"]
    depth, chain = {}, 0
    for _, op, dests, srcs, _ in body:
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dests:
            depth[r] = d
        chain = max(chain, d)
    ops = [i[1].split(".")[0] for i in body]
    return dict(start=hex(lo), end=hex(hi), instructions=len(body),
                mufu=ops.count("MUFU"),
                local=sum(o in ("LDL", "STL") for o in ops),
                const_loads=ops.count("LDC"),
                shared=sum(o in ("LDS", "STS") for o in ops),
                calls=ops.count("CALL"), chain=chain)


def ptxas_info(log: str) -> dict:
    """{entry function: registers, stack bytes, spill stores/loads}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out.setdefault(fn, {}).update(stack=int(m.group(1)),
                                          spill_stores=int(m.group(2)),
                                          spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def sass(out_dir: str) -> None:
    build = cuda_build.build(cuda_build.DEFINES)
    log = build.log or (build.path.parent / "build.log").read_text()
    info = ptxas_info(log)
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([exe, "-sass", str(build.path)], check=True,
                          capture_output=True, text=True).stdout
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for part in text.split("Function : ")[1:]:
        fn = part.split()[0]
        kind = next((k for k, names in KERNELS.items()
                     if any(n in fn for n in names)), None)
        if kind is None:
            continue
        (out / f"{fn}.sass").write_text(part)
        insns = _parse(part)
        loops = [_loop_stats(insns, t, a) for a, _, _, _, t in insns
                 if isinstance(t, int) and t < a]
        print(json.dumps(dict(kernel=kind, function=fn,
                              ptxas=info.get(fn), instructions=len(insns),
                              loops=loops)), flush=True)


def phases(path: str) -> None:
    cuda_build.DEFINES = ("RL_PHASES",)
    lib = cuda_build.library()
    bufs = {}
    for kind, names in (("rollout", ROLLOUT_PHASES),
                        ("sysid", SYSID_PHASES)):
        f = getattr(lib, f"rl_{kind}_phases")
        f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        f.restype = ctypes.c_int
        bufs[kind] = (f, (ctypes.c_longlong * len(names))(), names)
    for name, fn, _, substeps in cases(path):
        kind = name.split("_")[0]
        f, buf, names = bufs[kind]
        cuda_build.check(f(buf, 1))
        fn()
        torch.cuda.synchronize()
        cuda_build.check(f(buf, 0))
        per = substeps or 1
        print(json.dumps(dict(
            case=name, per="substep" if substeps else "launch",
            cycles=dict(zip(names, [v / per for v in buf])),
            total=sum(buf) / per, sm_clock=_card("clocks.sm"),
            card=_card())), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="drive the main path, store the inputs")
    ap.add_argument("--load", help="time B2 and B3 on stored inputs")
    ap.add_argument("--sass", help="directory for the kernels' SASS")
    ap.add_argument("--phases", help="phase clocks of B2 and B3 on stored "
                    "inputs")
    a = ap.parse_args()
    if a.save:
        save(a.save)
    if a.load:
        load(a.load)
    if a.sass:
        sass(a.sass)
    if a.phases:
        phases(a.phases)
