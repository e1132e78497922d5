"""B1's forced rescue on the main path's FTOCPs, kernel against its plain
version, lane by lane, with the exit test's margins at every rescue check.

The forced rescue (``chip_smoke.py`` phase 3: rho 1e-4 for 40 main
iterations, then the rescue at 100x rho for up to 400, exit at eps 1e-4 or
pri < rescue_exit) requires every lane rescued, equal rescue flags and
equal iteration counts. This script drives the main path as the bench's
headline does (batch 256, a warm-up chunk and 3 chunks of 50 steps), and
after each chunk runs that solve on the batch's next FTOCPs on the kernel
(both layouts) and the plain version, and prints which clause holds. For
every lane whose counts differ, and a few control lanes, it reruns both
with no early exit (eps 0, rescue_exit 0) for each rescue budget of 10,
20, ..., 400 iterations, and prints the exit test's margins at that check
(:func:`exit_margins`, float64 from the returned iterates): a lane leaves
at the first check where both eps ratios are below 1, or where pri is
below rescue_exit. ``--out`` saves the differing lanes' kernel inputs and
both outputs (:func:`save`); ``--replay`` runs the plain version on such a
file on the CPU with one thread (another summation order) and prints its
counts and every exit margin beside the card's.

    python -m racinglmpc_tpu_torch.runtime.rescue_replay --out r.npz
    python -m racinglmpc_tpu_torch.runtime.rescue_replay --replay r.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Sequence

import numpy as np
import torch

from racinglmpc_tpu_torch.ops import cuda_qp
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.utils.config import SolverConfig

ADMM_NAMES = ("P", "Kinv", "A", "q", "l", "u", "rho", "D", "E", "c", "x0",
              "z0", "y0")
CONTROL_LANES = (0, 1, 2, 3)


def forced_rescue(solver: SolverConfig) -> SolverConfig:
    """``solver`` with rho 1e-4 for 40 main iterations, so that every lane
    needs the rescue (100x rho, up to 400 iterations, eps 1e-4)."""
    return dataclasses.replace(
        solver, rho=1e-4, rho_eq_scale=1.0, max_iter=40, check_every=10,
        scaling_iters=0, eps_abs=1e-4, eps_rel=1e-4, rescue_max_iter=400,
        rescue_rho_scale=100.0)


def admm_args(qp, scfg: SolverConfig, warm, fac):
    """(positional tensors in ``ADMM_NAMES`` order, keyword arguments) of
    ``cuda_qp.admm_iterate`` for this solve, as ``qp.solve`` makes them."""
    pro, kinv, _ = qp_mod.admm_inputs(qp, scfg, warm, fac)
    kw = qp_mod.kernel_args(pro, kinv, scfg)
    return [kw.pop(n) for n in ADMM_NAMES], kw


def lanes(args: Sequence[torch.Tensor], idx) -> List[torch.Tensor]:
    return [a[idx].contiguous() for a in args]


def exit_margins(args: Sequence[torch.Tensor], kw: dict, x, y) -> Dict:
    """The exit test at the iterates (x, y) (scaled coordinates), in
    float64: ``pri`` and ``dua`` over their eps thresholds
    (eps_abs + eps_rel x scale; below 1 on both passes), and ``pri`` over
    ``rescue_exit`` (below 1 passes in the rescue). As the plain version's
    ``residuals``."""
    P, _, A, q, l, u, _, D, E, c = (a.double() for a in args[:10])
    big = cuda_qp._BIG
    x, y = x.double(), y.double()
    l, u, Ei, ci = l.clamp(-big, big), u.clamp(-big, big), 1.0 / E, 1.0 / c
    Ax = torch.einsum("bmn,bn->bm", A, x)
    zc = torch.minimum(torch.maximum(Ax, l), u)
    pri = ((Ax - zc) * Ei).abs().amax(-1)
    Px = torch.einsum("bn,bnk->bk", x, P)
    Aty = torch.einsum("bm,bmn->bn", y, A)
    dua = ((Px + q + Aty) * D).abs().amax(-1) * ci
    pri_sc = torch.maximum((Ax * Ei).abs().amax(-1), (zc * Ei).abs().amax(-1))
    dua_sc = torch.maximum(torch.maximum((Px * D).abs().amax(-1),
                                         (Aty * D).abs().amax(-1)),
                           (q * D).abs().amax(-1)) * ci
    ea, er = kw["eps_abs"], kw["eps_rel"]
    return {"pri_eps": (pri / (ea + er * pri_sc)).tolist(),
            "dua_eps": (dua / (ea + er * dua_sc)).tolist(),
            "pri_exit": (pri / kw["rescue_exit"]).tolist()}


def sweep(args, kw, checks: Sequence[int], plain=False) -> List[Dict]:
    """:func:`exit_margins` after ``kw['max_iter']`` main iterations and
    each rescue budget in ``checks``, no early exit."""
    fixed = dict(kw, eps_abs=0.0, eps_rel=0.0, rescue_exit=0.0)
    fn = cuda_qp.admm_iterate_plain if plain else cuda_qp.admm_iterate
    out = []
    for r in checks:
        o = fn(*args, **dict(fixed, rescue_max_iter=r))
        out.append(dict(rescue_iters=r, **exit_margins(args, kw, o[0], o[1])))
    return out


def compare(args, kw) -> Dict:
    """The forced rescue's clauses, kernel (each layout) against plain."""
    p = cuda_qp.admm_iterate_plain(*args, **kw)
    res = {"plain": p}
    for lay in cuda_qp.LAYOUTS:
        k = cuda_qp.admm_iterate(*args, **kw, layout=lay)
        diff = (k[4] != p[4]).nonzero()[:, 0]
        res[lay] = dict(
            out=k, all_rescued=bool(k[6].all()),
            flags_equal=bool((k[6] == p[6]).all()), differ=diff.tolist(),
            counts=[(int(k[4][i]), int(p[4][i])) for i in diff],
            solved=[(bool(k[5][i]), bool(p[5][i])) for i in diff])
    return res


def save(path: str, args, kw: dict, diff: Sequence[int], res: Dict,
         step: int) -> None:
    """An ``.npz`` of the lanes ``diff``: their kernel inputs (``ADMM_NAMES``),
    ``kw`` (JSON), each lane's outputs on the card (``kernel_*`` and
    ``plain_*``: x, y, pri, dua, iters) and the whole batch's iteration
    counts."""
    idx = torch.tensor(list(diff), device=args[0].device)
    out = {n: t.cpu().numpy() for n, t in zip(ADMM_NAMES, lanes(args, idx))}
    for who, o in (("kernel", res["resident"]["out"]), ("plain", res["plain"])):
        for name, t in zip(("x", "y", "pri", "dua", "iters"), o[:5]):
            out[f"{who}_{name}"] = t[idx].cpu().numpy()
        out[f"{who}_iters_batch"] = o[4].cpu().numpy()
    np.savez_compressed(path, lanes=np.asarray(diff), step=step,
                        kw=json.dumps(kw), **out)


def load(path: str):
    """(args, kw, card outputs) of a :func:`save` file, on the CPU."""
    f = np.load(path)
    args = [torch.from_numpy(f[n]) for n in ADMM_NAMES]
    return args, json.loads(str(f["kw"])), {k: f[k] for k in f.files}


def replay(path: str) -> Dict:
    """The plain version on the CPU, one thread, on each lane of a
    :func:`save` file, beside the card's counts and every exit margin."""
    args, kw, f = load(path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = cuda_qp.admm_iterate_plain(*args, **kw)
    finally:
        torch.set_num_threads(threads)
    t = torch.from_numpy
    return {"lanes": f["lanes"].tolist(),
            "iters": {"kernel": f["kernel_iters"].tolist(),
                      "plain": f["plain_iters"].tolist(),
                      "cpu_plain": cpu[4].tolist()},
            "margins": {"kernel": exit_margins(args, kw, t(f["kernel_x"]),
                                               t(f["kernel_y"])),
                        "plain": exit_margins(args, kw, t(f["plain_x"]),
                                              t(f["plain_y"])),
                        "cpu_plain": exit_margins(args, kw, cpu[0], cpu[1])}}


def main(argv=None) -> int:
    from racinglmpc_tpu_torch.runtime import main_path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out", help="an .npz of the lanes whose counts differ")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replay", help="replay an --out file on the CPU")
    a = ap.parse_args(argv)
    if a.replay:
        print(json.dumps(replay(a.replay)))
        return 0
    mp, st, plant, _ = main_path.setup(a.batch, device=a.device)
    st, plant = main_path.run_chunk(mp, st, plant, a.steps)[:2]   # warm-up
    rcfg = forced_rescue(mp.cfg.solver)
    for ch in range(a.chunks):
        st, plant = main_path.run_chunk(mp, st, plant, a.steps)[:2]
        qp = mp.ctrl.build_qp(st, plant.x)[0]
        args, kw = admm_args(qp, rcfg, (st.warm_x, st.warm_y), None)
        res = compare(args, kw)
        p = res["plain"]
        line = {"chunk": ch, "step": a.steps * (ch + 2),
                "plain_iters_mean": float(p[4].float().mean())}
        for lay in cuda_qp.LAYOUTS:
            line[lay] = {k: v for k, v in res[lay].items() if k != "out"}
        print(json.dumps(line), flush=True)
    diff = res["resident"]["differ"]
    sel = sorted(set(diff) | {i for i in CONTROL_LANES if i < a.batch})
    idx = torch.tensor(sel, device=args[0].device)
    sub = lanes(args, idx)
    k_sub = cuda_qp.admm_iterate(*sub, **kw)
    k_full = res["resident"]["out"]
    same = all(bool(torch.equal(s, f[idx])) for s, f in zip(k_sub, k_full))
    print(json.dumps({"lanes": sel, "sub_batch_same_bits": same}), flush=True)
    # the kernel's margins against the plain version's over the batch
    spread = {}
    for r in (100, 200, 300, 400):
        km, pm = (sweep(args, kw, [r], plain=w)[0] for w in (False, True))
        rel = {m: (torch.tensor(km[m]) / torch.tensor(pm[m]) - 1).abs()
               for m in ("pri_eps", "dua_eps")}
        spread[r] = {m: [float(v.quantile(f)) for f in (0.5, 0.9, 1.0)]
                     for m, v in rel.items()}
    print(json.dumps({"kernel_vs_plain_margin_rel_gap_p50_p90_max": spread}),
          flush=True)
    checks = list(range(kw["check_every"], kw["rescue_max_iter"] + 1,
                        kw["check_every"]))
    sw = {"kernel": sweep(sub, kw, checks),
          "plain": sweep(sub, kw, checks, plain=True)}
    for j, lane in enumerate(sel):
        rows = [[r["rescue_iters"]] + [
            round(sw[w][i][m][j], 5) for w in ("kernel", "plain")
            for m in ("pri_eps", "dua_eps", "pri_exit")]
            for i, r in enumerate(sw["kernel"])]
        print(json.dumps({"lane": lane, "columns": [
            "rescue_iters", "kernel pri/eps", "kernel dua/eps",
            "kernel pri/exit", "plain pri/eps", "plain dua/eps",
            "plain pri/exit"], "rows": rows}), flush=True)
    if a.out and diff:
        save(a.out, args, kw, diff, res, a.steps * (a.chunks + 1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
