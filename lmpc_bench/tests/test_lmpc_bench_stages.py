"""A controller stage is found by the name its configuration gives: in a
copy of the benchmark, a configuration naming a stage file that only the
copy has (the port's LTV-MPC controller over the PID lap, episodes of a
fixed number of steps across laps, a stub judge) runs through
``run.prepare`` and ``run.measure`` on the CPU to a result line, and no
file of the copy changes on the way."""
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

from lmpc_bench import spec, stages

REPO = pathlib.Path(__file__).resolve().parents[2]
CELL = "ltv_probe.pid_probe"

STAGE = '''"""LTV-MPC over the PID lap: the port's ``MPCController``,
re-identified around its predicted trajectory at every step, for a fixed
number of steps an episode across laps."""
from typing import Any, NamedTuple

import numpy as np
import torch

from lmpc_bench import cell as cell_mod
from lmpc_bench import spec
from racinglmpc_tpu_torch.controllers import mpc
from racinglmpc_tpu_torch.models import sysid
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.models.track import make_track, track_table
from racinglmpc_tpu_torch.runtime import experiment as exp
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, MPCConfig,
                                               SimConfig, SolverConfig,
                                               VehicleParams)

keep_fields = (("u_old", "x_lin"), ("u_old", "x_pred", "feasible"))


class Setup(NamedTuple):
    cell: Any
    device: Any
    dtype: Any
    batch: int
    sim: Any
    step: Any
    state0: Any
    plant0: Any
    trk: Any
    table: Any
    steps: int


def setup(cell, device, overrides=None, batch=None):
    port = cell.config["port"]
    dtype = cell_mod.DTYPES[port["dtype"]]
    device = torch.device(device)
    B = int(batch or port["batch"])
    trk = make_track(dtype=dtype, device=device)
    lap = np.load(spec.ROOT / cell.traffic["seed_laps"]["file"])
    xs, us = (torch.as_tensor(lap[k], dtype=dtype, device=device)[None]
              .expand(B, -1, -1) for k in ("xs", "us"))
    lcfg = LMPCConfig(model_pts=512)
    store = sysid.add_lap(
        sysid.make_lap_store(B, 1, lcfg.model_pts, dtype=dtype,
                             device=device), xs, us,
        torch.full((B,), xs.shape[1], dtype=torch.int32, device=device))
    noise = cell.traffic["noise"]
    sim = SimConfig(dt=0.1, noise=True, noise_sigma=tuple(noise["sigma"]),
                    noise_clip=noise["clip"], noise_gain=noise["gain"])
    ctrl, state = mpc.make_ltv_mpc(
        MPCConfig(N=14, vt=0.8, time_varying=True), store, trk, lcfg,
        SolverConfig.throughput(), sim.dt, dtype=dtype)
    x0 = torch.tensor(cell.traffic["x0"], dtype=dtype,
                      device=device).repeat(B, 1)
    return Setup(cell=cell, device=device, dtype=dtype, batch=B, sim=sim,
                 step=ctrl, state0=state,
                 plant0=PlantState(x=x0, x_glob=x0.clone()), trk=trk,
                 table=track_table(trk), steps=int(port["episode_steps"]))


def collect(st):
    return ~st.feasible, torch.zeros_like(st.feasible, dtype=torch.int32)


def run_episode(S, clock, stream, want=frozenset(), lanes=None):
    clock.want, clock.kept, clock.draws = frozenset(want), {}, {}
    calls0 = clock.calls
    sr = loop.run_lap(clock, S.state0, S.plant0, trk=S.trk,
                      vp=VehicleParams(), sim_cfg=S.sim, max_steps=S.steps,
                      multi_lap=True, noise=clock.noise(S, stream, exp.LTV),
                      table=S.table, collect_fn=collect)
    return cell_mod.Episode(sr=sr, calls=clock.calls - calls0,
                            kept=clock.kept, draws=clock.draws, closure=None,
                            lanes=lanes)


def work(S, win):
    return {}


def judge(S, win, seed, limits):
    # a stub: every episode kept the planned steps' fields and draws
    missing = sum(len(ep.kept) != 2 or len(ep.draws) != 2
                  or len(ep.kept[min(ep.kept)][1]) != 3
                  for ep in win.episodes)
    cell_mod.release(win, S.device)
    return {"input_gap": 0.0, "plant_gap": 0.0, "mismatches": missing,
            "sampled": 0}
'''

CONFIG = {"name": "ltv_probe", "stage": "ltv_probe",
          "port": {"batch": 4, "dtype": "float32", "episode_steps": 6}}
TRAFFIC = {"name": "pid_probe", "why": "test",
           "seed_laps": {"file": "data/pid_lap.npz", "layout": "lap"},
           "x0": [0.5, 0.0, 0.0, 0.0, 0.0, 0.0],
           "noise": {"sigma": [0.01, 0.01, 0.005], "clip": 0.05,
                     "gain": 0.01},
           "noise_pool": {"seed": 1303, "streams": 2},
           "warmup_episodes": 1, "profiled_episodes": 1,
           "snapshot_steps": 2}
LIMITS = {"check": {"samples": 4, "step_range": 6, "closure_lanes": 2},
          "limits": {"input_gap": 0.3, "plant_gap": 0.001,
                     "rejected_pct": 100.0, "mismatches": 0}}

RUN = """
import json, lmpc_bench
from lmpc_bench import run
bench, c, S = run.prepare(%r, device="cpu", batch=4)
out = run.measure(bench, c, S, 3000000019, 0.0, False, log=lambda *a: None)
out.pop("_numbers")
print(lmpc_bench.__file__)
print(json.dumps(out))
""" % CELL


def _hashes(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_the_lmpc_stage_is_the_default():
    c = spec.cell("lmpc_b256.converged_lap")
    assert "stage" not in c.config and c.stage == stages.DEFAULT == "lmpc"
    st = stages.load(c.stage)
    for hook in ("setup", "run_episode", "collect", "work", "judge"):
        assert callable(getattr(st, hook)), hook
    assert len(st.keep_fields) == 2


def test_a_new_stage_is_found_by_name_and_runs_to_a_result(tmp_path):
    root = tmp_path / "lmpc_bench"
    shutil.copytree(REPO / "lmpc_bench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "ltv_probe",
                               "traffic": "pid_probe", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "stages" / "ltv_probe.py").write_text(STAGE)
    (root / "configs" / "ltv_probe.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "pid_probe.json").write_text(json.dumps(TRAFFIC))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    before = _hashes(tmp_path)

    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONDONTWRITEBYTECODE="1",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    where, line = p.stdout.strip().splitlines()[-2:]
    assert pathlib.Path(where).resolve().parent == root.resolve()
    out = json.loads(line)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6 * 4               # every step live
    assert list(out)[-1] == "checks"
    assert _hashes(tmp_path) == before
