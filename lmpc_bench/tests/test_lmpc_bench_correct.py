"""``correct`` on the CPU at a small batch: a sound run passes; the
control and each fault this system can have, planted under the timed path,
fail. The harness's look for a card is skipped (``run.prepare`` /
``run.measure`` with ``device="cpu"``); the kernels run their plain
versions. On a card (``-m cuda``) the command line runs each cell briefly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from lmpc_bench import control, run, spec
from racinglmpc_tpu_torch.models.dynamics import PlantState
from racinglmpc_tpu_torch.runtime import loop
from racinglmpc_tpu_torch.utils.batched import bwhere

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "lmpc_b256.converged_lap"
SEED = 3_000_000_019       # wider than 32 signed bits


@pytest.fixture(scope="module")
def cpu_cell():
    torch.set_num_threads(1)
    return run.prepare(CELL, device="cpu", batch=2)


def measure(cpu_cell, breaker=None):
    bench, c, S = cpu_cell
    return run.measure(bench, c, S, SEED, 0.0, False, breaker=breaker,
                       log=lambda *a: None)


def test_a_sound_run_is_correct(cpu_cell):
    out = measure(cpu_cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 100 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"solves_per_s"}    # no card: no events


def _unchanged(clock, S):
    clock.step = lambda st, x, draws: (st, st.u_old)


def _half_left_out(clock, S):
    step = clock.step

    def broken(st, x, draws):
        new, u = step(st, x, draws)
        h = u.shape[0] // 2
        rest = torch.arange(u.shape[0]) >= h
        u = u.clone()
        u[h:] = u[:h].mean(0)
        return bwhere(rest, st, new), u
    clock.step = broken


def _answer_altered(clock, S):
    step = clock.step

    def broken(st, x, draws):
        new, u = step(st, x, draws)
        return new, u * torch.tensor([-1.0, 1.0])
    clock.step = broken


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_step_is_not_correct(cpu_cell, fault):
    assert not measure(cpu_cell, fault)["correct"]


def test_an_altered_plant_answer_is_not_correct(cpu_cell, monkeypatch):
    step = loop.plant_step

    def broken(plant, u, vp, trk, sim_cfg, draws, table):
        out = step(plant, u, vp, trk, sim_cfg, draws, table)
        return PlantState(x=out.x + torch.tensor([0, 0, 0, 0, 0.01, 0]),
                          x_glob=out.x_glob)
    monkeypatch.setattr(loop, "plant_step", broken)
    out = measure(cpu_cell)
    assert not out["correct"]
    assert out["checks"]["plant_gap"]["value"] > out["checks"]["plant_gap"][
        "limit"]


def test_the_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(loop, "plant_step", loop.plant_step)
    torch.set_num_threads(1)
    (seed, out), = control.readings(CELL, "default", [SEED + 1], 0.0,
                                    device="cpu", batch=2, log=lambda m: None)
    assert not out["correct"]
    # on the card B1 at "default" has every solve rejected as well; its
    # plain version here may not, so only the plant's number is held
    chk = out["checks"]["plant_gap"]
    assert chk["value"] > chk["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_each_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "lmpc_bench.run", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
