"""The harness's own arithmetic and discovery, on the CPU: a cell, a mix, a
limits file and a per-layer metric are found by name; the rate counts live
steps only and the tail is over every step; busy time is a union; the
roofline counts match a hand count; nothing the benchmark runs loads JAX
or the JAX package."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lmpc_bench import run, spec, trace
from lmpc_bench.roofline import admm, rollout, sysid
from lmpc_bench.stages import lmpc as lmpc_stage

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_benchmark_names_files_that_exist():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        assert set(c.limits["limits"]) >= {"input_gap", "plant_gap",
                                           "rejected_pct", "mismatches"}
    for m in bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries only."""
    root = tmp_path / "lmpc_bench"
    shutil.copytree(os.path.join(REPO, "lmpc_bench"), root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    cfg = json.loads((root / "configs" / "lmpc_b256.json").read_text())
    cfg["name"] = "lmpc_b64"
    cfg["port"]["batch"] = 64
    (root / "configs" / "lmpc_b64.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "converged_lap.json").read_text())
    mix.update(name="pid_lap", seed_laps={"file": "data/pid_lap.npz",
                                          "layout": "lap", "copies": 4})
    (root / "traffic" / "pid_lap.json").write_text(json.dumps(mix))
    lim = (root / "limits" / "lmpc_b256.converged_lap.json").read_text()
    (root / "limits" / "lmpc_b64.pid_lap.json").write_text(lim)
    (root / "metrics" / "lap.closure_count.py").write_text(
        "def read(rec):\n    return rec['counters']['closures']\n")
    bench["workloads"].append({"name": "lmpc_b64.pid_lap",
                               "config": "lmpc_b64", "traffic": "pid_lap",
                               "chips": 1, "why": "test"})
    c = spec.cell("lmpc_b64.pid_lap", bench, root=root)
    assert c.config["port"]["batch"] == 64
    assert c.stage == "lmpc"           # no "stage" key: the LMPC stage
    laps = lmpc_stage.seed_laps(c.traffic, root=root)
    assert len(laps) == 4 and laps[0][3] == 303
    lcfg, solver, sim = lmpc_stage.port_configs(c.config, c.traffic)
    assert lcfg.N == 14 and lcfg.num_ss_points == 48 and sim.dt == 0.1
    read = run.metric_reader("lap.closure_count", root=str(root))
    assert read({"counters": {"closures": 3}}) == 3


def test_port_configs_carry_the_upstream_settings():
    # the one-car configuration, kept for a later cell (PERF.md section 7)
    car = json.loads((spec.ROOT / "configs" / "lmpc_car.json").read_text())
    c = spec.cell("lmpc_b256.converged_lap")
    lcfg, solver, sim = lmpc_stage.port_configs(car, c.traffic)
    assert (lcfg.dR, lcfg.q_slack, lcfg.q_terminal_slack) == (
        (5.0, 50.0), (5.0, 25.0), 500.0)
    assert (lcfg.ey_max, lcfg.delta_max, lcfg.a_max) == (0.4, 0.5, 10.0)
    assert not lcfg.use_pallas_sysid and lcfg.model_pts == 1024
    assert solver.max_iter == 300 and solver.use_pallas
    assert sim.use_pallas_rollout and sim.noise_sigma == (0.01, 0.01, 0.005)
    lcfg, _, _ = lmpc_stage.port_configs(c.config, c.traffic, {"solver": {
        "pallas_iter_precision": "default"}})
    assert lcfg.use_pallas_sysid and lcfg.max_pts == 1024


def _episode(mask, rej, iters, calls):
    sr = SimpleNamespace(mask=torch.tensor(mask),
                         collected=(torch.tensor(rej), torch.tensor(iters)))
    return SimpleNamespace(sr=sr, calls=calls)


def test_the_rate_counts_live_steps_and_the_tail_all_steps():
    # two scenarios, 4 steps run; scenario 1 crossed after step 1
    ep = _episode([[True, True, True, True], [True, True, False, False]],
                  [[False, True, False, False], [False, False, True, True]],
                  [[10, 300, 20, 20], [30, 40, 0, 0]], 4)
    c = run.counters(SimpleNamespace(episodes=[ep, ep]))
    assert c == {"live": 12, "executed": 16, "rejected": 2,
                 "iters_live": 2 * (350 + 70)}
    ms = np.array([10.0] * 19 + [100.0])
    assert run.p95(ms) == pytest.approx(np.percentile(ms, 95))
    assert run.p95(ms) > 10.0          # the slow step is in the tail


def test_busy_time_is_the_union_of_overlapping_intervals():
    iv = np.array([[0, 10], [5, 15], [20, 30], [25, 26], [40, 41]],
                  dtype=np.int64)
    busy, merged = trace.union_seconds(iv)
    assert busy == pytest.approx(26e-9)
    assert merged.tolist() == [[0, 15], [20, 30], [40, 41]]
    host = [(16, 19, "cudaStreamSynchronize")]
    gaps = trace.idle_gaps(merged, host, 0, 50)
    assert gaps["in cudaStreamSynchronize"] == pytest.approx(5e-9)
    assert gaps["host work outside CUDA calls"] == pytest.approx(19e-9)


def test_kernel_names_are_classed_by_the_ports_kernels():
    assert trace.kernel_class("void admm_main_resident<0>(QPParams)") == \
        "admm"
    assert trace.kernel_class("admm_rescue_prologue") == "admm"
    assert trace.kernel_class("sysid_kernel") == "sysid"
    assert trace.kernel_class("rollout_kernel") == "rollout"
    assert trace.kernel_class("at::native::elementwise_kernel") == "other"
    assert trace.short("void admm_main_resident<0>(QPParams, float*)") == \
        "admm_main_resident"


def test_admm_counts_match_a_hand_count():
    """N = 1, K = 1: n = 2*6 + 2 + 2 + 1 + 6 = 23 variables. G: x0's
    identity (6), the dynamics row block's identity (6), A's pattern
    (9 + 5 + 5 + 4) and B's (3), the terminal block's identity, point and
    slack (6 + 6 + 6), the multipliers' sum (1): 57 in 19 rows. F: two ey
    rows with their slack (4), four input bounds (4), two slack signs (2),
    one multiplier sign (1): 11 in 9 rows. P: dR (2), the ey slacks (2),
    the terminal slack (6): 10."""
    n, m, nnz_a, nnz_p = admm.nonzeros(1, 1)
    assert (n, m, nnz_a, nnz_p) == (23, 28, 57 + 11, 10)
    ops, nbytes = admm.work({"N": 1, "K": 1, "refine_steps": 1,
                             "check_every": 4, "lanes": 1, "iters": 3,
                             "checks": 2})
    per_iter = 2 * 23 * 23 * 2 + 2 * 68 * 4 + 2 * 10 + 9 * (23 + 28)
    per_check = 4 * 68 + 2 * 10 + 10 * (23 + 28)
    assert ops == 3 * per_iter + 2 * per_check
    words = (2 * 23 * 23 + 28 * 23      # P, Kinv, A
             + 3 * 23 + 6 * 28 + 1      # q, D, x0; l, u, rho, E, z0, y0; c
             + 23 + 2 * 28 + 6)         # x, z, y, residuals, flags
    assert nbytes == 4 * words


def test_sysid_and_rollout_counts():
    ops, nbytes = sysid.work({"launches": 2, "batch": 3, "N": 14, "knn": 7,
                              "lap_rows": [10, 12]})
    cand, picks = 9 + 11, 7 * 2
    assert ops == 2 * 3 * 14 * (14 * cand + 104 * picks + 260)
    assert nbytes == 4 * 2 * 3 * (8 * 22 + 2 + 14 * 62)
    ops, nbytes = rollout.work({"launches": 5, "batch": 2, "substeps": 100})
    assert ops == 10 * 100 * 73 and nbytes == 4 * 10 * 26


def test_forbidden_names_are_compared_whole(monkeypatch):
    here = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, "racinglmpc_tpu_torch.x", here)
    assert "racinglmpc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "racinglmpc_tpu.utils", here)
    assert "racinglmpc_tpu" in run.forbidden_modules()


def test_the_benchmark_loads_no_jax():
    code = ("import sys, json; import lmpc_bench.run, lmpc_bench.cell, "
            "lmpc_bench.control, lmpc_bench.trace, lmpc_bench.reference, "
            "lmpc_bench.stages.lmpc; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "racinglmpc_tpu_torch" in top       # the port is what it runs
    assert not top & {"jax", "jaxlib", "flax", "racinglmpc_tpu"}
