"""The benchmark's frozen reference equals the repository's float64
oracles (``tests/oracles/``) on the same inputs: one plant step, one
sys-ID, one FTOCP with its interior-point solve; and it imports nothing of
the port, JAX or the JAX package."""
import importlib
import json
import os
import subprocess
import sys

import numpy as np

from lmpc_bench.reference import qp_ip, ref_controller, ref_ftocp, ref_plant
from lmpc_bench.reference import track as ref_track

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _original(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module(f"tests.oracles.{name}")


def _laps():
    f = np.load(os.path.join(REPO, "lmpc_bench", "data",
                             "converged_laps.npz"))
    return [(f[f"x{i}"][:int(f[f"steps{i}"])].astype(float),
             f[f"u{i}"][:int(f[f"steps{i}"])].astype(float))
            for i in range(int(f["n_laps"]))]


def test_plant_step_equals_the_original():
    trk = ref_track.table()
    curv = ref_plant.np_curvature_fn(trk)
    orig = _original("ref_plant")
    x = np.array([2.1, 0.05, 0.3, 0.1, 7.3, -0.12])
    g = np.array([2.1, 0.05, 0.3, 0.9, 3.0, 1.5])
    u = np.array([0.12, 0.7])
    w = np.array([0.3, -0.2, 0.1])
    a = ref_plant.plant_step(x, g, u, curv, noise=w)
    b = orig.plant_step(x, g, u, orig.np_curvature_fn(trk), noise=w)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)


def test_sysid_equals_the_original():
    trk = ref_track.table()
    curv = ref_plant.np_curvature_fn(trk)
    orig = _original("ref_controller")
    pa = ref_controller.RefPredictiveModel(curv, 4)
    pb = orig.RefPredictiveModel(curv, 4)
    for x, u in _laps():
        pa.add_trajectory(x, u)
        pb.add_trajectory(x, u)
    x, u = _laps()[1][0][20], _laps()[1][1][20]
    for p, q in zip(pa.regression_and_linearization(x, u),
                    pb.regression_and_linearization(x, u)):
        np.testing.assert_array_equal(p, q)


def test_ftocp_and_solve_equal_the_original():
    trk = ref_track.table()
    curv = ref_plant.np_curvature_fn(trk)
    laps = _laps()

    def step(mod):
        pm = mod.RefPredictiveModel(curv, 4)
        lm = mod.RefLMPC(14, np.array([5.0, 50.0]), (5.0, 25.0), 500.0, 48,
                         4, pm, trk.total_len)
        for x, u in laps:
            pm.add_trajectory(x, u)
            lm.add_trajectory(x, u)
        return lm.solve(np.array([0.5, 0, 0, 0, 0, 0])), lm.x_pred

    for p, q in zip(step(ref_controller), step(_original("ref_controller"))):
        np.testing.assert_array_equal(p, q)
    orig_ftocp, orig_qp = _original("ref_ftocp"), _original("qp_ip")
    A = [np.eye(6)] * 3
    B = [np.ones((6, 2))] * 3
    C = [np.zeros(6)] * 3
    args = (3, np.ones(6), np.ones(2), np.ones(2), np.ones(6), (1.0, 2.0),
            np.zeros(6), 0.4, 0.5, 10.0, A, B, C, np.ones(6), np.zeros(2))
    pa, pb = ref_ftocp.build_ftocp(*args), orig_ftocp.build_ftocp(*args)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    za = qp_ip.solve_qp(pa["H"], pa["q"], pa["G"], pa["g_eq"], pa["F"],
                        pa["b"])[0]
    zb = orig_qp.solve_qp(pb["H"], pb["q"], pb["G"], pb["g_eq"], pb["F"],
                          pb["b"])[0]
    np.testing.assert_array_equal(za, zb)


def test_track_table_matches_the_reference_spec():
    t = ref_track.table()
    assert t.s0.shape == (7,) and t.curv.shape == (7,)
    np.testing.assert_allclose(t.s0[1:6], np.cumsum(ref_track.SPEC[:5, 0]))
    assert 19.0 < t.total_len < 20.0


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, json; import lmpc_bench.reference.ref_controller, "
            "lmpc_bench.reference.track, lmpc_bench.judge; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "racinglmpc_tpu",
                      "racinglmpc_tpu_torch", "torch", "tests"}
