"""The port's per-step archive (``run_lap(collect_fn=...)``) against the
reference's ``jax.vmap(run_lap)`` in float64, noise off, on a short oval.

The reference stacks ``collect_fn``'s leaves on a time axis inside each
scenario, so its vmapped result is (B, T, ...); the port's must be the
same: to 1e-9 for the PID archive, and for the LMPC predictions as far as
the two LMPC controllers agree (see that test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from racinglmpc_tpu.controllers import lmpc as jlmpc
from racinglmpc_tpu.controllers.pid import make_pid_controller as jpid
from racinglmpc_tpu.models import track as jtrack
from racinglmpc_tpu.models.dynamics import PlantState as JPlant
from racinglmpc_tpu.runtime import loop as jloop
from racinglmpc_tpu.utils import config as jc
from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.controllers.pid import make_pid_controller as tpid
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.models.dynamics import PlantState as TPlant
from racinglmpc_tpu_torch.runtime import loop as tloop
from racinglmpc_tpu_torch.utils import config as tc
from racinglmpc_tpu_torch.utils.batched import bwhere

torch.set_num_threads(1)
B = 2
LKW = dict(N=6, num_ss_points=12, max_laps=6, max_pts=256, model_pts=128)
SPEC = np.array([[1.0, 0.0], [np.pi * 0.8, 0.8], [1.0, 0.0],
                 [np.pi * 0.8, 0.8]])


def _tracks():
    return (jtrack.make_track(SPEC, dtype=jnp.float64),
            ttrack.make_track(SPEC, dtype=torch.float64, device="cpu"))


def _x0():
    """Scenario 1 starts 0.3 m before the line: its lap ends within a few
    steps, scenario 0's does not."""
    x = np.zeros((B, 6))
    x[:, 0] = [0.5, 0.7]
    x[1, 4] = float(_tracks()[1].total_len) - 0.3
    return x


def _run_both(jstep, jstate, tstep, tstate, collect_j, collect_t, steps,
              **lap_kw):
    jt, tt = _tracks()
    x = _x0()
    ref = jax.vmap(lambda cs, p, k: jloop.run_lap(
        jstep, cs, p, k, trk=jt, vp=jc.VehicleParams(),
        sim_cfg=jc.SimConfig(noise=False), max_steps=steps,
        collect_fn=collect_j, **lap_kw))(
        jstate, JPlant(jnp.asarray(x), jnp.asarray(x)),
        jax.random.split(jax.random.PRNGKey(0), B))
    out = tloop.run_lap(
        tstep, tstate, TPlant(torch.tensor(x), torch.tensor(x)), trk=tt,
        vp=tc.VehicleParams(), sim_cfg=tc.SimConfig(noise=False),
        max_steps=steps, collect_fn=collect_t, **lap_kw)
    return ref, out


def _assert_trees_close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)


def test_collect_fn_archives_controller_state():
    """``tests/test_pred_archive.py``'s case, batched: the controller state
    is the applied input, archived doubled."""
    jp, _ = jpid(0.8, noise=False)
    tp, _ = tpid(0.8, noise=False)

    def jstep(state, x, key):
        _, u = jp((), x, key)
        return u, u

    def tstep(state, x, draws):
        _, u = tp((), x, draws)
        return u, u

    ref, out = _run_both(jstep, jnp.zeros((B, 2)), tstep,
                         torch.zeros((B, 2), dtype=torch.float64),
                         lambda st: st * 2.0, lambda st: st * 2.0, 12,
                         multi_lap=True)
    assert tuple(out.collected.shape) == (B, 12, 2)
    _assert_trees_close(out.collected, ref.collected)
    np.testing.assert_allclose(out.collected.numpy(), 2.0 * out.u.numpy(),
                               rtol=0, atol=1e-12)


def _lmpc_states():
    """The reference's seeded LMPC state (a PID lap of the oval stored
    ``num_ss_it`` times) and the port's copy of it."""
    jt, tt = _tracks()
    jcfg, tcfg = jc.LMPCConfig(**LKW), tc.LMPCConfig(**LKW)
    solver_j, solver_t = jc.SolverConfig.throughput(), \
        tc.SolverConfig.throughput()
    pid, _ = jpid(0.8, noise=False)
    x0 = jnp.asarray([0.5, 0, 0, 0, 0, 0.0])
    lap = jloop.run_lap(pid, (), JPlant(x0, x0), jax.random.PRNGKey(1),
                        trk=jt, vp=jc.VehicleParams(),
                        sim_cfg=jc.SimConfig(noise=False), max_steps=120,
                        multi_lap=True)

    def one(_):
        st = jlmpc.init_lmpc_state(jcfg, dtype=jnp.float64, solver=solver_j)
        for _ in range(jcfg.num_ss_it):
            st = jlmpc.lmpc_add_trajectory(st, jcfg, lap.x, lap.u, lap.x_glob,
                                           lap.steps, jt.total_len)
        return st

    jstate = jax.vmap(one)(jnp.arange(B))
    tstate = convert.from_jax(
        tlmpc.LMPCState, jax.tree_util.tree_map(np.asarray, jstate._asdict()),
        device="cpu")
    jstep = jlmpc.make_lmpc(jcfg, jt, solver_j, 0.1, dtype=jnp.float64)
    tctrl = tlmpc.make_lmpc(tcfg, tt, solver_t, 0.1, dtype=torch.float64)
    return jstep, jstate, tctrl.step, tstate


def test_collect_fn_archives_lmpc_predictions():
    """The predicted-trajectory store: (x_pred, u_pred) of every step's new
    LMPC state, through a lap that ends for one scenario and not the
    other. The archive holds exactly what the port's controller returns
    when stepped by hand on the recorded states, done-freeze included, and
    has the reference's shapes and mask. Its values are the two LMPC
    controllers' and agree as those do: the FTOCP's optimum is not unique
    (Q = 0; the safe-set multipliers), so the two solvers' float64 paths
    land on different points of it (``tests/test_torch_lmpc.py`` holds
    the applied inputs at 1e-7), and 8 closed-loop steps carry that into
    the predictions beyond the 1e-9 the PID archive meets."""
    jstep, jstate, tstep, tstate = _lmpc_states()
    ref, out = _run_both(jstep, jstate, tstep, tstate,
                         lambda st: (st.x_pred, st.u_pred),
                         lambda st: (st.x_pred, st.u_pred), 8)
    N = LKW["N"]
    assert tuple(out.collected[0].shape) == (B, 8, N + 1, 6)
    assert tuple(out.collected[1].shape) == (B, 8, N, 2)
    assert out.mask[0].all() and not out.mask[1].all()
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    st = tstate
    for t in range(8):
        new, _ = tstep(st, out.x[:, t], None)
        assert torch.equal(out.collected[0][:, t], new.x_pred)
        assert torch.equal(out.collected[1][:, t], new.u_pred)
        st = bwhere(~out.mask[:, t], st, new)
    for g, w in zip(out.collected, ref.collected):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-5)


def test_collect_fn_none_leaves_collected_none():
    _, tt = _tracks()
    tp, _ = tpid(0.8, noise=False)
    x = torch.tensor(_x0())
    out = tloop.run_lap(tp, (), TPlant(x, x.clone()), trk=tt,
                        vp=tc.VehicleParams(),
                        sim_cfg=tc.SimConfig(noise=False), max_steps=3)
    assert out.collected is None
