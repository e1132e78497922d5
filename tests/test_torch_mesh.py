"""The port's scenario mesh (``parallel/mesh.py``) and the sharded
experiment, on gloo ranks on the CPU.

- the sharding rule (a leaf whose leading dimension divides by the mesh
  size keeps this rank's rows, any other leaf is replicated), and a shard /
  gather round trip over 2 ranks;
- ``init_multi_host`` is a no-op without torchrun's environment, and a mesh
  that created its own group destroys it;
- mirroring ``tests/test_sharded_experiment.py``: the PID stage (PID and
  plant noise on) over 2 ranks equals the unsharded run, bit for bit;
- mirroring the first stage of ``__graft_entry__.dryrun_multichip``: one
  LMPC step (plant noise on) over 2 ranks equals the unsharded step, and
  ``cross_scenario_metrics`` equals torch's mean / min / max;
- an LMPC run over 2 ranks, checkpointed after lap 1 and resumed, equals
  the uninterrupted run over 2 ranks, and rank 0's checkpoint holds the
  whole batch.

A multi-lap LMPC run over 2 ranks is not held to the unsharded run bit for
bit on the CPU: the plain solver runs its rho-escalation rescue on the
sub-batch of lanes that need it, and a sub-batch of one lane takes MKL's
matrix-vector product, whose sums round differently from the batched
product, so a lane whose rescue runs alone on its rank (beside another
lane on one rank) rounds differently (``ROADMAP.md`` C).

Multi-rank cases start 2 worker processes of this file with torchrun's
environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), as ``tests/test_multihost.py`` starts its workers; they
meet through a ``FileStore`` in the test's ``tmp_path``, so parallel test
workers never share a rendezvous. Each rank writes what it returned to an
``.npz``; the test compares both ranks with the unsharded run made here.

    python tests/test_torch_mesh.py <case> <out_dir>    (one rank)
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from racinglmpc_tpu_torch.controllers import lmpc as tlmpc
from racinglmpc_tpu_torch.models import track as ttrack
from racinglmpc_tpu_torch.parallel import mesh as mesh_mod
from racinglmpc_tpu_torch.runtime import experiment as texp
from racinglmpc_tpu_torch.runtime import loop as tloop
from racinglmpc_tpu_torch.utils import config as tc

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
RANKS = 2


# ---- the cases, shared by the workers and the unsharded runs -------------

def _pid_run(mesh=None):
    cfg = texp.ExperimentConfig(stage_steps=40)     # PID + plant noise on
    res = texp.run_experiment(cfg, batch=4, stages="pid", device="cpu",
                              seed=5, mesh=mesh)
    return {"x": res.pid.x, "u": res.pid.u, "x_glob": res.pid.x_glob,
            "steps": res.pid.steps, "x_final": res.pid.plant_final.x}


def _tiny_lmpc():
    """``__graft_entry__._tiny_cfg`` / ``_seeded_state``, batched."""
    cfg = tc.LMPCConfig(max_laps=6, max_pts=64, model_pts=32)
    solver = tc.SolverConfig(max_iter=20, scaling_iters=2, polish=False)
    trk = ttrack.make_track(device="cpu")
    T = cfg.model_pts
    t = torch.linspace(0.0, 1.2, T)
    x = torch.stack([0.8 * torch.ones(T), torch.zeros(T), torch.zeros(T),
                     torch.zeros(T), t * trk.total_len,
                     0.05 * torch.sin(6.28 * t)], 1)
    return cfg, solver, trk, x


def _lmpc_step(mesh=None, batch=4):
    cfg, solver, trk, x = _tiny_lmpc()
    state = tlmpc.init_lmpc_state(cfg, batch, solver=solver, device="cpu")
    xb = x.expand(batch, -1, -1)
    ub = torch.zeros((batch, x.shape[0], 2))
    steps = torch.full((batch,), x.shape[0], dtype=torch.int32)
    for _ in range(cfg.num_ss_it):
        state = tlmpc.lmpc_add_trajectory(state, cfg, xb, ub, xb, steps,
                                          trk.total_len)
    plant = texp.initial_plant(batch, device="cpu")
    rows = None
    if mesh is not None:
        state, plant = mesh_mod.shard_scenario_tree((state, plant), mesh)
        rows = mesh.rows(batch)
    ctrl = tlmpc.make_lmpc(cfg, trk, solver, 0.1)
    sim = tc.SimConfig()
    gen = torch.Generator().manual_seed(0)
    _, draws = tloop.gaussian_noise(batch, 0, sim, gen, device="cpu",
                                    rows=rows)(0)
    state, u = ctrl.step(state, plant.x, None)
    plant = tloop.plant_step(plant, u, tc.VehicleParams(), trk, sim, draws,
                             ttrack.track_table(trk))
    s = plant.x[:, 4]
    if mesh is None:
        met = {"mean": s.mean(), "min": s.min(), "max": s.max()}
    else:
        met = mesh_mod.cross_scenario_metrics(s, mesh)
        u, plant = mesh_mod.gather_scenario_tree((u, plant), mesh)
    return {"u": u, "x": plant.x, "x_glob": plant.x_glob,
            **{f"m_{k}": v for k, v in met.items()}}


def _oval():
    spec = np.array([[1.0, 0.0], [np.pi * 0.8, 0.8], [1.0, 0.0],
                     [np.pi * 0.8, 0.8]])
    return ttrack.make_track(spec, dtype=torch.float32, device="cpu")


def _lmpc_cfg(n_laps):
    return texp.ExperimentConfig(
        N=6, stage_steps=60, n_lmpc_laps=n_laps, lap_max_steps=40,
        lap_chunk=20, solver=tc.SolverConfig.throughput(),
        lmpc=tc.LMPCConfig(N=6, num_ss_points=12, max_laps=8, max_pts=256,
                           model_pts=128))


def _resume(mesh, out):
    """Uninterrupted 2-lap run, then 1 lap with a checkpoint resumed to 2,
    and the checkpoint as rank 0 wrote it."""
    kw = dict(batch=4, stages="pid,lmpc", trk=_oval(), device="cpu", seed=3,
              mesh=mesh)
    got = {}
    full = texp.run_experiment(_lmpc_cfg(2), **kw)
    ckpt = os.path.join(out, "ckpt")
    texp.run_experiment(_lmpc_cfg(1), checkpoint_dir=ckpt, **kw)
    with np.load(os.path.join(ckpt, "lmpc.npz")) as z:
        got["ckpt_rows"] = torch.tensor(z["a0"].shape[0])
    res = texp.run_experiment(_lmpc_cfg(2), checkpoint_dir=ckpt, resume=True,
                              **kw)
    for tag, r in (("full", full), ("res", res)):
        got.update({f"{tag}_lap_steps": torch.from_numpy(r.lap_steps),
                    f"{tag}_lap_times": torch.from_numpy(r.lap_times),
                    f"{tag}_resume_lap": torch.tensor(r.resume_lap),
                    f"{tag}_last_x": r.lmpc_laps[-1].x,
                    f"{tag}_ss_x": r.lmpc_state.ss.x,
                    f"{tag}_ss_qfun": r.lmpc_state.ss.qfun})
    return got


def _roundtrip(mesh):
    """Shard a tree with a divisible leaf, a non-divisible leaf and a
    scalar; gather the divisible leaf back."""
    tree = (torch.arange(12.0).reshape(6, 2), torch.arange(3.0),
            torch.tensor(7.0))
    a, b, c = mesh_mod.shard_scenario_tree(tree, mesh)
    return {"local": a, "replicated": b, "scalar": c,
            "gathered": mesh_mod.gather_scenario_tree(a, mesh)}


CASES = {"pid": _pid_run, "lmpc_step": _lmpc_step, "roundtrip": _roundtrip}


def _worker(case: str, out: str) -> None:
    n = mesh_mod.init_multi_host(init_method=f"file://{out}/store_{case}",
                                 backend="gloo")
    assert n == RANKS, n
    mesh = mesh_mod.make_mesh("cpu")
    assert (mesh.size, mesh.rank) == (RANKS, int(os.environ["RANK"]))
    got = _resume(mesh, out) if case == "resume" else CASES[case](mesh)
    np.savez(os.path.join(out, f"{case}_{mesh.rank}.npz"),
             **{k: v.numpy() for k, v in got.items()})
    dist.destroy_process_group()


def _launch(case: str, tmp_path) -> list:
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(RANKS),
                   RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT="0", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, HERE, case, str(tmp_path)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    return [dict(np.load(tmp_path / f"{case}_{r}.npz")) for r in range(RANKS)]


def _same_on_both_ranks(got, want):
    for r, g in enumerate(got):
        assert set(g) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(g[k], v.numpy(),
                                          err_msg=f"rank {r}: {k}")


# ---- in-process tests ------------------------------------------------------

def test_sharding_rule_without_collectives():
    """Placement needs no group: rank 1 of 2 keeps rows 3..5 of a 6-row
    leaf, replicates a 3-row leaf and a scalar."""
    mesh = mesh_mod.ScenarioMesh(group=None, rank=1, size=2,
                                 device=torch.device("cpu"))
    a, b, c = mesh_mod.shard_scenario_tree(
        (torch.arange(6.0), torch.arange(3.0), torch.tensor(2.0)), mesh)
    np.testing.assert_array_equal(a.numpy(), [3.0, 4.0, 5.0])
    np.testing.assert_array_equal(b.numpy(), [0.0, 1.0, 2.0])
    assert c.dim() == 0 and float(c) == 2.0
    assert mesh.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.rows(5)


def test_init_multi_host_is_a_noop_without_torchrun(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.init_multi_host() == 1
    assert not dist.is_initialized()


def test_own_group_is_destroyed_and_cuda_is_never_dropped():
    with mesh_mod.make_mesh("cpu") as mesh:
        assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
        assert dist.get_backend() == "gloo" and mesh.owns_group
        t = torch.arange(4.0)
        np.testing.assert_array_equal(
            mesh_mod.gather_tensor(t, mesh).numpy(), t.numpy())
        assert bool(mesh_mod.all_ranks(torch.tensor([True, True]), mesh))
        assert not bool(mesh_mod.all_ranks(torch.tensor([True, False]),
                                           mesh))
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        # the default device is the card: no quiet drop to gloo / CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()
        assert not dist.is_initialized()


def test_one_rank_mesh_runs_the_pid_stage_unchanged():
    want = _pid_run()
    with mesh_mod.make_mesh("cpu") as mesh:
        got = _pid_run(mesh)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


# ---- 2 gloo ranks ----------------------------------------------------------

def test_two_rank_shard_gather_roundtrip(tmp_path):
    got = _launch("roundtrip", tmp_path)
    full = np.arange(12.0).reshape(6, 2)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["local"], full[3 * r:3 * r + 3])
        np.testing.assert_array_equal(g["replicated"], np.arange(3.0))
        assert float(g["scalar"]) == 7.0
        np.testing.assert_array_equal(g["gathered"], full)


def test_two_rank_pid_stage_equals_unsharded(tmp_path):
    _same_on_both_ranks(_launch("pid", tmp_path), _pid_run())


def test_two_rank_lmpc_step_and_metrics_equal_unsharded(tmp_path):
    got = _launch("lmpc_step", tmp_path)
    want = _lmpc_step()
    for r, g in enumerate(got):
        for k in ("u", "x", "x_glob", "m_min", "m_max"):
            np.testing.assert_array_equal(g[k], want[k].numpy(),
                                          err_msg=f"rank {r}: {k}")
        # the mean sums each rank's rows, then the two partial sums
        np.testing.assert_allclose(g["m_mean"], want["m_mean"].numpy(),
                                   rtol=1e-6)
    assert np.isfinite(got[0]["u"]).all()


def test_two_rank_resume_equals_uninterrupted(tmp_path):
    got = _launch("resume", tmp_path)
    for r, g in enumerate(got):
        assert int(g["ckpt_rows"]) == 4          # the gathered batch
        assert int(g["res_resume_lap"]) == 1 and int(g["full_resume_lap"]) == 0
        for k in ("lap_steps", "lap_times", "last_x", "ss_x", "ss_qfun"):
            np.testing.assert_array_equal(g[f"res_{k}"], g[f"full_{k}"],
                                          err_msg=f"rank {r}: {k}")
            np.testing.assert_array_equal(g[f"res_{k}"], got[0][f"res_{k}"])
        assert g["full_lap_steps"].shape == (4, 2)
        assert np.isfinite(g["full_last_x"]).all()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
