"""The port's sharded giant-QP solver (``ops/qp_sharded.py``) against the
float64 interior-point oracle, the port's dense solver and the JAX
package's ``solve_sharded``, at 1 rank (in process) and 2 gloo ranks.

The cases of ``tests/test_qp_sharded.py``: the oracle (n = 64), the dense
solver (n = 48 and the product FTOCP's size, n = 200, m = 257), the padding
path (n = 37, m = 23; padded at 2 ranks), the warm start (at most half the
cold iterations), the row blocks (each rank holds n/p rows of P) and the
refinement tail (a loose solve's primal residual cut by 5x, the solution
closer to the oracle).

Against JAX (float64, the same QP, a JAX mesh of as many devices as the
port has ranks): x within 1e-6, the same ``solved`` and the same ``iters``
(the residual checks fall on multiples of ``check_every``, and these QPs
converge well above the float64 noise floor), and ``cg_iters`` within 2% of
JAX's: each CG solve stops on the first iteration whose residual is below
``cg_tol`` (1e-10 relative), and the port's and XLA's matrix-vector products
sum in another order, so a solve can stop one iteration earlier or later.

Two-rank cases run in 2 worker processes of this file (torchrun's
environment, a ``FileStore`` in the test's temporary directory), once for
the module; each rank writes its results to an ``.npz``.

    python tests/test_torch_qp_sharded.py <out_dir>    (one rank)
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from racinglmpc_tpu_torch import convert
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.ops import qp_sharded as tqs
from racinglmpc_tpu_torch.parallel import mesh as mesh_mod
from racinglmpc_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
INF = float("inf")
TIGHT = dict(max_iter=2000, eps_abs=1e-7, eps_rel=1e-7, cg_tol=1e-10)
LOOSE = dict(max_iter=600, eps_abs=1e-3, eps_rel=1e-3, polish=False)
POLISHED = dict(max_iter=600, eps_abs=1e-3, eps_rel=1e-3, polish=True,
                polish_iters=80, cg_tol=1e-10)


def random_qp(seed, n=64, me=12, mi=40):
    """``tests/test_qp_sharded._random_qp``: (H, q, G, g, F, b)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = M.T @ M / n + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    G = rng.normal(size=(me, n))
    F = rng.normal(size=(mi, n))
    z0 = rng.normal(size=n) * 0.3
    g = G @ z0
    b = F @ z0 + np.abs(rng.normal(size=mi)) + 0.05
    return H, q, G, g, F, b


def osqp_form(H, q, G, g, F, b):
    """(P, q, A, l, u) numpy arrays, inequality rows first."""
    A = np.vstack([F, G])
    l = np.concatenate([-INF * np.ones(F.shape[0]), g])
    u = np.concatenate([b, g])
    return H, q, A, l, u


def to_port(arrs):
    return tqp.QPData(*(torch.from_numpy(np.asarray(a))[None] for a in arrs))


def oracle(seed, **dims):
    from tests.oracles import qp_ip

    z, *_, ok = qp_ip.solve_qp(*random_qp(seed, **dims))
    assert ok
    return z


def _summary(sol):
    return {"x": sol.x.numpy(), "y": sol.y.numpy(),
            "pri": float(sol.pri_res), "dua": float(sol.dua_res),
            "solved": bool(sol.solved), "iters": int(sol.iters),
            "cg": int(sol.cg_iters)}


def run_cases(mesh) -> dict:
    """The solves both rank counts run; keys name the case."""
    def solve(seed, dims, cfg, warm=None):
        qp = to_port(osqp_form(*random_qp(seed, **dims)))
        kw = {} if warm is None else dict(x_warm=warm.x, y_warm=warm.y)
        return tqs.solve_sharded(qp, mesh, tqs.ShardedSolverConfig(**cfg),
                                 **kw)

    out = {}
    cold = solve(0, {}, TIGHT)
    out["oracle"] = _summary(cold)
    out["warm"] = _summary(solve(0, {}, TIGHT, warm=cold))
    out["padding"] = _summary(solve(7, dict(n=37, me=5, mi=18), TIGHT))
    for tag, cfg in (("loose", LOOSE), ("polished", POLISHED)):
        out[tag] = _summary(solve(21, dict(n=96, me=16, mi=56), cfg))
    blk = tqs.local_blocks(to_port(osqp_form(*random_qp(11))), mesh)
    out["blocks"] = {"P_l": tuple(blk.P_l.shape), "A_l": tuple(blk.A_l.shape),
                     "row0": blk.row0}
    return out


def _check_cases(out, p):
    z = oracle(0)
    o = out["oracle"]
    assert o["solved"] and o["iters"] < 2000 and o["cg"] > 0
    np.testing.assert_allclose(o["x"], z, atol=5e-5)
    w = out["warm"]
    assert w["solved"] and w["iters"] <= o["iters"] // 2
    np.testing.assert_allclose(w["x"], o["x"], atol=1e-5)
    pad = out["padding"]
    assert pad["solved"]
    assert pad["x"].shape == (37,) and pad["y"].shape == (23,)
    np.testing.assert_allclose(pad["x"], oracle(7, n=37, me=5, mi=18),
                               atol=5e-5)
    s0, s1 = out["loose"], out["polished"]
    assert s0["solved"] and s1["solved"]
    assert s1["pri"] < 0.2 * s0["pri"], (s0["pri"], s1["pri"])
    assert s1["dua"] < 2.0 * s0["dua"] + 1e-3
    z21 = oracle(21, n=96, me=16, mi=56)
    assert np.abs(s1["x"] - z21).max() < np.abs(s0["x"] - z21).max()
    # n = 64, m = 52: each rank holds n/p rows of P and m/p of A
    assert out["blocks"]["P_l"] == (64 // p, 64)
    assert out["blocks"]["A_l"] == (52 // p, 64)


def _same_as_jax(port, seed, dims, devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from racinglmpc_tpu.ops import qp as jqp
    from racinglmpc_tpu.ops import qp_sharded as jqs

    arrs = osqp_form(*random_qp(seed, **dims))
    mesh = Mesh(np.asarray(jax.devices()[:devices]), (jqs.BLOCK_AXIS,))
    js = jqs.solve_sharded(jqp.QPData(*(jnp.asarray(a) for a in arrs)), mesh,
                           cfg=jqs.ShardedSolverConfig(**TIGHT))
    np.testing.assert_allclose(port["x"], np.asarray(js.x), atol=1e-6)
    assert port["solved"] == bool(js.solved)
    assert port["iters"] == int(js.iters)
    assert abs(port["cg"] - int(js.cg_iters)) <= 0.02 * int(js.cg_iters)


def test_config_defaults_equal_reference():
    from racinglmpc_tpu.ops import qp_sharded as jqs

    assert convert.config_from_jax(tqs.ShardedSolverConfig,
                                   jqs.ShardedSolverConfig()) \
        == tqs.ShardedSolverConfig()
    assert tqs.BLOCK_AXIS == jqs.BLOCK_AXIS
    with pytest.raises(ValueError, match="no field"):
        convert.config_from_jax(tqs.ShardedSolverConfig, {"warp": 1})


# ---- one rank, in process --------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    with mesh_mod.make_mesh("cpu", axis_name=tqs.BLOCK_AXIS) as mesh:
        yield mesh, run_cases(mesh)


def test_one_rank_cases_match_oracle(one_rank):
    _check_cases(one_rank[1], 1)


@pytest.mark.parametrize("seed,dims,atol,max_iter", [
    (3, dict(n=48, me=8, mi=30), 1e-4, 2000),
    (42, dict(n=200, me=97, mi=160), 2e-4, 3000)])
def test_one_rank_matches_dense_solver(one_rank, seed, dims, atol, max_iter):
    qp = to_port(osqp_form(*random_qp(seed, **dims)))
    dense = tqp.solve(qp, SolverConfig(max_iter=max_iter, eps_abs=1e-7,
                                       eps_rel=1e-7, polish=False))
    sol = tqs.solve_sharded(qp, one_rank[0], tqs.ShardedSolverConfig(
        **dict(TIGHT, max_iter=max_iter)))
    assert bool(dense.solved[0]) and bool(sol.solved)
    np.testing.assert_allclose(sol.x.numpy(), dense.x[0].numpy(), atol=atol)


def test_padding_and_refusals(one_rank):
    P, q, A, l, u, n, m = tqs._pad_qp(
        to_port(osqp_form(*random_qp(7, n=37, me=5, mi=18))), 8)
    assert (n, m) == (37, 23) and P.shape == (40, 40) and A.shape == (24, 40)
    np.testing.assert_array_equal(torch.diagonal(P)[37:].numpy(), 1.0)
    assert bool(torch.isinf(l[23:]).all() and torch.isinf(u[23:]).all())
    assert not A[23:].any() and not A[:, 37:].any() and not q[37:].any()
    qp = to_port(osqp_form(*random_qp(0)))
    with pytest.raises(ValueError, match="batch of 1"):
        tqs.solve_sharded(tqp.QPData(*(torch.cat([t, t]) for t in qp)),
                          one_rank[0])
    wrong = mesh_mod.ScenarioMesh(group=None, rank=0, size=1,
                                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="'block'"):
        tqs.solve_sharded(qp, wrong)


@pytest.mark.parametrize("case,seed,dims", [
    ("oracle", 0, {}), ("padding", 7, dict(n=37, me=5, mi=18))])
def test_one_rank_equals_jax(one_rank, case, seed, dims):
    _same_as_jax(one_rank[1][case], seed, dims, devices=1)


def test_iteration_accounting_keeps_the_reference_quirks(one_rank):
    """max_iter below check_every still runs one whole chunk; the
    refinement tail's iterations do not count in ``iters``."""
    qp = to_port(osqp_form(*random_qp(0)))
    short = tqs.solve_sharded(qp, one_rank[0], tqs.ShardedSolverConfig(
        max_iter=10, check_every=25, polish=False))
    chunk = tqs.solve_sharded(qp, one_rank[0], tqs.ShardedSolverConfig(
        max_iter=25, check_every=25, polish=False))
    np.testing.assert_array_equal(short.x.numpy(), chunk.x.numpy())
    assert int(short.cg_iters) == int(chunk.cg_iters)
    pol = tqs.solve_sharded(qp, one_rank[0], tqs.ShardedSolverConfig(
        max_iter=25, check_every=25, polish=True))
    assert int(pol.iters) == int(chunk.iters)
    assert int(pol.cg_iters) > int(chunk.cg_iters)


# ---- two gloo ranks --------------------------------------------------------

def _worker(out: str) -> None:
    mesh_mod.init_multi_host(init_method=f"file://{out}/store",
                             backend="gloo")
    mesh = mesh_mod.make_mesh("cpu", axis_name=tqs.BLOCK_AXIS)
    res = run_cases(mesh)
    flat = {f"{c}.{k}": np.asarray(v) for c, d in res.items()
            for k, v in d.items()}
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **flat)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("qp_sharded")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT="0", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, HERE, str(out)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{so}\n{se}"
    ranks = []
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as z:
            res = {}
            for key in z.files:
                case, k = key.split(".")
                v = z[key]
                res.setdefault(case, {})[k] = (v.item() if v.ndim == 0
                                               else v)
            res["blocks"] = {k: tuple(np.atleast_1d(v)) if k != "row0"
                             else int(v) for k, v in res["blocks"].items()}
            ranks.append(res)
    return ranks


def test_two_rank_cases_match_oracle(two_ranks):
    for res in two_ranks:
        _check_cases(res, 2)
    assert two_ranks[0]["blocks"]["row0"] == 0
    assert two_ranks[1]["blocks"]["row0"] == 32


def test_two_ranks_agree(two_ranks):
    """Replicated outputs are identical on both ranks."""
    a, b = two_ranks
    for case in ("oracle", "warm", "padding", "loose", "polished"):
        for k in ("x", "y", "pri", "dua", "solved", "iters", "cg"):
            np.testing.assert_array_equal(a[case][k], b[case][k],
                                          err_msg=f"{case}.{k}")


@pytest.mark.parametrize("case,seed,dims", [
    ("oracle", 0, {}), ("padding", 7, dict(n=37, me=5, mi=18))])
def test_two_ranks_equal_jax(two_ranks, case, seed, dims):
    _same_as_jax(two_ranks[0][case], seed, dims, devices=2)


if __name__ == "__main__":
    _worker(sys.argv[1])
