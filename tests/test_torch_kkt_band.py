"""The port's structured KKT inverse against the dense inverse and the JAX
package, on the real FTOCP of ``tests/test_kkt_band.py`` (float64):

- ``structured_kinv`` equals the dense inverse to 1e-8 (relative to
  max|K^-1|) and JAX's ``structured_kinv`` to 1e-10, batched over seeds;
- ``is_block_tridiagonal`` accepts the real K and refuses a coupling two
  blocks away; ``_gj_inverse`` equals ``torch.linalg.inv`` to 1e-10;
- ``qp.solve`` with the band structure (default ``SolverConfig()``, so the
  structured handoff + Newton-Schulz guard + polish) equals JAX's solve
  with the same structure: x to 1e-7, identical iteration counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racinglmpc_tpu.ops import kkt_band as jkb
from racinglmpc_tpu.ops import qp as jqp
from racinglmpc_tpu.utils.config import SolverConfig as JS
from racinglmpc_tpu_torch.ops import kkt_band as tkb
from racinglmpc_tpu_torch.ops import qp as tqp
from racinglmpc_tpu_torch.utils.config import SolverConfig
from tests.test_kkt_band import _K_of, _ftocp_qp

torch.set_num_threads(1)


def _batch(K_ss, seeds=(0, 1)):
    qps = [_ftocp_qp(K_ss=K_ss, seed=s) for s in seeds]
    dims = qps[0][0]
    Ks = np.stack([np.asarray(_K_of(qp)) for _, qp in qps])
    return dims, [qp for _, qp in qps], Ks


@pytest.mark.parametrize("K_ss", [48, 0])
def test_structured_kinv_matches_dense_and_reference(K_ss):
    dims, _, Ks = _batch(K_ss)
    st = tkb.band_structure(dims.N, dims.K)
    X = tkb.structured_kinv(torch.from_numpy(Ks), st).numpy()
    dense = np.linalg.inv(Ks)
    scale = np.abs(dense).max()
    assert np.abs(X - dense).max() / scale < 1e-8
    jst = jkb.band_structure(dims.N, dims.K)
    Xj = np.asarray(jax.vmap(lambda k: jkb.structured_kinv(k, jst))(
        jnp.asarray(Ks)))
    assert np.abs(X - Xj).max() / scale < 1e-10
    np.testing.assert_array_equal(st.perm, jst.perm)


def test_block_tridiagonal_check_and_gj_inverse():
    dims, _, Ks = _batch(48, seeds=(0,))
    st = tkb.band_structure(dims.N, dims.K)
    assert tkb.is_block_tridiagonal(Ks[0], st)
    bad = Ks[0].copy()
    i, j = st.perm[0], st.perm[3 * st.bs]      # stage 0 <-> stage 3
    bad[i, j] = bad[j, i] = 1e-3
    assert not tkb.is_block_tridiagonal(bad, st)
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 10, 10))
    S = torch.from_numpy(M @ M.transpose(0, 2, 1) + 10 * np.eye(10))
    np.testing.assert_allclose(tkb._gj_inverse(S).numpy(),
                               torch.linalg.inv(S).numpy(), atol=1e-10)


def test_solve_with_structure_matches_reference():
    dims, qps, _ = _batch(48)
    jq = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qps)
    jst = jkb.band_structure(dims.N, dims.K)
    jsol = jax.vmap(lambda p: jqp.solve(p, JS(), structure=jst))(jq)
    tq = tqp.QPData(*(torch.from_numpy(np.array(a)) for a in jq))
    tsol = tqp.solve(tq, SolverConfig(),
                     structure=tkb.band_structure(dims.N, dims.K))
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x), atol=1e-7)
    np.testing.assert_array_equal(tsol.fac.valid.numpy(),
                                  np.asarray(jsol.fac.valid))
    # the structured path drops nothing the caller asked to keep
    assert tsol.fac.kinv.shape == (2, dims.nz, dims.nz)
