"""Structured (block-tridiagonal) inverse of the ADMM KKT matrix.

Port of ``racinglmpc_tpu/ops/kkt_band.py`` with a leading scenario axis.
Under the stage-interleaved permutation

    w_k = [x_k (6) | u_k (2) | laneSlack_k (2)]   k = 0..N-1   (10 each)
    w_N = [x_N (6) | lambda (K) | termSlack (6)]  (arrow tail block)

the FTOCP's K = P_s + sigma I + A_s' rho A_s is symmetric positive definite
block-tridiagonal. :func:`structured_kinv` inverts it exactly by a block
LDL': the forward Schur recursion S_{k+1} = D_{k+1} - F_k O_k' with
F_k = O_k S_k^{-1} (stage blocks inverted by unrolled, unpivoted
Gauss-Jordan), then K^{-1} = L^{-T} D^{-1} L^{-1} applied to the identity
panel by panel, and the inverse permutation. ``ops/qp.solve`` hands the
result to the Newton-Schulz guard (one explicit squaring first).

The stage blocks are 10x10 products batched over the scenario axis
(``torch.matmul``), as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BandStructure(NamedTuple):
    perm: np.ndarray   # (n,) canonical -> stage-interleaved permutation
    N: int             # number of uniform stage blocks
    bs: int            # uniform stage-block size (n + d + nc)


def stage_permutation(N: int, K: int, n: int = 6, d: int = 2, nc: int = 2
                      ) -> np.ndarray:
    """Canonical z [x_0..x_N | u | slack | lam | ts] -> stage-interleaved
    [x_k u_k slack_k]_k, then [x_N | lam | ts]."""
    off_u = n * (N + 1)
    off_s = off_u + d * N
    off_l = off_s + nc * N
    p = []
    for k in range(N):
        p.extend(range(k * n, (k + 1) * n))
        p.extend(range(off_u + k * d, off_u + (k + 1) * d))
        p.extend(range(off_s + k * nc, off_s + (k + 1) * nc))
    p.extend(range(N * n, (N + 1) * n))
    if K:
        p.extend(range(off_l, off_l + K + n))
    return np.asarray(p, dtype=np.int32)


def band_structure(N: int, K: int, n: int = 6, d: int = 2, nc: int = 2
                   ) -> BandStructure:
    return BandStructure(perm=stage_permutation(N, K, n, d, nc), N=N,
                         bs=n + d + nc)


def _gj_inverse(S: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD blocks (..., b, b) by unrolled Gauss-Jordan without
    pivoting (every pivot is a positive diagonal of a partially eliminated
    SPD matrix)."""
    b = S.shape[-1]
    eye = torch.eye(b, dtype=S.dtype, device=S.device).expand(S.shape)
    M = torch.cat([S, eye], dim=-1)
    for j in range(b):
        piv = M[..., j:j + 1, :] / M[..., j:j + 1, j:j + 1]
        M = M - M[..., :, j:j + 1] * piv
        M = torch.cat([M[..., :j, :], piv, M[..., j + 1:, :]], dim=-2)
    return M[..., b:]


def structured_kinv(K: torch.Tensor, st: BandStructure) -> torch.Tensor:
    """Dense K^{-1} (B, n, n) through the block-tridiagonal structure."""
    n = K.shape[-1]
    N, bs = st.N, st.bs
    perm = torch.as_tensor(st.perm, dtype=torch.int64, device=K.device)
    inv_perm = torch.argsort(perm)
    I_n = torch.eye(n, dtype=K.dtype, device=K.device)

    Kp = K[:, perm][:, :, perm]

    def blk(r0, r1, c0, c1):
        return Kp[:, r0:r1, c0:c1]

    def T(M):
        return M.transpose(-1, -2)

    D = [blk(k * bs, (k + 1) * bs, k * bs, (k + 1) * bs) for k in range(N)]
    O = [blk((k + 1) * bs, (k + 2) * bs, k * bs, (k + 1) * bs)
         for k in range(N - 1)]
    O_big = blk(N * bs, n, (N - 1) * bs, N * bs)
    D_big = blk(N * bs, n, N * bs, n)

    # forward Schur recursion (block LDL', L unit lower)
    Cs, Fs = [], []
    S = D[0]
    for k in range(N):
        C = _gj_inverse(S)
        Cs.append(C)
        if k < N - 1:
            F = O[k] @ C
            Fs.append(F)
            S = D[k + 1] - F @ T(O[k])
    F_big = O_big @ Cs[-1]
    C_big = _gj_inverse(D_big - F_big @ T(O_big))

    # L^{-1} applied to I: Y_k = E_k - F_{k-1} Y_{k-1}
    Ys = [I_n[:bs].expand(K.shape[0], -1, -1)]
    for k in range(1, N):
        Ys.append(I_n[k * bs:(k + 1) * bs] - Fs[k - 1] @ Ys[-1])
    y_big = I_n[N * bs:] - F_big @ Ys[-1]

    # D^{-1}, then L^{-T}: Z_k = Yd_k - F_k' Z_{k+1}
    Yd = [Cs[k] @ Ys[k] for k in range(N)]
    z_big = C_big @ y_big
    Zs = [None] * N
    Zs[N - 1] = Yd[N - 1] - T(F_big) @ z_big
    for k in range(N - 2, -1, -1):
        Zs[k] = Yd[k] - T(Fs[k]) @ Zs[k + 1]
    Z = torch.cat(Zs + [z_big], dim=1)
    return Z[:, inv_perm][:, :, inv_perm]


def is_block_tridiagonal(K: np.ndarray, st: BandStructure,
                         tol: float = 0.0) -> bool:
    """Host-side structure check of one (n, n) matrix: no coupling beyond
    adjacent stage blocks."""
    Kp = K[st.perm][:, st.perm]
    n = Kp.shape[0]
    bounds = [st.bs * k for k in range(st.N + 1)] + [n]
    ok = True
    for i in range(len(bounds) - 1):
        for j in range(len(bounds) - 1):
            if abs(i - j) > 1:
                blk = Kp[bounds[i]:bounds[i + 1], bounds[j]:bounds[j + 1]]
                if blk.size:
                    ok &= np.abs(blk).max() <= tol
    return bool(ok)
