"""Stage structure of the FTOCP's ADMM KKT matrix (host-side constants).

Port of ``stage_permutation`` / ``band_structure`` from
``racinglmpc_tpu/ops/kkt_band.py``. ``make_lmpc`` hands the structure to
every solve; the structured block-tridiagonal inverse that reads it
(``structured_kinv``) is ROADMAP item 10, so ``ops/qp.solve`` raises when
a config asks for it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
