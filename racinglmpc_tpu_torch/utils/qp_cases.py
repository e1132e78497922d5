"""Random strictly convex QPs, the inputs of B4's small-n checks on the
card (``tests/test_torch_cuda.py``) and of ``runtime/admm_bench.py``."""
from __future__ import annotations

import numpy as np
import torch

from racinglmpc_tpu_torch.ops import qp as qp_mod


def random_qps(B: int, n: int = 30, me: int = 6, mi: int = 20,
               seed: int = 11, device="cuda") -> qp_mod.QPData:
    """B random strictly convex QPs with me equalities and mi one-sided
    inequalities (the construction of ``tests/test_pallas_qp.py``), as a
    float32 ``QPData`` batch."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        M = rng.normal(size=(n, n))
        P = M.T @ M / n + 0.5 * np.eye(n)
        q = rng.normal(size=n)
        G, F = rng.normal(size=(me, n)), rng.normal(size=(mi, n))
        z0 = rng.normal(size=n) * 0.3
        g, b = G @ z0, F @ z0 + np.abs(rng.normal(size=mi)) + 0.1
        rows.append((P, q, np.vstack([F, G]),
                     np.concatenate([-np.inf * np.ones(mi), g]),
                     np.concatenate([b, g])))
    return qp_mod.QPData(*(torch.tensor(np.stack(f), dtype=torch.float32,
                                        device=device) for f in zip(*rows)))
