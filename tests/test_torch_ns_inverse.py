"""The Newton-Schulz inverse's kernel path (``ops/cuda_ns.py``), on the CPU.

- The engagement rule: a CUDA float32 K with n <= ``NMAX`` takes the
  kernel; CPU tensors, float64 and larger n take the plain version, whose
  bits ``qp._ns_inverse`` hands back unchanged (``stats`` or not).
- The kernel's scalars are the floats the plain version's comparisons see
  (Python floats against float32 tensors), and its size limit is the
  source's.
- The plain version's per-lane statistics (the card test compares the
  kernel's with them) equal a hand count.
- In a tracing session on the plain path the counters keep the names the
  benchmark's readers use; the kernel's own fields (``ns.kernel_lanes``)
  read 0 there.
"""
import math
import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from racinglmpc_tpu_torch.ops import cuda_ns
from racinglmpc_tpu_torch.ops import qp as qp_mod
from racinglmpc_tpu_torch.runtime import tracing

torch.set_num_threads(1)


def _case(dtype, B=6, n=12, seed=0):
    """SPD K (lane 4 ill-conditioned, so its first run restarts at a tight
    tolerance), warm starts: lane 0 its exact inverse, lane 1 a perturbed
    one, lane 5 a poor one the gate rejects; lanes 2-4 cold."""
    g = np.random.default_rng(seed)
    M = g.standard_normal((B, n, n))
    K = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    K[4] += 400.0 * np.outer(M[4, 0], M[4, 0])
    inv = np.linalg.inv(K)
    X0 = inv.copy()
    X0[1] *= 1 + 1e-3 * g.standard_normal((n, n))
    X0[5] = 3.0 * inv[5]
    warm = np.array([True, True, False, False, False, True])
    return (torch.tensor(K, dtype=dtype), torch.tensor(X0, dtype=dtype),
            torch.tensor(warm))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("staged", [False, True])
def test_cpu_takes_the_plain_version_same_bits(dtype, staged):
    K, X0, warm = _case(dtype)
    tol = 1e-3 if dtype == torch.float32 else 1e-9
    assert not cuda_ns.engages(K)
    X, r = qp_mod._ns_inverse(K, X0, warm, tol, 40, staged=staged)
    Xp, rp = cuda_ns.ns_inverse_plain(K, X0, warm, tol, 40, staged)
    stats = {}
    Xs, rs = cuda_ns.ns_inverse_plain(K, X0, warm, tol, 40, staged, stats)
    for a, b in ((X, Xp), (r, rp), (X, Xs), (r, rs)):
        assert a.dtype == dtype and torch.equal(a, b)
    assert cuda_ns.launches.n == 0


def _fake(is_cuda, dtype, n):
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(4, n, n))


@pytest.mark.parametrize("is_cuda, dtype, n, engaged", [
    (True, torch.float32, 200, True),              # the main path's FTOCP
    (True, torch.float32, 146, True),              # the LTV stage's
    (True, torch.float32, 1, True),
    (True, torch.float32, cuda_ns.NMAX + 1, False),
    (True, torch.float64, 200, False),             # float64: cuBLAS, plain
    (False, torch.float32, 200, False),            # CPU: plain
])
def test_engagement_rule(is_cuda, dtype, n, engaged):
    assert cuda_ns.engages(_fake(is_cuda, dtype, n)) is engaged


def test_limit_and_scalars_match_the_kernel_source():
    src = (pathlib.Path(cuda_ns.__file__).resolve().parent.parent / "csrc"
           / "cuda_ns.cu").read_text()
    assert int(re.search(r"constexpr int NMAX = (\d+);", src).group(1)) \
        == cuda_ns.NMAX
    f32 = lambda v: float(np.float32(v))   # noqa: E731
    for tol, staged in ((1e-3, False), (1e-3, True), (0.5, True)):
        p = cuda_ns.params(200, tol, 40, staged)
        lv = cuda_ns.levels(tol, staged)
        assert p.n_levels == len(lv) and [p.levels[i] for i in range(
            len(lv))] == [f32(v) for v in lv]
        assert (p.bad, p.v0) == (f32(50 * tol), f32(1.0 / math.sqrt(200)))
        assert (p.n, p.max_iters) == (200, 40)


def _hand_counts(K, X0, warm_ok, tol, max_iters):
    """Per lane, unbatched and in float64: the warm decision and the
    iterations of the first and the restart run."""
    n = K.shape[1]
    I = torch.eye(n, dtype=torch.float64)
    out = []
    for k, x0, w in zip(K.double(), X0.double(), warm_ok.tolist()):
        d = 1.0 / torch.clamp(torch.diagonal(k), min=1e-12)
        cj = float(torch.sqrt(((I - k * d[None, :]) ** 2).sum()))
        Xj = torch.diag(d) / max(cj, 1.0)
        X, r, used = Xj, 1e5, False
        if w:
            R0 = I - k @ x0
            v = torch.full((n,), 1.0 / math.sqrt(n), dtype=torch.float64)
            for _ in range(12):
                wv = R0 @ v
                nrm = float(torch.sqrt((wv * wv).sum()))
                v = wv / max(nrm, 1e-30)
            r0 = float(R0.abs().max())
            if math.isfinite(nrm) and nrm < 0.9 and math.isfinite(r0):
                X, r, used = x0, r0, True

        def run(X, r):
            it = 0
            while r > tol and r < 1e6 and it < max_iters:
                R = I - k @ X
                X = X + X @ R
                r = float(R.abs().max())
                it += 1
            return X, r, it
        X, r, first = run(X, r)
        bad = not math.isfinite(r) or r > 50 * tol
        if bad:
            X, r = Xj, 1e5
        out.append((used, first, run(X, r)[2], bad))
    return out


def test_plain_stats_equal_a_hand_count():
    K, X0, warm = _case(torch.float64)
    tol, max_iters = 1e-10, 12
    stats = {}
    cuda_ns.ns_inverse_plain(K, X0, warm, tol, max_iters, False, stats)
    got = list(zip(*(stats[k].tolist() for k in cuda_ns.STATS)))
    want = _hand_counts(K, X0, warm, tol, max_iters)
    assert [tuple(map(int, g)) for g in got] == [tuple(map(int, w))
                                                 for w in want]
    used = [w[0] for w in want]
    assert used[0] and used[1] and not any(used[2:]) and want[4][3]


def test_counters_keep_their_names_on_the_plain_path():
    K, X0, warm = _case(torch.float32)
    with tracing.session(device="cpu") as rec:
        qp_mod._ns_inverse(K, X0, warm, 1e-3, 40)
    c = rec.counts
    names = {f"ns.{f}" for f in cuda_ns.work.fields}
    assert names == {"ns.lanes", "ns.warm_gate_lanes", "ns.first.lane_iters",
                     "ns.restart.lane_iters", "ns.final.lane_iters",
                     "ns.kernel_lanes"}
    assert names <= set(c)
    assert (c["ns.lanes"], c["ns.warm_gate_lanes"], c["ns.final.lane_iters"],
            c["ns.final.passes"], c["ns.kernel_lanes"]) == (6, 6, 6, 1, 0)
    assert c["ns.first.passes"] >= 1 and c["ns.first.lane_iters"] >= 1
    assert [s.name for s in rec.spans] == ["qp.ns"]
