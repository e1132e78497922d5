"""B1's rescue prologue (``csrc/cuda_qp.cu:admm_rescue_prologue``): per
rescued lane, K2 = (A' (s rho) A) + P + sigma I and its two-pass
Newton-Schulz inverse, one CTA a scenario (the other CTAs return at
once).

Operations per rescued lane, from the kernel's own counter
(``ops/cuda_qp.py:rescue_work``: rescued lanes, their Newton-Schulz
iterations over both passes, warm tests run): the K2 build on the FTOCP's
structural pattern (``prologue.k_build_ops``) and the Jacobi residual's
Frobenius sum (3 n^2); the warm test where it runs, I - K2 X0 (2 n^3 +
n^2) and its Frobenius sum (2 n^2); each Newton-Schulz iteration's two
n^3 products (4 n^3) and their epilogues (2 n^2).

Bytes per rescued lane: P, A and rho read once (the carried inverse too
where the warm test runs) and the inverse written once, float32.
"""
from __future__ import annotations

from lmpc_bench.roofline import prologue


def work(c: dict, n: int, m: int, N: int, K: int):
    """(operations, bytes) of the profiled rescue prologues; ``c``: the
    tracer's counters (``admm.rescue.*``)."""
    lanes = c.get("admm.rescue.lanes", 0)
    warm = c.get("admm.rescue.warm_tests", 0)
    its = c.get("admm.rescue.ns_iters", 0)
    ops = (lanes * (prologue.k_build_ops(N, K) + 3 * n * n)
           + warm * (2 * n ** 3 + 3 * n * n)
           + its * (4 * n ** 3 + 2 * n * n))
    words = lanes * (2 * n * n + m * n + m) + warm * n * n
    return float(ops), 4.0 * words
