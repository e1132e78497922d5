"""Typed configuration tree of the PyTorch port.

A JAX-free copy of ``racinglmpc_tpu/utils/config.py``: the same classes,
fields, defaults and presets, so a configuration built for one package means
the same thing in the other (``tests/test_torch_config.py`` compares every
field). The Pallas switches keep their names; in the port they select the
hand-written CUDA kernels:

- ``SimConfig.use_pallas_rollout``  -> ``ops/cuda_rollout.py`` (B3)
- ``LMPCConfig.use_pallas_sysid``   -> ``ops/cuda_sysid.py``   (B2)
- ``SolverConfig.use_pallas``       -> ``ops/cuda_qp.py``      (B1)
- ``SolverConfig.pallas_fused_ns``  -> ``ops/cuda_qp_fused.py`` (B4)

and ``*_interpret`` engages the kernel path on CPU tensors, where every
kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple


class VehicleParams(NamedTuple):
    """Single-track bicycle + Pacejka tire parameters (1/10-scale car)."""

    m: float = 1.98       # mass [kg]
    lf: float = 0.125     # CoG -> front axle [m]
    lr: float = 0.125     # CoG -> rear axle [m]
    Iz: float = 0.024     # yaw inertia [kg m^2]
    Df: float = 0.8 * 1.98 * 9.81 / 2.0   # Pacejka peak, front [N]
    Cf: float = 1.25      # Pacejka shape, front
    Bf: float = 1.0       # Pacejka stiffness, front
    Dr: float = 0.8 * 1.98 * 9.81 / 2.0   # Pacejka peak, rear [N]
    Cr: float = 1.25      # Pacejka shape, rear
    Br: float = 1.0       # Pacejka stiffness, rear


def default_vehicle_params() -> VehicleParams:
    return VehicleParams()


# x = [vx, vy, wz, epsi, s, ey], u = [delta, a]
NX = 6
NU = 2


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Plant / closed-loop simulation configuration."""

    dt: float = 0.1                 # control period [s] (10 Hz)
    substeps: int = 100             # Euler substeps per control step (1 kHz)
    max_steps: int = 1000           # hard cap on control steps per lap
    noise: bool = True              # plant noise on (vx, vy, wz)
    noise_sigma: Tuple[float, float, float] = (0.01, 0.01, 0.005)
    noise_clip: float = 0.05
    noise_gain: float = 0.01
    use_pallas_rollout: bool = False
    pallas_interpret: bool = False

    @property
    def delta_t(self) -> float:
        return self.dt / self.substeps


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """LTI/LTV-MPC tuning."""

    N: int = 14
    vt: float = 0.8
    Q: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 0.0, 100.0)
    R: Tuple[float, ...] = (1.0, 10.0)
    dR: Tuple[float, ...] = (0.0, 0.0)
    Qf: Tuple[float, ...] = (0.0,) * NX
    q_slack: Tuple[float, float] = (0.0, 50.0)
    ey_max: float = 2.0
    delta_max: float = 0.5
    a_max: float = 10.0
    time_varying: bool = False

    @property
    def x_ref(self) -> Tuple[float, ...]:
        return (self.vt, 0.0, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class LMPCConfig:
    """LMPC tuning + fixed-capacity safe-set / sys-ID buffer sizes."""

    N: int = 14
    num_ss_it: int = 4
    num_ss_points: int = 48
    laps: int = 44
    Q: Tuple[float, ...] = (0.0,) * NX
    R: Tuple[float, ...] = (0.0, 0.0)
    dR: Tuple[float, float] = (5.0, 50.0)
    q_slack: Tuple[float, float] = (5.0, 25.0)
    q_terminal_slack: float = 500.0
    ey_max: float = 0.4
    delta_max: float = 0.5
    a_max: float = 10.0

    max_laps: int = 48
    max_pts: int = 2048
    model_laps: int = 4
    model_pts: int = 1024
    ext_pts: int = 1024

    fallback_after: int = 6
    fallback_vt: float = 0.8

    knn_max: int = 7
    kernel_h: float = 5.0
    reg_lambda: float = 0.0
    reg_jitter: float = 1e-9
    feat_scaling: Tuple[float, ...] = (0.1, 1.0, 1.0, 1.0, 1.0)

    use_pallas_sysid: bool = False
    sysid_interpret: bool = False

    @property
    def points_per_lap(self) -> int:
        return self.num_ss_points // self.num_ss_it + 1

    store_glob: bool = True

    @property
    def ext_cap(self) -> int:
        return min(self.ext_pts, self.max_pts)

    @property
    def glob_cap(self) -> int:
        return self.max_pts if self.store_glob else 8


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched dense QP solver (OSQP-style ADMM + active-set polish).

    Field meanings are documented in the reference package's copy of this
    class; the port reads them with the same semantics.
    """

    max_iter: int = 250
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    scaling_iters: int = 10
    scaling_warm_iters: int = 10
    scaling_refresh_every: int = 0
    adaptive_rho: bool = True
    warmup_iters: int = 25
    check_every: int = 25
    polish: bool = True
    polish_delta: float = 1e-6
    polish_refine_steps: int = 3
    kkt_refine_steps: int = 1
    ns_tol: "float | None" = None
    ns_max_iters: int = 40
    ns_staged_precision: bool = False
    kkt_structured: bool = True
    use_pallas: bool = False
    pallas_interpret: bool = False
    pallas_fused_ns: bool = False
    pallas_iter_precision: str = "highest"
    accept_pri_res: float = 1e-2
    rescue_max_iter: int = 0
    rescue_rho_scale: float = 5.0
    rescue_trigger: float = 7.5e-3
    rescue_exit: float = 1e-3

    @classmethod
    def throughput(cls) -> "SolverConfig":
        """Fixed rho, no polish, ADMM kernel, rescue stage on, dense
        Newton-Schulz KKT inverse (the main path's preset)."""
        return cls(max_iter=300, polish=False, adaptive_rho=False,
                   use_pallas=True,
                   scaling_warm_iters=2, scaling_refresh_every=50,
                   check_every=4, rescue_max_iter=300,
                   kkt_structured=False)

    @classmethod
    def throughput_max(cls) -> "SolverConfig":
        """:meth:`throughput` with the structured block-tridiagonal KKT
        inverse (``ops/kkt_band.structured_kinv``)."""
        return dataclasses.replace(cls.throughput(), kkt_structured=True)

    @classmethod
    def balanced(cls) -> "SolverConfig":
        """Tighter tolerance target (eps 3e-4), structured KKT inverse."""
        return cls(max_iter=300, polish=False, adaptive_rho=False,
                   use_pallas=True, eps_abs=3e-4, eps_rel=3e-4,
                   scaling_warm_iters=2, scaling_refresh_every=50,
                   check_every=4, rescue_max_iter=300)

    @classmethod
    def parity(cls) -> "SolverConfig":
        """Accuracy-oriented settings (float64 parity tests)."""
        return cls(max_iter=1000, warmup_iters=100, check_every=100)
