"""racinglmpc_tpu_torch -- the PyTorch / CUDA (H100) port of racinglmpc_tpu.

Same layout and names as the JAX package (``utils``, ``models``,
``controllers``, ``ops``, ``runtime``), every function batched over a
leading scenario axis, every entry point on ``device="cuda"`` unless the
caller passes ``device="cpu"``. The three kernels of the main path are
hand-written CUDA C++ for sm_90a under ``csrc/`` (``ops/cuda_qp.py``,
``ops/cuda_sysid.py``, ``ops/cuda_rollout.py``), built with nvcc into
``build/kernels/`` at first use; each has a plain PyTorch version beside
it, which runs on CPU tensors. ``convert.py`` carries state across from
the JAX package. Imports torch and numpy only.
"""

__version__ = "0.1.0"

from racinglmpc_tpu_torch.utils.config import (  # noqa: F401
    LMPCConfig,
    MPCConfig,
    SimConfig,
    SolverConfig,
    VehicleParams,
    default_vehicle_params,
)
from racinglmpc_tpu_torch.models.track import Track, make_track  # noqa: F401
