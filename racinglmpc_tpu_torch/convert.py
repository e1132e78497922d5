"""Carry state across from the JAX package into the port.

The reference's state types are NamedTuples of arrays. Given one as a
(nested) mapping of numpy arrays keyed by field name -- e.g. built with
``jax.device_get`` and ``_asdict()`` -- :func:`from_jax` returns the port's
NamedTuple of tensors with the same fields, shapes and dtypes, for
``Track``, ``LapStore``, ``SafeSet``, ``ExtBuffer``, ``FactorCache``,
``LMPCState`` and ``MPCState`` (nested) and ``PlantState`` (a leading
scenario axis is expected wherever the port's type has one). Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from racinglmpc_tpu_torch.controllers.lmpc import (
    ExtBuffer, LMPCState, SafeSet)
from racinglmpc_tpu_torch.controllers.mpc import MPCState
from racinglmpc_tpu_torch.models.sysid import LapStore
from racinglmpc_tpu_torch.ops.qp import FactorCache

_NESTED = {
    LMPCState: {"ss": SafeSet, "ext": ExtBuffer, "store": LapStore,
                "fac": FactorCache},
    MPCState: {"fac": FactorCache},
}


def _fields(d: Any) -> Mapping[str, Any]:
    return d._asdict() if hasattr(d, "_asdict") else d


def _tensor(a, device, float_dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    if float_dtype is not None and t.is_floating_point():
        t = t.to(float_dtype)
    return t.to(device)


def from_jax(cls, d, device="cuda", float_dtype: Optional[torch.dtype] = None):
    """Build the port's ``cls`` from the reference's fields ``d``."""
    fields = _fields(d)
    nested = _NESTED.get(cls, {})
    kw = {}
    for name in cls._fields:
        v = fields[name]
        kw[name] = (from_jax(nested[name], v, device, float_dtype)
                    if name in nested else _tensor(v, device, float_dtype))
    return cls(**kw)
