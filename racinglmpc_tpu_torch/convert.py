"""Carry state across from the JAX package into the port.

The reference's state types are NamedTuples of arrays. Given one as a
(nested) mapping of numpy arrays keyed by field name -- e.g. built with
``jax.device_get`` and ``_asdict()`` -- :func:`from_jax` returns the port's
NamedTuple of tensors with the same fields, shapes and dtypes, for
``Track``, ``LapStore``, ``SafeSet``, ``ExtBuffer``, ``FactorCache``,
``LMPCState`` and ``MPCState`` (nested) and ``PlantState`` (a leading
scenario axis is expected wherever the port's type has one); the port's
``MPCState`` solve information, which the reference's state lacks
(``mpc.SOLVE_INFO``), starts as no solve has touched it.
:func:`config_from_jax` builds one of the port's config dataclasses
(``SolverConfig``, ``ShardedSolverConfig``, ``FTOCPDims``, ...) from the
reference's, and :func:`giant_from_jax` the port's ``GiantFTOCP`` (its QP
with a batch of 1) from the reference's. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from racinglmpc_tpu_torch.controllers.giant_ftocp import GiantFTOCP
from racinglmpc_tpu_torch.controllers.lmpc import (
    ExtBuffer, LMPCState, SafeSet)
from racinglmpc_tpu_torch.controllers.ocp import FTOCPDims
from racinglmpc_tpu_torch.controllers.mpc import (SOLVE_INFO, MPCState,
                                                  solve_info)
from racinglmpc_tpu_torch.models.sysid import LapStore
from racinglmpc_tpu_torch.ops.qp import FactorCache, QPData

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
        if cls is MPCState and name in SOLVE_INFO and name not in fields:
            continue
        v = fields[name]
        kw[name] = (from_jax(nested[name], v, device, float_dtype)
                    if name in nested else _tensor(v, device, float_dtype))
    if cls is MPCState:
        # the port's solve information, which the reference's state lacks
        info = solve_info(kw["feasible"].shape[0], kw["feasible"].device)
        kw.update((k, v) for k, v in info.items() if k not in kw)
    return cls(**kw)


def config_from_jax(cls, cfg):
    """The port's config dataclass ``cls`` with the field values of the
    reference's ``cfg`` (a dataclass instance or a mapping); fields the
    port lacks are refused, so a config cannot lose a setting on the way."""
    d = ({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
         if dataclasses.is_dataclass(cfg) else dict(cfg))
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(extra)}")
    return cls(**d)


def giant_from_jax(g, device="cuda",
                   float_dtype: Optional[torch.dtype] = None) -> GiantFTOCP:
    """The port's ``GiantFTOCP`` from the reference's (fields as numpy
    arrays, ``dims`` a dataclass or mapping); the QP gains its batch of
    1."""
    f = _fields(g)
    qp = _fields(f["qp"])
    return GiantFTOCP(
        dims=config_from_jax(FTOCPDims, f["dims"]),
        qp=QPData(*(_tensor(np.asarray(qp[k])[None], device, float_dtype)
                    for k in QPData._fields)),
        **{k: _tensor(f[k], device, float_dtype)
           for k in ("x_lin", "ss_points", "qfun_sel")})
