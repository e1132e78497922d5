"""Scenario mesh over ``torch.distributed`` (port of
``racinglmpc_tpu/parallel/mesh.py``).

The JAX package runs one process over all devices and splits every
scenario-batched leaf over a 1-D mesh axis ``'scenario'``. The PyTorch
idiom is one rank per device: each rank holds its own rows of the scenario
batch and runs the per-scenario math on them alone, and the few values that
cross scenarios (the LMPC lap's early exit, results gathered for the
caller, summary metrics) go through collectives -- NCCL between cards, gloo
where the caller asks for the CPU.

A :class:`ScenarioMesh` is the process group, this rank, the number of
ranks and this rank's device. :func:`make_mesh` builds it over the group
that :func:`init_multi_host` (torchrun's environment) initialized, or, with
no group, creates a one-rank group of its own, so a single-card run goes
through the same collectives; such a mesh destroys its group on
:meth:`ScenarioMesh.close` (or at the end of a ``with`` block).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from racinglmpc_tpu_torch.utils.batched import tree_map

SCENARIO_AXIS = "scenario"

# torch 2.13 renamed all_gather_into_tensor (same arguments) and deprecated
# the old name; earlier releases have only the old one
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass
class ScenarioMesh:
    """One rank's view of a 1-D mesh over the scenario axis."""

    group: Any                 # the process group of the mesh's ranks
    rank: int
    size: int
    device: torch.device
    axis_name: str = SCENARIO_AXIS
    owns_group: bool = False   # created by make_mesh; close() destroys it

    def rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch`` divisible by the mesh size."""
        if batch % self.size:
            raise ValueError(f"batch {batch} does not divide over "
                             f"{self.size} ranks")
        b = batch // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce on the mesh's device, which
        NCCL and gloo both run)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self) -> "ScenarioMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def init_multi_host(init_method: Optional[str] = None,
                    world_size: Optional[int] = None,
                    rank: Optional[int] = None,
                    backend: str = "nccl") -> int:
    """Initialize the default process group from torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) or from the arguments.

    No-op (returns 1) when neither ``init_method`` nor that environment is
    present, so single-process runs and unit tests stay untouched; returns
    the world size otherwise. With NCCL each rank takes the card
    ``LOCAL_RANK``; ``backend="gloo"`` runs the ranks on the CPU.
    """
    env = os.environ
    has_env = all(k in env for k in ("MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK"))
    if init_method is None and not has_env:
        return 1
    if dist.is_initialized():
        return dist.get_world_size()
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multi_host: NCCL needs a CUDA device; "
                               "pass backend='gloo' for CPU ranks")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env["RANK"])
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dist.get_world_size()


def make_mesh(devices=None, axis_name: str = SCENARIO_AXIS) -> ScenarioMesh:
    """1-D mesh over the initialized process group, on this rank's device.

    ``devices``: this rank's device (``"cuda"`` when None, ``"cpu"`` for
    gloo ranks). With no group initialized, a one-rank group is created in
    process -- NCCL on ``cuda`` (which raises without a card), gloo on
    ``cpu`` -- and the mesh owns it.
    """
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError("make_mesh takes this rank's one device")
        devices = devices[0]
    dev = torch.device("cuda" if devices is None else devices)
    if dist.is_initialized():
        backend = dist.get_backend()
        if (backend == "nccl") != (dev.type == "cuda"):
            raise ValueError(f"a {backend} group cannot run on {dev}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return ScenarioMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                            size=dist.get_world_size(), device=dev,
                            axis_name=axis_name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "devices='cpu' for a gloo mesh")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_mesh: unsupported device {dev}")
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    return ScenarioMesh(group=dist.group.WORLD, rank=0, size=1, device=dev,
                        axis_name=axis_name, owns_group=True)


def shard_scenario_tree(tree: Any, mesh: ScenarioMesh) -> Any:
    """This rank's part of a scenario-batched tree, on the mesh's device:
    a leaf whose leading dimension divides by the mesh size keeps this
    rank's rows; any other leaf (a 0-dim scalar, a shared table) is
    replicated."""
    def place(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dim() >= 1 and leaf.shape[0] > 0 \
                and leaf.shape[0] % mesh.size == 0:
            leaf = leaf[mesh.rows(leaf.shape[0])]
        return leaf.to(mesh.device)

    return tree_map(place, tree)


def gather_tensor(t: torch.Tensor, mesh: ScenarioMesh) -> torch.Tensor:
    """Every rank's rows of ``t`` stacked in rank order, on every rank."""
    src = t.contiguous()
    out = torch.empty((mesh.size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if src.numel():
        _all_gather(out, src, group=mesh.group)
    return out


def gather_scenario_tree(tree: Any, mesh: ScenarioMesh) -> Any:
    """The whole batch of a tree sharded by rows, on every rank (the
    counterpart of the JAX package's ``process_allgather``): every tensor
    leaf of one dimension or more is this rank's rows; 0-dim leaves are
    replicated and come back as they are."""
    return tree_map(lambda t: gather_tensor(t, mesh) if t.dim() else t, tree)


def all_ranks(flag: torch.Tensor, mesh: ScenarioMesh) -> torch.Tensor:
    """0-dim bool: ``flag`` is all true on every rank (one decision that
    every rank takes alike)."""
    v = flag.all().to(torch.int32).reshape(1)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.group)
    return v[0].bool()


def cross_scenario_metrics(values: torch.Tensor, mesh: ScenarioMesh) -> dict:
    """Mean, min and max of a per-scenario metric over the whole batch,
    from this rank's rows, as all-reduces (equal rows on every rank)."""
    v = values.reshape(-1)
    s = v.sum().reshape(1)
    lo = v.min().reshape(1)
    hi = v.max().reshape(1)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    return {"mean": s[0] / (v.numel() * mesh.size), "min": lo[0],
            "max": hi[0]}
