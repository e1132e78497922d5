"""Checkpoint / resume of the LMPC stage (port of
``racinglmpc_tpu/runtime/checkpoint.py``).

A checkpoint is a state tree (NamedTuples and tuples of tensors: the LMPC
controller state and the plant) plus the stream seed of the LMPC laps and
the index of the last completed lap, written as one ``.npz``: a flat
manifest of path keys (``[0]/.ss/.x`` style) and one array per leaf. The
file is written to ``<path>.tmp`` and moved into place with
``os.replace``, so a crash never leaves a torn checkpoint; the optional
``meta`` dict goes to the ``.meta.json`` sidecar (the per-lap history a
resumed run reports). A run sharded over a scenario mesh writes the
gathered state from rank 0, and each rank loads its own rows (``rows``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path key, tensor) for every tensor leaf, depth first."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}/.{name}" if prefix else f".{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")


def _rebuild(tree: Any, values: Iterator[torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(values)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return tree


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, state: Any, seed: int, lap: int,
         meta: dict | None = None) -> None:
    """Write one checkpoint; ``path`` gets '.npz' appended if missing."""
    arrays = {k: t.detach().cpu().numpy() for k, t in _leaves(state)}
    arrays["__seed__"] = np.asarray(seed, dtype=np.uint64)
    arrays["__lap__"] = np.asarray(lap, dtype=np.int64)
    payload = {f"a{i}": v for i, v in enumerate(arrays.values())}
    p = _npz(path)
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __manifest__=json.dumps(list(arrays.keys())), **payload)
    os.replace(tmp, p)
    if meta is not None:
        with open(p + ".meta.json", "w") as f:
            json.dump(meta, f)


def load(path: str, template: Any,
         rows: slice | None = None) -> Tuple[Any, int, int]:
    """Read a checkpoint into the structure, dtypes and devices of
    ``template``; ``rows`` keeps those rows of every leaf's leading
    (scenario) axis. Returns (state, seed, lap). Raises KeyError on a
    missing leaf and ValueError on a shape that differs from the
    template's."""
    with np.load(_npz(path), allow_pickle=False) as z:
        names = json.loads(str(z["__manifest__"]))
        arrays = {n: z[f"a{i}"] for i, n in enumerate(names)}
    seed = int(arrays.pop("__seed__"))
    lap = int(arrays.pop("__lap__"))
    values = []
    for key, leaf in _leaves(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key] if rows is None else arrays[key][rows]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} "
                             f"!= template {tuple(leaf.shape)}")
        values.append(torch.as_tensor(arr).to(dtype=leaf.dtype,
                                              device=leaf.device))
    return _rebuild(template, iter(values)), seed, lap
