"""Helpers for tensors with a leading scenario axis."""
from __future__ import annotations

from typing import Any, Callable

import torch


def lane_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``a`` where ``mask`` else ``b``; ``mask`` covers the leading dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())),
                       a, b)


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v per lane: (B, r, c), (B, c) -> (B, r)."""
    return (M @ v[..., None])[..., 0]


def vm(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v @ M per lane (contracts M's rows): (B, r), (B, r, c) -> (B, c)."""
    return (v[:, None, :] @ M)[:, 0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over tensors of NamedTuples / tuples / lists
    with identical structure; other leaves pass through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def bwhere(mask: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-scenario select over whole state trees; leaves that are the same
    tensor object are returned as they are."""
    return tree_map(lambda x, y: x if x is y else lane_where(mask, x, y),
                    a, b)
