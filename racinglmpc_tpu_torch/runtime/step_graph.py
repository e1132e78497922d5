"""A controller step replayed as CUDA graphs.

:class:`StepGraph` wraps a step function ``fn(inputs, key) -> outputs``,
whose inputs and outputs are trees (NamedTuples, tuples) of tensors:

- each call copies the caller's inputs into static buffers, one set per
  signature of shapes and dtypes (the caller's tensors are only read), and
  asks ``key_of(static inputs)`` for the host value that picks the graph
  (the LTV step: its Ruiz sweep count and whether the tracer is armed);
- the first call of a key runs ``fn`` once, on the static buffers, on a
  side stream: that run is the call's result, counted as any eager step,
  and the warm-up PyTorch asks for before a capture. Then ``fn`` is
  captured on the same buffers;
- later calls replay the graph, inside the span ``ctrl.graph``. A replay
  passes no Python wrapper, so it adds to every ``tracing.LaunchCounter``
  and to the tracer's host counts what its capture launched and counted;
  device counters count inside the graph;
- every call returns fresh tensors, copied out of the graph's buffers, so
  no later replay writes a tensor a caller holds.

A capture that raises (an operation the capture refuses) leaves its key
eager: ``fn`` on the static buffers, the outputs copied out as above.
``capture`` is the capture function, :func:`cuda_capture` by default; a
test hands a stand-in that runs on the CPU.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Hashable, List, NamedTuple, Tuple

import torch

from racinglmpc_tpu_torch.runtime import tracing
from racinglmpc_tpu_torch.utils.batched import tree_map

_MISSING = object()


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, depth first."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def rebuild(tree: Any, values: List[torch.Tensor]) -> Any:
    """``tree`` with its tensors replaced, in :func:`leaves` order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def copy_all(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])`` for all i: one multi-tensor copy a dtype."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(dst):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        torch._foreach_copy_([dst[i] for i in idx], [src[i] for i in idx])


def fresh(tree: Any) -> Any:
    """A copy of ``tree`` in new contiguous tensors (a tensor found twice
    is copied once, and the copy is found twice)."""
    src = leaves(tree)
    index: Dict[int, int] = {}
    uniq: List[torch.Tensor] = []
    for t in src:
        if id(t) not in index:
            index[id(t)] = len(uniq)
            uniq.append(t)
    dst = [torch.empty_like(t, memory_format=torch.contiguous_format)
           for t in uniq]
    copy_all(dst, uniq)
    return rebuild(tree, [dst[index[id(t)]] for t in src])


def cuda_capture(run: Callable[[], Any]) -> Tuple[Callable[[], None], Any]:
    """Capture ``run()`` into a CUDA graph: (replay, its outputs)."""
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(g):
            out = run()
    finally:   # a refused capture may leave its stream current
        torch.cuda.set_stream(stream)
    return g.replay, out


class _Graph(NamedTuple):
    replay: Callable[[], None]
    out: Any                            # outputs, in the graph's buffers
    launches: Tuple[Tuple[tracing.LaunchCounter, int], ...]
    counts: Dict[str, int]              # the tracer's host counts


class StepGraph:
    """``fn`` replayed as CUDA graphs (see the module's docstring)."""

    def __init__(self, fn: Callable[[Any, Hashable], Any],
                 capture: Callable = cuda_capture):
        self.fn = fn
        self.capture = capture
        self._static: Dict[tuple, Any] = {}
        self._graphs: Dict[tuple, Any] = {}    # _Graph, or None: refused

    def __call__(self, inputs: Any, key_of: Callable[[Any], Hashable]):
        src = leaves(inputs)
        sig = tuple((t.shape, t.dtype, t.device) for t in src)
        static = self._static.get(sig)
        if static is None:
            static = self._static[sig] = rebuild(inputs, [
                torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in src])
        copy_all(leaves(static), src)
        key = key_of(static)
        g = self._graphs.get((sig, key), _MISSING)
        if g is _MISSING:
            out = self._first(static, key)
            self._graphs[sig, key] = self._capture(static, key)
            return out
        if g is None:
            return fresh(self.fn(static, key))
        with tracing.span("ctrl.graph"):
            g.replay()
            for c, n in g.launches:
                c.n += n
            for name, n in g.counts.items():
                tracing.count(name, n)
            tracing.graph_replays.n += 1
            tracing.count("ctrl.graph.replays")
            return fresh(g.out)

    def _first(self, static: Any, key: Hashable) -> Any:
        """``fn`` on the static buffers: on a side stream on CUDA."""
        dev = leaves(static)[0].device
        if dev.type != "cuda":
            return fresh(self.fn(static, key))
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(static, key)
        cur.wait_stream(side)
        for t in leaves(out):      # read on this stream before it is freed
            t.record_stream(cur)
        return fresh(out)

    def _capture(self, static: Any, key: Hashable):
        counters = tracing.launch_counters()
        before = [c.n for c in counters]

        def run():
            out = self.fn(static, key)
            return rebuild(out, [t.contiguous() for t in leaves(out)])

        try:
            with tracing.detached() as rec:
                replay, out = self.capture(run)
        except RuntimeError as err:
            warnings.warn(f"the step's CUDA graph capture was refused; the "
                          f"step runs eagerly for this key ({err})")
            return None
        finally:
            launched = tuple((c, c.n - b) for c, b in zip(counters, before)
                             if c.n != b)
            for c, b in zip(counters, before):   # a capture launches nothing
                c.n = b
        tracing.graph_captures.n += 1
        tracing.count("ctrl.graph.captures")
        return _Graph(replay, out, launched,
                      dict(rec.counts) if rec is not None else {})
