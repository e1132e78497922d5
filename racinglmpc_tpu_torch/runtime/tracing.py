"""Spans and counters of the port's control step, and the counters of its
kernels.

**Spans.** ``with span("qp.ns"):`` (or ``@traced("qp.ns")`` around a
whole function) marks a stage of the step. Disarmed, the default, a span
is one module-level bool check that hands back a shared no-op context
manager, and :func:`count` is the same check: nothing is allocated,
launched or synchronised. ``with session() as rec:`` arms them: each span
then records its name, start and end, its parent (the span open around
it) and the batched step it belongs to (episode and step index, set by
the lap runner through :func:`new_episode` and :func:`at_step`), all in
memory; :class:`Record` holds them when the session ends. Armed, the
tracer launches no kernel and synchronises nothing either: spans read the
host clock, counters add host integers the code already has.

The clock is ``time.time_ns()``: Unix-epoch nanoseconds, the clock of
``torch.profiler``'s events (its host events, and the CUDA activity it
converts to that clock), so the spans of a session lie over a device
trace taken in the same process. :func:`overlay` lays them over one:
per span name, the device time of the kernels launched inside it (each
kernel found by its launch call's correlation id) and the device idle
time while it was the innermost open span. Open the session outside the
profiler: its start and end touch the device (below), its spans do not.

**Counters.** :class:`LaunchCounter` (a kernel's wrapper adds one per
launch) and :class:`ScenarioCounter` (a kernel adds with integer atomics
on the device, one slot per field) count always. A ``ScenarioCounter``
made with ``armed_only=True`` hands its kernel a pointer only while a
session is armed (else a null pointer, and the kernel counts nothing);
the session zeroes it on entry and reads it (one synchronisation) on exit
into :attr:`Record.counts`, under ``<name>.<field>``. Host counters
(:func:`count`) land there too.

**CUDA graphs.** A replay of the controller step's graph
(``runtime/step_graph.py``) passes no wrapper: it adds to every
:class:`LaunchCounter` (:func:`launch_counters`) and to the host counts
what its capture launched and counted (a capture runs inside
:func:`detached`, which keeps its spans and counts out of the session);
:data:`graph_captures` and :data:`graph_replays` count the graphs, and
the replay is one span, ``ctrl.graph``, so the step's inner spans are
seen on the eager path alone. Device counters count inside the graph.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import re
import time
from collections import defaultdict
from typing import (Dict, Iterable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

_armed = False
_rec: Optional["Record"] = None
_ARMED_ONLY: Dict[str, "ScenarioCounter"] = {}
_LAUNCH_COUNTERS: List["LaunchCounter"] = []


class LaunchCounter:
    """Launches of one kernel (or of the step's graphs); its wrapper adds
    one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        _LAUNCH_COUNTERS.append(self)

    def reset(self) -> None:
        self.n = 0


def launch_counters() -> List[LaunchCounter]:
    """Every launch counter made in this process."""
    return list(_LAUNCH_COUNTERS)


# the controller step's CUDA graphs: captures made, replays run
graph_captures = LaunchCounter("ctrl.graph.captures")
graph_replays = LaunchCounter("ctrl.graph.replays")


class ScenarioCounter:
    """Counts a kernel adds on the device with integer atomics, one int32
    slot per field, so counting costs no host sync; :meth:`value` reads
    the first field (and syncs), :meth:`values` every field.
    ``armed_only``: :meth:`ptr` is a null pointer unless a session is
    armed."""

    def __init__(self, name: str, fields: Sequence[str] = ("scenarios",),
                 armed_only: bool = False):
        self.name = name
        self.fields = tuple(fields)
        self.armed_only = armed_only
        self._t: Dict[torch.device, torch.Tensor] = {}
        if armed_only:
            _ARMED_ONLY[name] = self

    def tensor(self, device) -> torch.Tensor:
        """The (fields,) int32 counter on ``device`` the kernel adds to."""
        key = torch.device(device)
        if key.type == "cuda" and key.index is None:
            key = torch.device("cuda", torch.cuda.current_device())
        if key not in self._t:
            self._t[key] = torch.zeros((len(self.fields),), dtype=torch.int32,
                                       device=key)
        return self._t[key]

    def ptr(self, device) -> ctypes.c_void_p:
        """The counter's address for a kernel on ``device``; null where
        ``armed_only`` and the tracer is disarmed."""
        if self.armed_only and not _armed:
            return ctypes.c_void_p(None)
        return ctypes.c_void_p(self.tensor(device).data_ptr())

    def reset(self) -> None:
        for t in self._t.values():
            t.zero_()

    def values(self) -> Dict[str, int]:
        tot = [0] * len(self.fields)
        for t in self._t.values():
            for i, v in enumerate(t.tolist()):
                tot[i] += int(v)
        return dict(zip(self.fields, tot))

    def value(self) -> int:
        return self.values()[self.fields[0]]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int      # index of the enclosing span in Record.spans; -1: none
    episode: int
    step: int


def self_ns(spans: Sequence[Span]) -> List[int]:
    """Each span's self time: its duration less what its children cover
    (children of one span never overlap: one thread)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


class Record:
    """What a session recorded: ``spans`` in the order they opened (so
    sorted by start), ``counts`` (host counters, then the armed device
    counters read at the session's end)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = defaultdict(int)
        self.episode = 0
        self.step = 0
        self._rows: List[list] = []
        self._stack: List[int] = []


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Record, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        r = self.rec
        self.i = len(r._rows)
        r._rows.append([self.name, time.time_ns(), 0,
                        r._stack[-1] if r._stack else -1, r.episode, r.step])
        r._stack.append(self.i)
        return None

    def __exit__(self, *exc):
        r = self.rec
        r._rows[self.i][2] = time.time_ns()
        r._stack.pop()
        return False


def span(name: str):
    """A context manager marking one stage (see the module's docstring)."""
    if not _armed:
        return _NOOP
    return _Open(_rec, name)


def traced(name: str):
    """Decorator: the whole call is the span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _armed:
                return fn(*args, **kwargs)
            with _Open(_rec, name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while armed."""
    if _armed:
        _rec.counts[name] += n


def new_episode() -> None:
    """A lap starts: the spans that follow belong to the next episode."""
    if _armed:
        _rec.episode += 1


def at_step(t: int) -> None:
    """The spans that follow belong to step ``t`` of the current episode."""
    if _armed:
        _rec.step = t


def armed() -> bool:
    return _armed


@contextlib.contextmanager
def session(device=None) -> Iterator[Record]:
    """Arm the tracer for the block and yield its :class:`Record`, filled
    when the block ends. On entry the armed-only device counters are made
    on ``device`` (default: the current CUDA device, if any) and zeroed;
    on exit they are read (one synchronisation)."""
    global _armed, _rec
    if _armed:
        raise RuntimeError("a tracing session is already armed")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    armed_only = list(_ARMED_ONLY.values())
    for c in armed_only:
        if device is not None:
            c.tensor(device)
        c.reset()
    rec = Record()
    _rec, _armed = rec, True
    try:
        yield rec
    finally:
        _armed, _rec = False, None
        rec.spans = [Span(*row) for row in rec._rows]
        for c in armed_only:
            for k, v in c.values().items():
                rec.counts[f"{c.name}.{k}"] += v


@contextlib.contextmanager
def detached() -> Iterator[Optional[Record]]:
    """While armed, the block's spans and host counts go to a record of
    their own, yielded (the armed-only device counters stay armed); None
    while disarmed."""
    global _rec
    if not _armed:
        yield None
        return
    outer, _rec = _rec, Record()
    try:
        yield _rec
    finally:
        _rec = outer


# ---- the overlay on a device trace -----------------------------------------

LAUNCH = re.compile(r"^cu(da)?LaunchKernel(Ex)?(C)?$")
SYNC = re.compile(r"^(cu(da)?(Device|Stream|Event|Ctx)Synchronize|cudaMemcpy)$")
OUTSIDE = "(no span)"
_DEVICE_ACTS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_ACTS = {"cuda_runtime", "cuda_driver"}
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


class DeviceOp(NamedTuple):
    start_ns: int
    end_ns: int
    correlation: int
    name: str


class RuntimeCall(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    correlation: int


def _kind(e) -> str:
    """An event's activity, from its own field where this PyTorch has one,
    else from its device and name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return act()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def profiler_events(prof) -> Tuple[List[DeviceOp], List[RuntimeCall]]:
    """The device operations (kernels, copies, sets) and CUDA runtime calls
    of a finished ``torch.profiler`` session."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        act = _kind(e)
        s = e.start_ns()
        if act in _DEVICE_ACTS:
            dev.append(DeviceOp(s, s + e.duration_ns(), e.correlation_id(),
                                e.name()))
        elif act in _HOST_ACTS:
            host.append(RuntimeCall(s, s + e.duration_ns(), e.name(),
                                    e.correlation_id()))
    return dev, host


def _union(iv: Iterable[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Innermost:
    """The innermost span open at a time (spans nest: one thread)."""

    def __init__(self, spans: Sequence[Span]):
        self.spans = spans
        self.starts = [s.start_ns for s in spans]

    def __call__(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end_ns < t:
            i = self.spans[i].parent
        return i


def owners(spans: Sequence[Span],
           runtime: Sequence[RuntimeCall]) -> Dict[int, str]:
    """Each runtime call's correlation id: the innermost span open when
    the call began (:data:`OUTSIDE` where none was)."""
    inner = _Innermost(spans)
    out = {}
    for r in runtime:
        i = inner(r.start_ns)
        out[r.correlation] = spans[i].name if i >= 0 else OUTSIDE
    return out


def overlay(spans: Sequence[Span], device: Sequence[DeviceOp],
            runtime: Sequence[RuntimeCall],
            window: Optional[Tuple[int, int]] = None,
            steps: Optional[int] = None) -> dict:
    """Lay a session's spans over a device trace of the same process.

    Per span name (and :data:`OUTSIDE` for what no span covers), per
    batched step: ``calls``; ``host_self_ms`` (duration less the
    children's); ``device_ms``, the kernels, copies and sets launched
    while it was the innermost open span (by the launch call's correlation
    id); ``idle_ms``, the device idle time whose midpoint falls while it
    was the innermost open span; ``launches`` and ``syncs``, the runtime
    calls made while it was innermost. ``window`` (ns): the stretch whose
    idle time counts, by default from the first to the last span, device
    operation or runtime call; ``steps``: by default the distinct
    (episode, step) of the spans. Returns ``{"steps", "window_ms",
    "busy_ms", "idle_ms", "spans": {name: {...}}}``: the window's totals,
    and the spans' rows per step."""
    spans = list(spans)
    if window is None:
        ends = ([(s.start_ns, s.end_ns) for s in spans]
                + [(d.start_ns, d.end_ns) for d in device]
                + [(r.start_ns, r.end_ns) for r in runtime])
        window = (min(a for a, _ in ends), max(b for _, b in ends)) \
            if ends else (0, 0)
    t0, t1 = window
    if steps is None:
        steps = len({(s.episode, s.step) for s in spans})
    per = max(steps, 1)
    inner = _Innermost(spans)

    def name(i: int) -> str:
        return spans[i].name if i >= 0 else OUTSIDE

    rows: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(
        ("calls", "host_self_ms", "device_ms", "idle_ms", "launches",
         "syncs"), 0.0))
    for s, v in zip(spans, self_ns(spans)):
        rows[s.name]["calls"] += 1
        rows[s.name]["host_self_ms"] += v * 1e-6
    owner = owners(spans, runtime)
    for r in runtime:
        where = owner[r.correlation]
        if LAUNCH.match(r.name):
            rows[where]["launches"] += 1
        elif SYNC.match(r.name):
            rows[where]["syncs"] += 1
    for d in device:
        rows[owner.get(d.correlation, OUTSIDE)]["device_ms"] += (
            (d.end_ns - d.start_ns) * 1e-6)
    busy = _union((max(d.start_ns, t0), min(d.end_ns, t1)) for d in device
                  if d.end_ns > t0 and d.start_ns < t1)
    edges = [t0] + [v for se in busy for v in se] + [t1]
    idle = 0.0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        rows[name(inner((a + b) // 2))]["idle_ms"] += (b - a) * 1e-6
        idle += (b - a) * 1e-6
    return {"steps": steps, "window_ms": (t1 - t0) * 1e-6,
            "busy_ms": sum(e - s for s, e in busy) * 1e-6, "idle_ms": idle,
            "spans": {k: {f: v / per for f, v in r.items()}
                      for k, r in rows.items()}}


def table(ov: dict) -> str:
    """The per-span table of :func:`overlay`, one row a span name, the
    most idle first; every column per batched step."""
    lines = [f"{ov['steps']} steps, window {ov['window_ms']:.3f} ms, device "
             f"busy {ov['busy_ms']:.3f} ms "
             f"({100 * ov['busy_ms'] / max(ov['window_ms'], 1e-9):.2f}%), "
             f"idle {ov['idle_ms']:.3f} ms",
             f"{'span':<18} {'calls':>7} {'host self ms':>13} "
             f"{'device ms':>10} {'idle ms':>9} {'launches':>9} {'syncs':>7}"]
    for k, r in sorted(ov["spans"].items(), key=lambda kv: -kv[1]["idle_ms"]):
        lines.append(f"{k:<18} {r['calls']:>7.2f} {r['host_self_ms']:>13.3f} "
                     f"{r['device_ms']:>10.3f} {r['idle_ms']:>9.3f} "
                     f"{r['launches']:>9.2f} {r['syncs']:>7.2f}")
    return "\n".join(lines)
