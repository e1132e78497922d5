"""Controller stages, one file each, found by the name a configuration
gives (``"stage": "<name>"``; ``"lmpc"`` where it names none).

``stages/<name>.py`` supplies only what differs between controllers; the
window, the host clock, the CUDA event marks, the noise pool, the stream
order, the sample plan, the trace reduction, the metric and roofline
readers, ``judge.verdict`` and the result line stay in ``cell.py``,
``run.py`` and ``spec.py``. A stage file holds:

- ``setup(cell, device, overrides, batch) -> Setup``: the port's configs,
  the controller, the seeded state and the start plant. The harness reads
  ``cell``, ``device``, ``dtype``, ``batch``, ``sim`` (the port's
  ``SimConfig``) and ``step`` (the controller call the clock wraps) of the
  returned object; the rest is the stage's own.
- ``run_episode(S, clock, stream, want, lanes) -> cell.Episode``: one
  episode from the seeded state on noise stream ``stream`` (drawn through
  ``clock.noise``), whatever the stage runs: a lap closed, or a fixed
  number of steps with ``multi_lap``. Its ``sr`` has the lap runner's
  ``mask``, ``steps`` and ``collected``.
- ``keep_fields``: the state fields the clock keeps before and after a
  step, as ``(before, after)``.
- ``collect(state) -> (rejected, iterations)``: the per-step rejected flag
  and solver iterations that ``run.counters`` sums, given to the lap
  runner as its ``collect_fn``.
- ``work(S, win) -> {kernel: counts}``: the counts each
  ``roofline/<kernel>.py`` reads, over the profiled episodes.
- ``judge(S, win, seed, limits) -> numbers``: draws the samples, runs the
  stage's own reference under ``reference/`` and returns the numbers that
  ``judge.verdict`` holds to the cell's limits file. It may release the
  window's episodes (``cell.release``) once it holds host copies.
"""
from __future__ import annotations

import importlib
import pathlib

DEFAULT = "lmpc"


def load(name: str):
    """The module ``stages/<name>.py``."""
    path = pathlib.Path(__file__).resolve().parent / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise KeyError(f"no controller stage {name!r} (looked for {path})")
    return importlib.import_module(f"{__name__}.{name}")
