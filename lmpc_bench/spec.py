"""What a cell is made of, found by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by name:

- ``configs/<config>.json``: the deployment. ``stage`` names its
  controller stage (``"lmpc"`` where it names none); ``upstream`` holds
  the controller's settings under the upstream project's names (RacingLMPC
  ``src/main.py``), ``port`` the batch, the lap runner and the port's
  preset and buffer sizes, with ``source``, ``assumed`` and ``reduced``.
- ``stages/<stage>.py``: what differs between controllers: how the
  configuration reaches the port's configs, the seeded state, an episode,
  the kept state fields, the roofline counts and the judge with its
  reference (``stages/__init__.py`` lists the hooks).
- ``traffic/<mix>.json``: the episodes: the seed laps' data file, the start
  state, the plant noise.
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from, and the sample size.

Every field a configuration file names reaches the port's configs by name
through its stage's public constructors, so a new configuration needs a
new file and no new code, and a new controller stage a new stage file and
no edit to the harness.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, NamedTuple

from lmpc_bench import stages

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    chips: int
    stage: str = stages.DEFAULT


def _load(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(path: pathlib.Path = BENCHMARK) -> Dict[str, Any]:
    return _load(path)


def cell(name: str, bench: Dict[str, Any] = None,
         root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its three files."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    config = _load(root / "configs" / f"{w['config']}.json")
    return Cell(name=name, config=config,
                traffic=_load(root / "traffic" / f"{w['traffic']}.json"),
                limits=_load(root / "limits" / f"{name}.json"),
                chips=int(w["chips"]),
                stage=config.get("stage", stages.DEFAULT))
