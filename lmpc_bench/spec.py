"""What a cell is made of, found by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by name:

- ``configs/<config>.json``: the deployment. ``upstream`` holds the
  controller's settings under the upstream project's names (RacingLMPC
  ``src/main.py``), ``port`` the batch, the lap runner and the port's
  preset and buffer sizes, with ``source``, ``assumed`` and ``reduced``.
- ``traffic/<mix>.json``: the episodes: the seed laps' data file, the start
  state, the plant noise.
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from, and the sample size.

:func:`port_configs` turns a configuration into the port's
``LMPCConfig``, ``SolverConfig`` and ``SimConfig`` through their public
constructors; every field a file names reaches them by name, so a new
configuration needs a new file and no new code.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    chips: int


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
    return Cell(name=name,
                config=_load(root / "configs" / f"{w['config']}.json"),
                traffic=_load(root / "traffic" / f"{w['traffic']}.json"),
                limits=_load(root / "limits" / f"{name}.json"),
                chips=int(w["chips"]))


def port_configs(config: Dict[str, Any], traffic: Dict[str, Any],
                 overrides: Dict[str, Any] = None):
    """(LMPCConfig, SolverConfig, SimConfig) of a configuration under a
    mix. ``overrides`` replaces fields of the solver (``{"solver": {...}}``)
    or of the plant (``{"sim": {...}}``), for the control."""
    from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                                   SolverConfig)
    up, port = config["upstream"], config["port"]
    overrides = overrides or {}
    lmpc = LMPCConfig(
        N=up["N"], num_ss_it=up["numSS_it"], num_ss_points=up["numSS_Points"],
        dR=tuple(up["dR_LMPC"]), q_slack=tuple(up["Qslack"]),
        q_terminal_slack=up["QterminalSlack"], ey_max=up["halfWidth"],
        delta_max=up["inputConstr"][0], a_max=up["inputConstr"][1],
        fallback_vt=up["vt"], kernel_h=up["sysid"]["h"],
        knn_max=up["sysid"]["MaxNumPoint"],
        model_laps=up["sysid"]["usedIt"], **port["lmpc"])
    preset = port["solver"]["preset"]
    solver = dataclasses.replace(getattr(SolverConfig, preset)(),
                                 **port["solver"].get("replace", {}),
                                 **overrides.get("solver", {}))
    noise = traffic["noise"]
    sim = SimConfig(dt=up["dt"], noise=True,
                    noise_sigma=tuple(noise["sigma"]),
                    noise_clip=noise["clip"], noise_gain=noise["gain"],
                    **port["sim"], **overrides.get("sim", {}))
    return lmpc, solver, sim
