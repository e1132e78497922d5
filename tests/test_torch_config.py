"""The port's config tree equals the reference's, field by field."""
import dataclasses

import pytest
import torch

from racinglmpc_tpu.utils import config as jcfg
from racinglmpc_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

PRESETS = ["throughput", "throughput_max", "balanced", "parity"]


@pytest.mark.parametrize("name", ["SimConfig", "MPCConfig", "LMPCConfig",
                                  "SolverConfig"])
def test_dataclass_defaults_equal(name):
    ref, port = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("preset", PRESETS)
def test_solver_presets_equal(preset):
    ref = getattr(jcfg.SolverConfig, preset)()
    port = getattr(tcfg.SolverConfig, preset)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_vehicle_params_and_properties_equal():
    assert tcfg.VehicleParams()._asdict() == jcfg.VehicleParams()._asdict()
    assert (tcfg.NX, tcfg.NU) == (jcfg.NX, jcfg.NU)
    assert tcfg.SimConfig().delta_t == jcfg.SimConfig().delta_t
    assert tcfg.MPCConfig().x_ref == jcfg.MPCConfig().x_ref
    lt, lj = tcfg.LMPCConfig(max_pts=512, store_glob=False), \
        jcfg.LMPCConfig(max_pts=512, store_glob=False)
    for prop in ("points_per_lap", "ext_cap", "glob_cap"):
        assert getattr(lt, prop) == getattr(lj, prop)
