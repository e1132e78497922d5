"""Host-side plans and launch arguments of kernels B2 and B3 (CPU only).

``cuda_sysid.plan`` must fit the main path's store (T = 512) and the
default ``model_pts`` (T = 1024) two CTAs to an SM, so a batch of 256 runs
in one wave; the launch arguments are built once per (vehicle, table,
config) and a different vehicle or table gives new ones. The SASS and
``-Xptxas -v`` readers of ``runtime/kernel_bench.py`` are checked on
fixed text.
"""
import dataclasses

import pytest
import torch

from racinglmpc_tpu_torch.models.track import TrackTable, make_track
from racinglmpc_tpu_torch.models.track import track_table
from racinglmpc_tpu_torch.ops import cuda_build, cuda_rollout, cuda_sysid
from racinglmpc_tpu_torch.runtime import kernel_bench
from racinglmpc_tpu_torch.utils.config import (LMPCConfig, SimConfig,
                                               VehicleParams)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def table():
    return track_table(make_track(device="cpu"))


@pytest.mark.parametrize("T", [512, 1024])
def test_sysid_plan_one_wave_at_the_main_path_shapes(T):
    pl = cuda_sysid.plan(4, T, 14, 256)
    assert pl.nbuf == 2
    assert pl.nbytes <= cuda_build.SMEM_PER_CTA
    assert pl.nbytes == cuda_sysid.HEADER + 2 * T * 8 * 4 + 14 * 280
    assert pl.ctas_per_sm == 2
    assert 2 * (pl.nbytes + cuda_build.SMEM_RESERVED) <= cuda_build.SMEM_PER_SM
    assert pl.waves == 1 and 256 <= pl.ctas_per_sm * cuda_build.N_SM


def test_sysid_plan_registers_hold_two_ctas():
    # 14 warps of 64-register threads: two CTAs take 57,344 of 65,536
    assert 2 * 14 * 32 * cuda_sysid.MAX_REGS <= cuda_build.REGS_PER_SM
    assert 3 * 14 * 32 * cuda_sysid.MAX_REGS > cuda_build.REGS_PER_SM
    assert cuda_sysid.plan(4, 512, 16).ctas_per_sm == 2
    assert cuda_sysid.plan(4, 512, 32).ctas_per_sm == 1


def test_sysid_plan_long_laps_fall_back_to_one_buffer():
    one = cuda_sysid.plan(4, 2048, 14)
    assert one.nbuf == 1 and one.ctas_per_sm == 2
    big = cuda_sysid.plan(4, 6000, 14, 256)
    assert big.nbuf == 1 and big.ctas_per_sm == 1 and big.waves == 2
    assert cuda_sysid.plan(1, 512, 14).nbuf == 1
    with pytest.raises(ValueError, match="does not fit"):
        cuda_sysid.plan(4, 8000, 14)


def test_rollout_params_cached_per_vehicle_table_config(table):
    vp, cfg = VehicleParams(), SimConfig()
    p = cuda_rollout.launch_params(vp, table, cfg)
    assert cuda_rollout.launch_params(VehicleParams(), table, SimConfig()) is p
    heavy = cuda_rollout.launch_params(vp._replace(m=2.5), table, cfg)
    assert heavy is not p and heavy.m == pytest.approx(2.5) \
        and p.m == pytest.approx(vp.m)
    other = dataclasses.replace(table, curv=(0.5,) + table.curv[1:])
    q = cuda_rollout.launch_params(vp, other, cfg)
    assert q is not p and q.curv[0] == pytest.approx(0.5) and p.curv[0] == 0
    fine = cuda_rollout.launch_params(vp, table, SimConfig(substeps=50))
    assert fine is not p and fine.substeps == 50
    assert p.nseg == len(table.s0) and p.L == pytest.approx(table.total_len)
    assert p.dT == pytest.approx(cfg.delta_t)


def test_rollout_params_refuse_tables_the_kernel_cannot_carry(table):
    vp, cfg = VehicleParams(), SimConfig()
    back = TrackTable(s0=(0.0, 2.0, 1.0), curv=(0.0, 0.1, 0.0),
                      total_len=3.0)
    with pytest.raises(ValueError, match="must not decrease"):
        cuda_rollout.launch_params(vp, back, cfg)
    many = TrackTable(s0=tuple(float(i) for i in range(17)),
                      curv=(0.0,) * 17, total_len=17.0)
    with pytest.raises(ValueError, match="segments"):
        cuda_rollout.launch_params(vp, many, cfg)


def test_sysid_params_cached_per_shape_config_table(table):
    cfg = LMPCConfig(model_pts=512)
    p = cuda_sysid.launch_params(4, 512, 14, 2, cfg, 0.1, table)
    assert cuda_sysid.launch_params(4, 512, 14, 2, LMPCConfig(model_pts=512),
                                    0.1, table) is p
    assert (p.K, p.T, p.N, p.knn, p.nbuf) == (4, 512, 14, 7, 2)
    assert p.reg == pytest.approx(cfg.reg_lambda + cfg.reg_jitter)
    wide = cuda_sysid.launch_params(4, 512, 14, 2,
                                    dataclasses.replace(cfg, kernel_h=2.0),
                                    0.1, table)
    assert wide is not p and wide.h == 2.0 and p.h == 5.0
    other = dataclasses.replace(table, total_len=table.total_len + 1.0)
    q = cuda_sysid.launch_params(4, 512, 14, 2, cfg, 0.1, other)
    assert q is not p and q.L == pytest.approx(table.total_len + 1.0)
    assert cuda_sysid.launch_params(4, 1024, 14, 2, cfg, 0.1, table).T == 1024


SASS = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   FFMA R5, R2, R3, R4 ;
        /*0020*/                   MUFU.RCP R6, R5 ;
        /*0030*/              @!P0 BRA `(.L_x_2) ;
        /*0040*/                   FSETP.GT.AND P0, PT, R6, R2, PT ;
        /*0050*/                   IADD3 R7, P1, R6, R2, RZ ;
        /*0060*/                   STL [R1+0x4], R7 ;
        /*0070*/                   CALL.REL.NOINC 0x200 ;
        /*0080*/               @P0 BRA `(.L_x_1) ;
.L_x_2:
        /*0090*/                   EXIT ;
"""


def test_kernel_bench_reads_loops_and_chains_from_sass():
    insns = kernel_bench._parse(SASS)
    assert [i[1] for i in insns][:3] == ["LDC", "FFMA", "MUFU.RCP"]
    assert insns[3][4] == 0x90 and insns[-2][4] == 0x10
    assert insns[5][2] == ["R7", "P1"]
    loop = kernel_bench._loop_stats(insns, 0x10, 0x80)
    # FFMA -> MUFU -> FSETP -> BRA, and MUFU -> IADD3 -> STL
    assert (loop["instructions"], loop["mufu"], loop["local"],
            loop["calls"], loop["chain"]) == (8, 1, 1, 1, 4)


def test_kernel_bench_reads_ptxas_registers_stack_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z4kern' for "
           "'sm_90a'\nptxas info    : Function properties for _Z4kern\n"
           "    32 bytes stack frame, 4 bytes spill stores, 8 bytes spill "
           "loads\nptxas info    : Used 64 registers, used 1 barriers\n")
    assert kernel_bench.ptxas_info(log) == {"_Z4kern": dict(
        stack=32, spill_stores=4, spill_loads=8, registers=64)}
