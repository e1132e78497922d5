"""Host-side plans and launch arguments of kernels B2, B3 and B4 (CPU
only).

``cuda_sysid.plan`` must fit the main path's store (T = 512) and the
default ``model_pts`` (T = 1024) two CTAs to an SM, so a batch of 256 runs
in one wave; the launch arguments are built once per (vehicle, table,
config) and a different vehicle or table gives new ones. The SASS and
``-Xptxas -v`` readers of ``runtime/kernel_bench.py`` are checked on
fixed text. ``cuda_qp_fused.plan`` (B4's prologue) must keep one CTA of
512 threads per SM within the card's shared memory, the prologue's core
must follow n alone, and the output cells of both cores (the resident
core's 6 x 8, ``product``'s 8 x 8) must cover every output of a product
exactly once.
"""
import dataclasses

import pytest
import torch

from racinglmpc_tpu_torch.models.track import TrackTable, make_track
from racinglmpc_tpu_torch.models.track import track_table
from racinglmpc_tpu_torch.ops import (cuda_build, cuda_qp, cuda_qp_fused,
                                      cuda_rollout, cuda_sysid)
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


@pytest.mark.parametrize("knn, records", [(1, 7), (7, 7), (8, 8), (32, 32),
                                          (40, 32)])
def test_sysid_plan_scratch_of_each_instance(knn, records):
    """A warp's scratch holds MAX_KNN records of 10 floats for the list
    instance, and a rescan's chunk (knn, at most CHUNK) above it; the main
    path's shapes keep one wave either way."""
    assert cuda_sysid.warp_bytes(knn) == 40 * records
    pl = cuda_sysid.plan(4, 512, 14, 256, knn)
    assert pl.nbytes == (cuda_sysid.HEADER + 2 * 512 * 8 * 4
                         + 14 * 40 * records)
    assert pl.nbuf == 2 and pl.ctas_per_sm == 2 and pl.waves == 1


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


# (n, m): the MPC stages' FTOCP (LTI and LTV), the main path's LMPC FTOCP,
# the random QPs of tests/test_torch_fused_qp.py; the prologue's core, its
# cell threads and passes
FUSED_SHAPES = [(146, 202, "resident", 475, 1), (200, 257, "product", 325, 2),
                (30, 26, "resident", 20, 1)]


@pytest.mark.parametrize("n, m, core, threads, passes", FUSED_SHAPES)
def test_fused_plan_one_cta_per_sm(n, m, core, threads, passes):
    pl = cuda_qp_fused.plan(n, m, 256)
    assert pl.layout == cuda_qp.choose_layout(n, m).name == "resident"
    assert pl.core == core
    kbuild = cuda_qp.ctx_floats(n, m) + cuda_qp.prologue_floats(n)
    if core == "product":
        # the context, the product core's slabs and the diagonal
        assert pl.nbytes == 4 * kbuild
    else:
        # the mbarriers, the scratch, the diagonal, then X, R and two slabs
        # of K, over which the K build lays its context and slabs
        g = cuda_qp_fused.rgeo(n)
        mats = 2 * (g.rows * g.ld + 8) + 2 * g.rows * 20
        assert pl.nbytes == 4 * (8 + 32 + cuda_qp._r4(n)
                                 + max(kbuild - cuda_qp._r4(n), mats))
    assert pl.nbytes <= cuda_build.SMEM_PER_CTA
    assert pl.ctas_per_sm == 1 and pl.waves == 2
    assert cuda_qp_fused.plan(n, m, 132).waves == 1
    assert (pl.threads, pl.passes) == (threads, passes)


def test_fused_plan_registers_hold_one_cta():
    # 512 threads of up to 128 registers take the whole register file; at
    # n = 146 the resident core's shared memory alone holds one CTA too,
    # at n = 200 the product core's would hold three
    assert cuda_qp_fused.MAX_REGS * 512 == cuda_build.REGS_PER_SM
    res = cuda_qp_fused.plan(146, 202, 256)
    assert cuda_build.SMEM_PER_SM // (res.nbytes
                                      + cuda_build.SMEM_RESERVED) == 1
    pro = cuda_qp_fused.plan(200, 257, 256)
    assert cuda_build.SMEM_PER_SM // (pro.nbytes
                                      + cuda_build.SMEM_RESERVED) >= 3
    assert res.ctas_per_sm == pro.ctas_per_sm == 1


@pytest.mark.parametrize("n", [1, 6, 8, 30, 146, 151, 152])
def test_fused_resident_cells_cover_each_output_once(n):
    """The resident core's cell geometry (cuda_qp_fused.cu:rgeo): thread
    t < cr cc holds cell (t / cc, t % cc), rows 6 ci + r (r < 6), columns
    4 cj + q and 4 cc + 4 cj + q (q < 4); X, R and the slab buffers hold
    every row and column a cell or a product's k reads."""
    g = cuda_qp_fused.rgeo(n)
    assert g.cr * g.cc <= 512 and 8 * g.cc >= n and 6 * g.cr >= n
    assert g.ld % 4 == 0 and (g.ld // 4) % 2 == 1 and g.ld >= n
    assert g.rows >= 6 * g.cr and g.rows >= cuda_qp._r4(n)
    assert 8 * g.cc <= g.ld + 8     # the last row's columns past ld
    assert g.nslab * 16 >= n
    seen = torch.zeros((n, n), dtype=torch.int32)
    for t in range(g.cr * g.cc):
        ci, cj = divmod(t, g.cc)
        rows = [6 * ci + r for r in range(6)]
        cols = [4 * cj + q for q in range(4)] + [
            4 * g.cc + 4 * cj + q for q in range(4)]
        for i in rows:
            for j in cols:
                if i < n and j < n:
                    seen[i, j] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("n, core", [(1, "resident"), (30, "resident"),
                                     (146, "resident"), (151, "resident"),
                                     (152, "resident"), (153, "product"),
                                     (160, "product"), (200, "product")])
def test_fused_core_follows_n_alone(n, core):
    """The prologue's core changes at n = 152, the largest n whose 6 x 8
    cells fit 512 threads, whatever m; where it is resident its layout
    fits a CTA's shared memory at the stages' and the main path's m."""
    assert cuda_qp_fused.RESIDENT_MAX_N == 152
    assert cuda_qp_fused.core(n) == core
    for m in (1, 26, 202, 257, 1000):
        pl = cuda_qp_fused.plan(n, m)
        assert pl.core == core
        assert pl.nbytes <= cuda_build.SMEM_PER_CTA
    # the workspace holds the resident core's K and slabs, and the 4 n^2
    # floats B1's rescue takes after
    assert cuda_qp_fused.ws_floats(n) >= 4 * n * n
    if core == "resident":
        g = cuda_qp_fused.rgeo(n)
        assert cuda_qp_fused.ws_floats(n) >= (cuda_qp._r4(n * n)
                                              + g.nslab * n * 20)


@pytest.mark.parametrize("n", [1, 8, 30, 146, 168, 169, 200, 257])
def test_fused_product_cells_cover_each_output_once(n):
    """The product core's cell geometry (qp_common.cuh:product): thread t of
    a pass holds cell (t / cells, t % cells), rows 4 ci + r and 4 cr + 4 ci
    + r, columns 4 cj + q and 4 cells + 4 cj + q (r, q < 4); the warps past
    the cells' (at least one) stage the operands."""
    g = cuda_qp.geo(n)
    assert -(-g.cr * g.cells // 32) <= 15 and 8 * g.cells >= n
    assert (g.passes == 1) == (n <= 168)
    assert g.sa % 32 == 4 and g.sa >= 8 * g.cr
    seen = torch.zeros((n, n), dtype=torch.int32)
    for pas in range(g.passes):
        for t in range(g.cr * g.cells):
            ci, cj = divmod(t, g.cells)
            rows = [pas * 8 * g.cr + 4 * ci + r for r in range(4)] + [
                pas * 8 * g.cr + 4 * g.cr + 4 * ci + r for r in range(4)]
            cols = [4 * cj + q for q in range(4)] + [
                4 * g.cells + 4 * cj + q for q in range(4)]
            for i in rows:
                for j in cols:
                    if i < n and j < n:
                        seen[i, j] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("n, m", [(1, 1), (2, 1), (8, 6), (9, 6), (30, 26),
                                  (146, 202), (168, 230), (200, 257)])
def test_rescue_bands_cover_each_output_once(n, m):
    """B1's rescue prologue on a cluster (qp_common.cuh:rescue_split,
    rescue_band): at most 8 CTAs a lane, one per 8-row cell below that,
    then half as many while at least 2; at each of these splits and on one
    CTA the bands are whole cells (the last ends at n) that cover rows
    0..n once, and within each band the product core's cells cover every
    output once; a band's slabs fit the whole matrix's, and the CTA's
    shared memory one SM."""
    split = cuda_qp.rescue_split(n)
    assert 1 <= split <= 8 and split == min(8, -(-n // 8))
    splits = cuda_qp.rescue_splits(n)
    assert splits == tuple(c for c in (split, split // 2, split // 4)
                           if c >= 2)
    for c in splits + (1,):
        _bands_cover_each_output_once(n, c)
    assert cuda_qp.rescue_smem(n, m) == 4 * (cuda_qp.ctx_floats(n, m)
                                             + cuda_qp.prologue_floats(n))
    assert cuda_qp.rescue_smem(n, m) + cuda_build.SMEM_RESERVED <= \
        cuda_build.SMEM_PER_CTA


def _bands_cover_each_output_once(n, c):
    full = cuda_qp.geo(n)
    seen = torch.zeros((n, n), dtype=torch.int32)
    r_prev = 0
    for rank in range(c):
        r0, r1 = cuda_qp.rescue_band(n, c, rank)
        assert r0 == r_prev and r1 > r0 and r0 % 8 == 0
        assert r1 % 8 == 0 or r1 == n
        r_prev = r1
        g = cuda_qp.geo(n, r1 - r0)
        assert g.cells == full.cells and g.sa <= full.sa and g.sa % 32 == 4
        assert -(-g.cr * g.cells // 32) <= 15
        for pas in range(g.passes):
            for t in range(g.cr * g.cells):
                ci, cj = divmod(t, g.cells)
                rows = [r0 + pas * 8 * g.cr + 4 * ci + r for r in range(4)]
                rows += [r0 + pas * 8 * g.cr + 4 * g.cr + 4 * ci + r
                         for r in range(4)]
                cols = [4 * cj + q for q in range(4)] + [
                    4 * g.cells + 4 * cj + q for q in range(4)]
                for i in rows:
                    for j in cols:
                        if i < r1 and j < n:
                            seen[i, j] += 1
    assert r_prev == n
    assert bool((seen == 1).all())


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
