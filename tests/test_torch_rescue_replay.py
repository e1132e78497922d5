"""ROADMAP C7: B1's forced rescue on the main path's FTOCPs after step 200,
the kernel against its plain version, replayed on the CPU.

``tests/test_torch_rescue_replay.npz`` was written on an H100 by
``python -m racinglmpc_tpu_torch.runtime.rescue_replay --out ...``: the
bench's headline run (batch 256, a warm-up and 3 chunks of 50 steps), then
the forced rescue (``rescue_replay.forced_rescue``) on the next FTOCPs. It
holds the one lane whose iteration count differed between the kernel and
the plain version: its kernel inputs, both outputs on the card, and the
batch's counts. The verdict it pins:

- the counts agree on every other lane;
- on this lane the card's plain version left at a check where the exit
  test passed by a margin of a few percent, and the kernel's last iterate
  fails it: the lane sits at the threshold;
- the plain version itself, on the CPU with one thread (another summation
  order), gives a third count, and leaves only where its own exit test
  passes: the count belongs to the summation order, not to a fault of the
  kernel.
"""
import pathlib

import numpy as np
import torch

from racinglmpc_tpu_torch.ops import cuda_qp
from racinglmpc_tpu_torch.runtime import rescue_replay

FIXTURE = pathlib.Path(__file__).with_suffix(".npz")


def _load():
    args, kw, f = rescue_replay.load(str(FIXTURE))
    return args, kw, f


def test_counts_differ_on_one_lane_of_the_batch():
    _, kw, f = _load()
    k, p = f["kernel_iters_batch"], f["plain_iters_batch"]
    assert k.shape == p.shape == (256,)
    assert (k != p).sum() == 1 and int(f["lanes"][0]) == int(np.argmax(k != p))
    last = kw["max_iter"] + kw["rescue_max_iter"]
    assert int(f["kernel_iters"][0]) == last > int(f["plain_iters"][0])


def test_the_lane_sits_at_the_exit_threshold():
    args, kw, f = _load()
    t = torch.from_numpy
    plain = rescue_replay.exit_margins(args, kw, t(f["plain_x"]),
                                       t(f["plain_y"]))
    kernel = rescue_replay.exit_margins(args, kw, t(f["kernel_x"]),
                                        t(f["kernel_y"]))
    # the card's plain version left on the eps test, by a few percent
    assert 0.9 < plain["pri_eps"][0] < 1.0 and plain["dua_eps"][0] < 1.0
    # the kernel ran on to the last iteration and fails it there
    assert kernel["pri_eps"][0] > 1.0 and kernel["pri_exit"][0] > 1.0


def test_plain_version_on_the_cpu_gives_its_own_count():
    args, kw, f = _load()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x, y, pri, dua, iters, solved, rescued = cuda_qp.admm_iterate_plain(
            *args, **kw)
    finally:
        torch.set_num_threads(threads)
    assert bool(rescued[0]) and not bool(solved[0])
    n = int(iters[0])
    assert n != int(f["plain_iters"][0])
    if n < kw["max_iter"] + kw["rescue_max_iter"]:
        # it left early, where its own exit test passes
        m = rescue_replay.exit_margins(args, kw, x, y)
        assert ((m["pri_eps"][0] < 1.0 and m["dua_eps"][0] < 1.0)
                or m["pri_exit"][0] < 1.0)
