"""Operations and bytes of each kernel of the port, from the window's
shapes and counts, and the card's peaks. ``<kernel>.py`` holds
``work(rec) -> (operations, bytes)`` for the profiled episodes' launches;
:func:`share` turns it into the share of the roofline."""
from __future__ import annotations

from typing import Optional, Tuple

from lmpc_bench.roofline.peaks import PEAKS


def least_seconds(ops: float, nbytes: float, card: str) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    p = PEAKS[card]
    t_ops, t_bytes = ops / p["float32_flops"], nbytes / p["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(ops: float, nbytes: float, device_s: float,
          card: str) -> Optional[Tuple[float, str]]:
    """Percent of the roofline (least time / device time) and its bound;
    None where the kernel did not run."""
    if device_s <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    t, bound = least_seconds(ops, nbytes, card)
    return 100.0 * t / device_s, bound
