"""The arithmetic of the window's metrics."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of every value (linear interpolation between
    order statistics, numpy's default), or None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def in_window(t: Optional[float], w) -> bool:
    return t is not None and w.t0 < t <= w.t1


def ttft_s(w) -> List[float]:
    """Send to first token of every request whose first token came in
    window ``w``."""
    return [r["t_first"] - r["t_submit"] for r in w.requests
            if in_window(r["t_first"], w)]


def tpot_ms(w) -> List[float]:
    """``(t_done - t_first) / (n_out - 1)`` of every request finished in
    window ``w`` with more than one token."""
    return [1e3 * (r["t_done"] - r["t_first"]) / (r["n_out"] - 1)
            for r in w.requests
            if in_window(r["t_done"], w) and r["n_out"] > 1]
