"""95th percentile, over every request finished in the window with more
than one token, of ``(t_done - t_first) / (n_out - 1)`` (ms)."""
from harness import stats


def read(run):
    return stats.percentile(stats.tpot_ms(run.host), 95)
