"""95th percentile, over every request whose first token came in the
window, of the time from its client's send to its first token (s)."""
from harness import stats


def read(run):
    return stats.percentile(stats.ttft_s(run.host), 95)
