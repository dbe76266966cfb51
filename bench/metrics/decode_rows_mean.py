"""Mean decoding rows per decode step in the host window: the tokens the
decode steps emitted (every token emitted less each request's first,
which comes off its last prefill chunk) over the decode steps."""
from harness import stats


def read(run):
    w = run.host
    steps = w.d["model_calls"] - w.d["prefill_calls"]
    if steps <= 0:
        return None
    firsts = sum(1 for r in w.requests if stats.in_window(r["t_first"], w))
    return (w.d["emitted"] - firsts) / steps
