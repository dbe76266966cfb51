"""The engine's ``prefill_measured_s`` over the host window's prefill
chunk calls (ms): host time inside ``lm.prefill_into_slot``."""


def read(run):
    d = run.host.d
    n = d["prefill_calls"]
    return 1e3 * d["prefill_measured_s"] / n if n > 0 else None
