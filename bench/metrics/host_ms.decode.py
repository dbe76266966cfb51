"""The engine's ``decode_measured_s`` over the host window's decode
calls (ms): host time inside ``lm.decode_step``, including any wait its
host-to-device copies make."""


def read(run):
    d = run.host.d
    steps = d["model_calls"] - d["prefill_calls"]
    return 1e3 * d["decode_measured_s"] / steps if steps > 0 else None
