"""The host's waits for the device per decode step in the profiled part:
the copies launched inside ``engine.sync`` ranges (one a wait: a
pageable host-to-device copy or a device-to-host read), every sync of
the ticks (their prefill chunks' too), over the profiled part's decode
steps (``harness.probes`` records)."""


def read(run):
    p = run.prof
    r = p and p["ranges"].get("engine.sync")
    steps = sum(1 for c in run.prof_calls if c["kind"] == "decode")
    if not r or not steps:
        return None
    return r["launches"] / steps
