"""The host window's wall time over its engine ticks (ms)."""


def read(run):
    ticks = run.host.d["ticks"]
    return 1e3 * run.host.seconds / ticks if ticks else None
