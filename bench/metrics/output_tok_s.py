"""Every output token emitted inside the window, over the window's
seconds (host clock, between ticks; each tick ends in the sampler's
copy to the host, which waits for the device)."""


def read(run):
    w = run.host
    return w.d["emitted"] / w.seconds
