"""Process start to window start (s): imports, the kernel library (built
only by a checkout's first run), weights made on the device, SmoothQuant
calibration and quantization, the page pool, and the ramp until every
client has had a first token."""


def read(run):
    return run.setup_s
