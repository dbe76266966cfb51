"""The host window's roofline-bound time over its wall time (%): the sum
over every model call of the window (decode steps and prefill chunks,
as ``harness.probes`` recorded them) of the call's least time
(``bench/rooflines/decoder_step.py``: the larger of its operations over
their precisions' peaks and its bytes over HBM bandwidth)."""


def read(run):
    if not run.calls:
        return None
    step = run.cell.roofline("decoder_step")
    s = run.serving
    bound = sum(step.bound_s(run.model, c, max_seq=s["max_seq"],
                             page_size=s["page_size"]) for c in run.calls)
    return 100.0 * bound / run.host.seconds
