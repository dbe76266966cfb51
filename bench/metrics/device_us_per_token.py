"""The device's busy time over the window, per output token emitted in
it (us): the union of the card's activity intervals (kernels, copies,
sets) recorded through the whole untraced window, over every output
token of the window.  What each token costs the card, whatever the
host's pace, which ``output_tok_s.host`` reads."""


def read(run):
    w = run.host
    if w.busy_s is None or not w.d["emitted"]:
        return None
    return 1e6 * w.busy_s / w.d["emitted"]
