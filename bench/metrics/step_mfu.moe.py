"""The host window's roofline-bound time over its wall time (%), with
the experts priced in bf16: the sum over every model call of the window
(decode steps and prefill chunks, as ``harness.probes`` recorded them)
of the call's least time (``bench/rooflines/decoder_step_bf16_experts.py``:
``step_mfu``'s parts with the MoE FFN at the bf16 peak).  For a cell whose
configuration serves its experts in bf16, where ``step_mfu`` prices them
at float32."""


def read(run):
    if not run.calls:
        return None
    step = run.cell.roofline("decoder_step_bf16_experts")
    s = run.serving
    bound = sum(step.bound_s(run.model, c, max_seq=s["max_seq"],
                             page_size=s["page_size"]) for c in run.calls)
    return 100.0 * bound / run.host.seconds
