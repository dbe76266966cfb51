"""The MoE FFN's share of its roofline (%): the least times of the
``moe_apply`` calls recorded in the profiled part
(``bench/rooflines/moe_ffn_bf16.py``: the routed rows' products at the
bf16 peak, the router's at float32), summed, over the device time of the
activities launched inside their ``bench.moe_apply`` ranges and the
program's ``model.moe.*`` stage ranges nested in them (a launch belongs
to the innermost range, so the stages take time from
``bench.moe_apply``)."""
from harness import peaks


def read(run):
    p = run.prof
    r = p and p["ranges"].get("bench.moe_apply")
    recs = [k for k in run.prof_kernels if k["kernel"] == "moe_apply"]
    if not r or not recs:
        return None
    device_s = sum(v["device_s"] for k, v in p["ranges"].items()
                   if k == "bench.moe_apply"
                   or (k and k.startswith("model.moe.")))
    if device_s <= 0:
        return None
    m = run.model
    cost = run.cell.roofline("moe_ffn_bf16").cost
    bound = sum(peaks.bound_s(c["ops"], c["bytes"]) for c in (
        cost(k["T"], m["d_model"], m["d_ff"], m["n_experts"],
             m["experts_per_token"],
             gated=m["activation"] in ("swiglu", "geglu")) for k in recs))
    return 100.0 * bound / device_s
