"""``mp_matmul``'s share of its roofline (%): the least times of the
calls recorded in the profiled part (``bench/rooflines/mp_matmul.py``),
summed, over the device time of the activities launched inside their
``bench.quant_matmul`` ranges."""
from harness import peaks


def read(run):
    p = run.prof
    r = p and p["ranges"].get("bench.quant_matmul")
    recs = [k for k in run.prof_kernels if k["kernel"] == "quant_matmul"]
    if not r or not recs or r["device_s"] <= 0:
        return None
    cost = run.cell.roofline("mp_matmul").cost_of
    bound = sum(peaks.bound_s(c["ops"], c["bytes"])
                for c in map(cost, recs))
    return 100.0 * bound / r["device_s"]
