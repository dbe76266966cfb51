"""``paged_mha_decode``'s share of its roofline (%): the least times of
the calls recorded in the profiled part
(``bench/rooflines/paged_mha_decode.py``), summed, over the device
time of the activities launched inside their ``bench.paged_mha_decode``
ranges."""
from harness import peaks


def read(run):
    p = run.prof
    r = p and p["ranges"].get("bench.paged_mha_decode")
    recs = [k for k in run.prof_kernels if k["kernel"] == "paged_mha_decode"]
    if not r or not recs or r["device_s"] <= 0:
        return None
    cost = run.cell.roofline("paged_mha_decode").cost_of
    bound = sum(peaks.bound_s(c["ops"], c["bytes"])
                for c in map(cost, recs))
    return 100.0 * bound / r["device_s"]
