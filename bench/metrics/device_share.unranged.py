"""The device time whose innermost range is none of the program's
stages (``model.*``, ``engine.*``) nor the benchmark's kernel ranges
(``bench.*``) over all device time in the profiled part (%): what no
stage names yet.  Nothing where the program opens no stage range."""

NAMED = ("model.", "engine.", "bench.")


def read(run):
    p = run.prof
    if not p or not any(k and k.startswith(("model.", "engine."))
                        for k in p["ranges"]):
        return None
    total = sum(r["device_s"] for r in p["ranges"].values())
    if total <= 0:
        return None
    named = sum(r["device_s"] for k, r in p["ranges"].items()
                if k and k.startswith(NAMED))
    return 100.0 * (total - named) / total
