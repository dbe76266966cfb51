"""Run one cell of the benchmark once, as ``BENCHMARK.json`` names it.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It serves the cell's traffic with the
PyTorch and CUDA port (``src/repro_torch``) on the card, measures the
window, checks the served tokens against the plain reference
(``bench/reference``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``,
each number compared beside its limit (also the last lines on standard
error).  It exits non-zero and prints no result without enough cards,
or when JAX, flax or the JAX package ``repro`` is loaded once the
window has closed.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The port and the harness on the path; every build and kernel cache
    at a fixed directory inside the checkout; the thread pools' sizes."""
    for p in (ROOT / "src", ROOT / "bench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    # one process, few threads: no OpenMP pool beside the dispatching
    # thread on the card's shared host
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell, out: dict, trace: bool, device_info: dict) -> dict:
    """The result's JSON object from ``runner.run_cell``'s output."""
    from harness import trace as trace_mod

    data = out["data"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_module(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(v is not None and v <= lim
                  for v, lim in out["checks"].values())
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=out["memory_peak_bytes"])}
    if trace and data.prof is not None:
        line["device"]["busy_s"] = data.prof["busy_s"]
        line["device"]["window_s"] = data.prof["window_s"]
        line["breakdown"] = {
            "device_ops": trace_mod.top(data.prof["device_ops"]),
            "idle_gaps": trace_mod.top(data.prof["idle"])}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    import torch

    from harness import runner, spec

    cell = spec.cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda:0", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    line = result_line(cell, out, bool(args.trace), info)
    print(f"sampled {out['sampled']} requests, {out['sampled_tokens']} "
          f"served tokens; gaps {json.dumps(out['gaps'])}", file=sys.stderr)
    host = out["data"].host
    if host.parts:
        print(f"device trace: {len(host.parts)} parts, "
              f"{sum(q['n_device'] for q in host.parts)} activities, busy "
              f"{host.busy_s!r} s of {host.tick_s!r} s ticking", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
