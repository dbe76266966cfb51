"""The readings that a cell's correctness limit is set from, in one
process: for each seed, one run of the cell (untraced, ``--seconds``
long) and the widest logit gap of its served tokens, beside the gap of
each control the configuration names (``controls`` in
``bench/configs/<config>.json``: the reference in a lower precision, put
in the program's place and read at the same positions).

    python3 bench/tools/readings.py --workload <cell> --seconds 10 \
        --seeds 1 2 3 [--controls int4 ...] [--out readings.jsonl]

The benchmark's own runs never run this.  One JSON line per seed.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", nargs="*", default=None,
                    help="control names (default: every one configured)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT / "bench"):
        sys.path.insert(0, str(p))
    from harness import runner, spec

    cell = spec.cell(args.workload, root=ROOT)
    controls = (list(cell.config.get("controls", {}))
                if args.controls is None else args.controls)
    out = open(args.out, "a") if args.out else None
    try:
        t = T_START
        for seed in args.seeds:
            r = runner.run_cell(cell, seed, args.seconds, False,
                                device=args.device, t_start=t,
                                controls=controls)
            tok_s = cell.metric_module("output_tok_s").read(r["data"])
            line = {"workload": cell.name, "seed": seed, **r["gaps"],
                    "sampled": r["sampled"],
                    "sampled_tokens": r["sampled_tokens"],
                    "short_outputs": r["failed"],
                    "setup_s": r["data"].setup_s, "output_tok_s": tok_s,
                    "checks_s": time.monotonic() - t - r["data"].setup_s
                    - r["data"].host.seconds}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            t = time.monotonic()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
