"""``tpot_p95_ms``'s reader, in a cell where the host sets the pace (ms)."""
from pathlib import Path

from harness.spec import load_module

read = load_module(Path(__file__).with_name("tpot_p95_ms.py")).read
