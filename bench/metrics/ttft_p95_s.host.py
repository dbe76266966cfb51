"""``ttft_p95_s``'s reader, in a cell where the host sets the pace (s)."""
from pathlib import Path

from harness.spec import load_module

read = load_module(Path(__file__).with_name("ttft_p95_s.py")).read
