"""``output_tok_s``'s reader, in a cell where the host sets the pace
(tokens/s): read in the host part of a traced window."""
from pathlib import Path

from harness.spec import load_module

read = load_module(Path(__file__).with_name("output_tok_s.py")).read
