"""A cell at a size the CPU runs in seconds: the configuration with every
width cut, and a small mix."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

NAME = "granite-moe-3b-a800m"
CELL = f"{NAME}.prompt_4k"
# the published routing (40 experts, top-8): with fewer experts a router's
# near-tie moves a larger share of a row, and rows read several times the
# full-size cell's widest
SIZES = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
         "vocab_size": 256, "attention_multiplier": 0.0625}
# deeper, for the control: its error grows with depth
DEEP = {"num_hidden_layers": 8}
# 16 rows a request, so that one row is a small share of a sample's
MIX = {"batch": 16, "prompt_tokens": 40, "max_new_tokens": 1, "trace_requests": 1}


def config(deep: bool = False) -> dict:
    c = json.loads((ROOT / "portbench" / "configs" / f"{NAME}.json").read_text())
    c.update(SIZES)
    if deep:
        c.update(DEEP)
    return c


def cell(mix=None, limits=None, deep: bool = False) -> dict:
    """The cell with its configuration cut and under ``mix`` (MIX), with
    the real cell's metrics and, unless given, its limits."""
    from portbench import harness
    out = copy.deepcopy(harness.load_cell(CELL))
    out.update(config=config(deep), mix=dict(mix or MIX))
    if limits is not None:
        out["limits"] = limits
    return out
