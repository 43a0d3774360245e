"""The one traffic generator: every mix is a data file
``portbench/traffic/<name>.json`` of parameters that this module reads.

A mix's keys: ``batch`` (prompts a request), ``prompt_tokens`` (each
prompt's length), ``max_new_tokens`` (greedy tokens a request asks for),
``trace_requests`` (how many requests the traced run profiles). A request
is one call of the serving entry; the client is a closed loop, sending the
next request when the last has returned. Prompt ids are uniform over the
configuration's vocabulary, drawn on the device from the run's seed and
the request's index, so any request can be drawn again for the check.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
KEYS = ("batch", "prompt_tokens", "max_new_tokens", "trace_requests")


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    mix = json.loads((directory / f"{name}.json").read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    return mix


def request_seed(seed: int, index) -> int:
    """A 63-bit seed for request ``index`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"portbench/{seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def prompts(mix: dict, vocab: int, seed: int, index, device):
    """Request ``index``'s prompts: (batch, prompt_tokens) int64 ids."""
    import torch
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, index))
    return torch.randint(0, vocab, (mix["batch"], mix["prompt_tokens"]), generator=gen,
                         device=device)


def tokens_per_request(mix: dict) -> int:
    """Prompt tokens and generated tokens of one request."""
    return mix["batch"] * (mix["prompt_tokens"] + mix["max_new_tokens"])
