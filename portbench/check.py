"""What decides ``correct``: a sample of the window's requests, drawn from
the seed, served again by the plain reference, and four numbers against
the cell's limits (``portbench/limits/<cell>.json``).

* ``served_gap``: the gap by which a served token's logit lies below the
  reference's best at its position, the mean over the served tokens: the
  prompt's greedy token (the prefill's pick) and the decode step's (the
  argmax of the logits the step returned). Greedy tokens only: every
  request of these mixes is greedy. It catches a loss of precision, which
  moves many tokens a little.
* ``served_gap_max``: the widest of those gaps. It catches one token gone
  wrong, which the mean over the sample dilutes. With random weights a
  row's top logits are at times all but tied, and bf16 picks the other of
  two near-tied tokens; the limit sits above those gaps and far below a
  wrong token's (PERF.md, PR 31).
* ``step_logit_err``: the decode step's logits against the reference's at
  the same position, ``||program - reference|| / ||reference - mean||``
  over the vocabulary, the mean over the sampled rows. The step runs on
  the cache the prefill wrote, so this covers every layer of the prefill
  too. It catches a loss of precision, which moves every row.
* ``step_err_max``: the same error's widest row. It catches one row gone
  wrong (one slot's cache, say), which the mean over many rows dilutes.
  Its limit sits above the rows that a near-tied top-k choice in an MoE
  router sends to other experts in bf16 than in f32 (two to three times
  the others), and far below a wrong row's.

The reference is given the weights and prompts the benchmark drew and the
program's served tokens, and works out everything else again (the cache,
the routing). A number that is not finite fails.
"""
from __future__ import annotations

import importlib
import json
import math
import random
from pathlib import Path

import torch

from portbench import traffic

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NUMBERS = ("served_gap", "served_gap_max", "step_logit_err", "step_err_max")


def load_limits(cell: str, directory: Path = LIMITS_DIR) -> dict:
    return json.loads((directory / f"{cell}.json").read_text())


def sample(seed: int, finished: int, count: int):
    """``count`` of the ``finished`` requests' indices (all when fewer),
    drawn from the seed. Every request of a mix has the same length, so
    any sample holds the longest."""
    rng = random.Random(traffic.request_seed(seed, "check"))
    return sorted(rng.sample(range(finished), min(count, finished)))


def rel_err(logits, ref):
    """Per row: ||logits - ref|| / ||ref - mean(ref)||, f32."""
    ref = ref.float()
    return (logits.float() - ref).norm(dim=-1) / (ref - ref.mean(-1, keepdim=True)).norm(dim=-1)


def gaps(ref, first, second):
    """Per row, the gaps (B, 2) of token ``first`` at the reference's first
    position and ``second`` at its second, below each position's best."""
    best = ref.max(dim=-1).values
    picked = ref.gather(-1, torch.stack([first, second], dim=1)[..., None])[..., 0]
    return best - picked


def reference_logits(config, params, prompts, served, kind="f32"):
    """The configuration's plain reference (``portbench/reference/<arch>``)
    at ``kind`` precision: logits (B, 2, V) at the prompt's last position
    and at the served token's."""
    from portbench.reference.common import Precision
    ref = importlib.import_module(f"portbench.reference.{config['arch']}")
    return ref.logits(config, params, prompts, served, Precision(kind))


def row_readings(ref, first, logits):
    """Per row of one request: the step's logit error, and the gaps of the
    prompt's greedy token ``first`` and of the step's argmax."""
    g = gaps(ref, first, logits.argmax(-1))
    return {"step_logit_err": rel_err(logits, ref[:, 1]).tolist(),
            "gap_prompt": g[:, 0].tolist(), "gap_step": g[:, 1].tolist()}


def summarise(rows: dict) -> dict:
    """The numbers compared, from the sampled rows' readings."""
    gap, err = rows["gap_prompt"] + rows["gap_step"], rows["step_logit_err"]
    return {"served_gap": _mean(gap), "served_gap_max": _max(gap),
            "step_logit_err": _mean(err), "step_err_max": _max(err)}


def judge(config, mix, params, served, seed, limits, device, control=False):
    """``served``: per finished request (index, tokens (B, n), step logits
    (B, n, V)). Returns the numbers compared, as {name: (value, limit)},
    the sampled requests, and every row's readings (``row_readings``); with
    ``control`` those also of the control: the reference with fp8 products
    put in the program's place, at the tokens it puts first."""
    picked = sample(seed, len(served), limits["requests"])
    rows = {"program": {}, "control": {}}
    for i in picked:
        index, tokens, step = served[i]
        prompts = traffic.prompts(mix, config["vocab_size"], seed, index, device)
        first, logits = tokens[:, 0].to(device), step[:, 0].to(device).float()
        ref = reference_logits(config, params, prompts, first)
        _extend(rows["program"], row_readings(ref, first, logits))
        if control:
            low = reference_logits(config, params, prompts, first, "fp8")
            _extend(rows["control"], row_readings(ref, low[:, 0].argmax(-1), low[:, 1]))
            del low
        del ref
        if device != "cpu":
            torch.cuda.empty_cache()
    numbers = summarise(rows["program"])
    return {k: (v, limits.get(k)) for k, v in numbers.items()}, picked, rows


def _extend(into: dict, more: dict):
    for k, v in more.items():
        into.setdefault(k, []).extend(v)


def _mean(values) -> float:
    """The mean, infinite where a value is not finite."""
    mean = math.fsum(values) / len(values) if values else 0.0
    return mean if math.isfinite(mean) else math.inf


def _max(values) -> float:
    """The largest, infinite where a value is not finite."""
    return max((v if math.isfinite(v) else math.inf for v in values), default=0.0)


def passes(compared: dict) -> bool:
    """Every number within its limit (a number that is not finite fails)."""
    return all(v <= limit for v, limit in compared.values())
