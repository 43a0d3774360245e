"""The bf16 flash kernel's schedule (``kernel.tile_plan``) on the CPU.

The schedule must reach every (q, k) pair the mask allows exactly once, skip
the mask only on tiles where it allows every pair, and count as many pairs
as the bound in ``chip_smoke.py``. The kernel itself runs only on the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import kernel as FK

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _allowed(sq, skv, causal, window, prefix=0):
    """The mask of the plain version (``ref.attention_ref``), as (sq, skv)."""
    if not causal:
        return np.ones((sq, skv), bool)
    ok = np.tri(sq, skv, 0, dtype=bool)                 # kpos <= qpos
    ok[:, :prefix] = True                               # or kpos < prefix
    if window:
        ok &= ~np.tri(sq, skv, -window, dtype=bool)     # qpos - kpos < window
    return ok


def _coverage(sq, skv, causal, window, prefix=0):
    """How many times the schedule reaches each pair, and whether a pair
    the mask refuses ever lands in an unmasked tile."""
    plan = FK.tile_plan(sq, skv, causal, window, prefix)
    allowed = _allowed(sq, skv, causal, window, prefix)
    cover = np.zeros((sq, skv), np.int16)
    unmasked_bad = 0
    for _, wgs in plan:
        for row0, tiles in wgs:
            rows = slice(row0, min(row0 + FK.WG_ROWS, sq))
            for k0, masked in tiles:
                keys = slice(k0, min(k0 + FK.BLOCK_K, skv))
                cover[rows, keys] += 1
                if not masked:
                    unmasked_bad += int((~allowed[rows, keys]).sum())
    return plan, allowed, cover, unmasked_bad


CASES = [(1, 1, True, 0), (63, 63, True, 0), (129, 129, True, 0), (300, 300, True, 100),
         (200, 200, True, 256), (100, 177, False, 0), (177, 100, False, 0),
         (150, 150, True, 0), (640, 640, True, 130)]
# (sq, prefix): causal with a prefix-LM prefix at ragged Sq: one key, a
# prefix inside the first tile, ones that end inside a tile or a q-block
# or on a tile's edge, P = Sq and P > Sq, and paligemma's 256 of 1024
PREFIX_CASES = [(333, 1), (333, 5), (333, 100), (333, 200), (333, 300), (333, 333),
                (150, 400), (300, 128), (1024, 256)]


@pytest.mark.parametrize("sq,skv,causal,window,prefix",
                         [c + (0,) for c in CASES] + [(s, s, True, 0, p) for s, p in PREFIX_CASES])
def test_plan_reaches_each_allowed_pair_once(sq, skv, causal, window, prefix):
    plan, allowed, cover, unmasked_bad = _coverage(sq, skv, causal, window, prefix)
    assert (cover[allowed] == 1).all()
    assert unmasked_bad == 0
    # every q-block of the sequence, each with two warpgroups of 64 rows
    assert sorted(q0 for q0, _ in plan) == list(range(0, sq, FK.BLOCK_Q))
    assert all([r for r, _ in wgs] == [q0, q0 + FK.WG_ROWS] for q0, wgs in plan)


@pytest.mark.parametrize("window", [4096, 0])
def test_plan_at_the_serving_shape_matches_the_bound(window):
    """gemma2-2b's prefill (S 4608, local window 4096 or global): the pairs
    the schedule reaches are the pairs ``flash_bound`` counts, the longest
    blocks launch first, and most tiles skip the mask."""
    s = 4608
    plan, allowed, cover, unmasked_bad = _coverage(s, s, True, window)
    assert (cover[allowed] == 1).all() and unmasked_bad == 0
    q = torch.empty((1, s, 1, 1))
    ops, _ = _chip_smoke().flash_bound(q, q, q, window)
    assert ops // 4 == int(allowed.sum())
    tiles = [len(wgs[0][1]) for _, wgs in plan]
    assert tiles[0] == max(tiles)
    if not window:
        assert tiles == sorted(tiles, reverse=True)
    flags = [m for _, wgs in plan for _, ts in wgs for _, m in ts]
    assert sum(flags) < 0.1 * len(flags)


def test_plan_non_causal_ignores_the_window():
    assert FK.tile_plan(100, 177, False, 64) == FK.tile_plan(100, 177, False, 0)
    assert FK.tile_plan(100, 177, False, 0, 50) == FK.tile_plan(100, 177, False, 0)


@pytest.mark.parametrize("sq,skv,causal,prefix", [
    (1024, 1024, True, 256),      # paligemma's prefill: 256 patches + 768 text tokens
    (333, 333, True, 200), (150, 150, True, 400),
    (64, 4096, False, 0),         # seamless's cross-attention prefill
    (300, 190, False, 0)])
def test_plan_pairs_match_the_bound_with_a_prefix_or_none(sq, skv, causal, prefix):
    """The pairs the schedule reaches under the mask are the pairs
    ``flash_bound`` counts, for the prefix-LM mask and without a mask; a
    tile wholly inside the prefix skips the mask even above the diagonal."""
    plan, allowed, cover, unmasked_bad = _coverage(sq, skv, causal, 0, prefix)
    assert (cover[allowed] == 1).all() and unmasked_bad == 0
    q, k = torch.empty((1, sq, 1, 1)), torch.empty((1, skv, 1, 1))
    ops, _ = _chip_smoke().flash_bound(q, k, k, 0, causal, prefix)
    assert ops // 4 == int(allowed.sum())
    if causal and prefix >= FK.BLOCK_K:
        first_block = next(wgs for q0, wgs in plan if q0 == 0)
        row0, tiles = first_block[0]
        assert (0, False) in tiles and any(k0 > row0 for k0, _ in tiles)
