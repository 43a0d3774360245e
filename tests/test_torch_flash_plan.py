"""The bf16 flash kernel's schedule (``kernel.tile_plan``) on the CPU.

The schedule must reach every (q, k) pair the mask allows exactly once, skip
the mask only on tiles where it allows every pair, and count as many pairs
as the bound in ``chip_smoke.py``, at each head dim's own plan
(``kernel.PLANS``, which must equal ``Plan<D>`` in ``flash_attn.cu``).
Walked in numpy in the kernel's order and arithmetic (raw-score maxima with
the scale folded into the exponent, masks from two row bounds, the lazy
rescale, p rounded to bf16), it must equal the reference's
``attention_ref``. The kernel itself runs only on the card.
"""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import attention_ref as ref_attention
from repro_torch.kernels import _build
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


def _coverage(sq, skv, causal, window, prefix=0, head_dim=256):
    """How many times the schedule reaches each pair, and whether a pair
    the mask refuses ever lands in an unmasked tile."""
    plan = FK.tile_plan(sq, skv, causal, window, prefix, head_dim)
    allowed = _allowed(sq, skv, causal, window, prefix)
    cover = np.zeros((sq, skv), np.int16)
    unmasked_bad = 0
    for _, wgs in plan:
        for row0, tiles in wgs:
            rows = slice(row0, min(row0 + FK.WG_ROWS, sq))
            for k0, masked in tiles:
                keys = slice(k0, min(k0 + FK.PLANS[head_dim].block_k, skv))
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


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal,window,prefix",
                         [c + (0,) for c in CASES] + [(s, s, True, 0, p) for s, p in PREFIX_CASES])
def test_plan_at_each_head_dim_reaches_each_allowed_pair_once(sq, skv, causal, window, prefix,
                                                              head_dim):
    """As above at D 32, 64 and 128's own block and tile sizes (D 64:
    128-key tiles), with the ragged lengths, windows and prefixes."""
    block_q = FK.WG_ROWS * FK.block_warpgroups(head_dim, sq)
    plan, allowed, cover, unmasked_bad = _coverage(sq, skv, causal, window, prefix, head_dim)
    assert (cover[allowed] == 1).all()
    assert unmasked_bad == 0
    assert sorted(q0 for q0, _ in plan) == list(range(0, sq, block_q))
    assert all([r for r, _ in wgs] == list(range(q0, q0 + block_q, FK.WG_ROWS))
               for q0, wgs in plan)
    assert all(k0 % FK.PLANS[head_dim].block_k == 0
               for _, wgs in plan for _, ts in wgs for k0, _ in ts)


@pytest.mark.parametrize("head_dim,sq,want", [(64, 1, 2), (64, 64, 2), (64, 128, 2),
                                              (64, 129, 3), (64, 4608, 3), (128, 64, 2),
                                              (256, 4608, 2), (32, 1, 2)])
def test_short_sequences_take_two_warpgroups(head_dim, sq, want):
    """A plan of three consumer warpgroups runs two for Sq <= 128 (one block
    of two covers it), as ``short_block`` in ``flash_attn.cu`` chooses."""
    assert FK.block_warpgroups(head_dim, sq) == want
    src = _build.source("flash_attn").read_text()
    assert "return Plan<D>::NWG == 3 && Sq <= 2 * kWgRows;" in src


# reduced lengths of the D 64 and D 128 main-path prefills: granite-moe's
# causal prefill, seamless's encoder (non-causal, Sq = Skv) and its
# cross-attention (Sq 64 against the encoder's keys), the 4c archs' causal
# prefill at its own 1024 tokens
ZOO_REDUCED = [(64, 1000, 1000, True), (64, 700, 700, False), (64, 64, 900, False),
               (128, 1024, 1024, True)]


@pytest.mark.parametrize("head_dim,sq,skv,causal", ZOO_REDUCED)
def test_plan_pairs_match_the_bound_at_reduced_zoo_shapes(head_dim, sq, skv, causal):
    """Every allowed pair once, the mask skipped only where it allows every
    pair, and the pairs reached equal to ``flash_bound``'s count."""
    plan, allowed, cover, unmasked_bad = _coverage(sq, skv, causal, 0, 0, head_dim)
    assert (cover[allowed] == 1).all() and unmasked_bad == 0
    q, k = torch.empty((1, sq, 1, 1)), torch.empty((1, skv, 1, 1))
    ops, _ = _chip_smoke().flash_bound(q, k, k, 0, causal)
    assert ops // 4 == int(allowed.sum())
    flags = [m for _, wgs in plan for _, ts in wgs for _, m in ts]
    assert sum(flags) < 0.5 * len(flags) or sq < 256


def _source_plans():
    """{head dim or "default": {field: value}} from flash_attn.cu's Plan."""
    src = _build.source("flash_attn").read_text()
    out = {}
    for m in re.finditer(r"struct Plan(?:<(\d+)>)? \{(.*?)\};", src, re.S):
        fields = dict(re.findall(r"(\w+) = (\w+)", m.group(2)))
        out[int(m.group(1)) if m.group(1) else "default"] = fields
    return out


def test_plans_match_the_source():
    """``kernel.PLANS`` is ``Plan<D>`` of ``flash_attn.cu`` at every head dim
    (with the split launch it allows), and ``kernel.STAGES`` and
    ``SPLIT_STAGES`` the source's ring depths of the two launches."""
    text = _build.source("flash_attn").read_text()
    assert f"constexpr int kStages = {FK.STAGES};" in text
    assert f"constexpr int kSplitStages = {FK.SPLIT_STAGES};" in text
    src = _source_plans()
    for d in FK.HEAD_DIMS:
        fields = src.get(d, src["default"])
        p = FK.PLANS[d]
        assert (int(fields["BK"]), int(fields["NWG"]), fields["FOLD"] == "true",
                fields["SPLIT"] == "true") == (p.block_k, p.warpgroups, p.fold, p.split), d
        # shared memory: Q, the K and V rings and the mbarriers within 227 KB
        st = FK.STAGES
        smem = (1024 + p.block_q * d * 2 + 2 * st * p.block_k * d * 2
                + 8 * (p.warpgroups + 4 * st))
        assert smem <= 232448 and p.block_k <= 256 and p.warpgroups in (2, 3)
        if p.split:   # two warpgroups' Q, the deeper ring and one partial
            st = FK.SPLIT_STAGES
            smem = (1024 + 2 * FK.WG_ROWS * d * 2 + 2 * st * p.block_k * d * 2
                    + 128 * (d // 2 + 4) * 4 + 8 * (2 + 4 * st))
            assert smem <= 232448 and st % 2 == 0


# (batch, heads, sq, skv, causal, window, prefix, head_dim): paligemma's
# prefill (256 items) and seamless's cross prefill (split: 64 items; at
# batch 1, 16), then the edges of phase 2's cases: Sq 63 against a ragged
# 4,001, Sq 1, four heads, Sq 33 against 700, 192 split items, the D 256
# and D 32 plans with a window, non-causal Sq != Skv, prefixes of 300 and
# 256 at 1,000 tokens, causal Sq <= 64 at D 64 with a prefix and seamless's
# self prefill (one tile: warpgroup 1 has none), and gemma2's local layer
WORK_CASES = [(4, 8, 1024, 1024, True, 0, 256, 256), (4, 16, 64, 4096, False, 0, 0, 64),
              (1, 16, 64, 4096, False, 0, 0, 64),
              (4, 16, 63, 4001, False, 0, 0, 64), (4, 16, 1, 4096, False, 0, 0, 64),
              (1, 4, 64, 4096, False, 0, 0, 64), (2, 16, 33, 700, False, 0, 0, 64),
              (12, 16, 50, 1000, False, 0, 0, 64), (4, 8, 1000, 1000, True, 300, 0, 256),
              (4, 8, 700, 900, False, 0, 0, 256), (4, 8, 600, 600, True, 0, 0, 32),
              (4, 8, 1000, 1000, True, 0, 300, 256), (2, 24, 50, 50, True, 0, 40, 64),
              (2, 24, 64, 64, True, 0, 0, 64), (1, 8, 4608, 4608, True, 4096, 0, 256)]


@pytest.mark.parametrize("batch,heads,sq,skv,causal,window,prefix,head_dim", WORK_CASES)
def test_work_plan_covers_each_allowed_pair_once(batch, heads, sq, skv, causal, window, prefix,
                                                head_dim):
    """Over every block and warpgroup of ``work_plan``, each (batch, head)
    reaches each pair the mask allows exactly once and unmasked tiles hold
    only allowed pairs; one block an item, longest first across the grid;
    under "split" both warpgroups on the same rows, with alternate tiles."""
    mode, wgs, grid = FK.launch_plan(batch, heads, sq, skv, causal, window, prefix, head_dim)
    blocks = FK.work_plan(batch, heads, sq, skv, causal, window, prefix, head_dim)
    assert len(blocks) == grid
    bk = FK.PLANS[head_dim].block_k
    allowed = _allowed(sq, skv, causal, window, prefix)
    by_bh = {}
    for bh, q0, wl in blocks:
        by_bh.setdefault(bh, []).append(wl)
    assert sorted(by_bh) == list(range(batch * heads))
    for bh, wls in by_bh.items():
        cover = np.zeros((sq, skv), np.int16)
        bad = 0
        for wl in wls:
            assert len(wl) == wgs
            for row0, tiles in wl:
                rows = slice(row0, min(row0 + FK.WG_ROWS, sq))
                for k0, masked in tiles:
                    keys = slice(k0, min(k0 + bk, skv))
                    cover[rows, keys] += 1
                    if not masked:
                        bad += int((~allowed[rows, keys]).sum())
        assert (cover[allowed] == 1).all() and bad == 0, bh
    if mode == "split":
        # both warpgroups on the same rows, alternate tiles, warpgroup 0 the first
        assert all(wl[0][0] == wl[1][0] == 0 and len(wl[0][1]) - 1 <= len(wl[1][1])
                   <= len(wl[0][1]) for wls in by_bh.values() for wl in wls)
    # longest first across the grid
    sizes = [max(len(ts) for _, ts in wl) for _, _, wl in blocks]
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("batch,heads,sq,skv,causal,prefix,head_dim,want", [
    (4, 8, 1024, 1024, True, 256, 256, ("per block", 2, 256)),     # paligemma's prefill
    (4, 16, 64, 4096, False, 0, 64, ("split", 2, 64)),             # seamless's cross prefill
    (1, 16, 64, 4096, False, 0, 64, ("split", 2, 16)),             # ... at batch 1
    (4, 8, 4608, 4608, True, 0, 256, ("per block", 2, 1152)),      # gemma2's prefill
    (4, 16, 4096, 4096, False, 0, 64, ("per block", 3, 1408)),     # seamless's encoder
    (4, 24, 4608, 4608, True, 0, 64, ("per block", 3, 2304)),      # granite's prefill
    (2, 32, 1024, 1024, True, 0, 128, ("per block", 2, 512)),      # qwen3's prefill
    (4, 16, 64, 64, True, 0, 64, ("split", 2, 64)),                # seamless's self prefill
    (12, 16, 50, 1000, False, 0, 64, ("split", 2, 192))])
def test_launch_plan_by_shape(batch, heads, sq, skv, causal, prefix, head_dim, want):
    """The launch each main-path shape takes (``launch_wgmma_cap``): the
    decoder prompts of seamless split their keys over both warpgroups (the
    self prefill's one tile to warpgroup 0), every other prefill takes one
    block of 64 rows a warpgroup."""
    assert FK.launch_plan(batch, heads, sq, skv, causal, 0, prefix, head_dim) == want


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _units(scale, softcap, head_dim):
    """(mul, cap2, u, raw): the kernel's exponent scale, the softcap in log2
    units, the log2 units of m and whether the scores stay raw."""
    log2e = 1.4426950408889634
    raw = FK.PLANS[head_dim].fold and not softcap
    mul = np.float32(2 * log2e * scale / softcap if softcap else scale * log2e)
    return mul, np.float32(softcap * log2e), mul if raw else np.float32(1), raw


def _partial(q, k, v, row0, tiles, scale, causal, window, softcap, head_dim, prefix=0):
    """A consumer warpgroup's walk of its ``tiles`` for rows row0.. in the
    kernel's arithmetic: (m, l, acc) of its 64 rows, O unnormalised."""
    bk, sq, skv = FK.PLANS[head_dim].block_k, q.shape[0], k.shape[0]
    mul, cap2, u, raw = _units(scale, softcap, head_dim)
    rows = row0 + np.arange(FK.WG_ROWS)
    kk = np.arange(bk)
    qr = np.where((rows < sq)[:, None], q[np.minimum(rows, sq - 1)], 0)
    hi = np.full(FK.WG_ROWS, skv - 1)
    lo = np.full(FK.WG_ROWS, -2 ** 30)
    if causal:
        hi = np.minimum(hi, np.maximum(rows, prefix - 1))
        if window:
            lo = rows - window + 1
    m = np.full(FK.WG_ROWS, -1e30, np.float32)
    l = np.zeros(FK.WG_ROWS, np.float32)
    acc = np.zeros((FK.WG_ROWS, q.shape[1]), np.float32)
    for k0, masked in tiles:
        keys = k0 + kk
        inside = (keys < skv)[:, None]
        kt = np.where(inside, k[np.minimum(keys, skv - 1)], 0)
        vt = np.where(inside, v[np.minimum(keys, skv - 1)], 0)
        x = (qr.astype(np.float64) @ kt.T).astype(np.float32)
        if softcap:
            x = (cap2 - 2 * cap2 / (np.exp2(x * mul) + 1)).astype(np.float32)
        elif not raw:
            x = x * mul
        if masked:
            ok = (keys[None] >= lo[:, None]) & (keys[None] <= hi[:, None])
            x = np.where(ok, x, np.float32(-1e30))
        mx = np.maximum(m, x.max(1))
        grow = (mx - m) * u > 8
        corr = np.where(grow, np.exp2((m - mx) * u), np.float32(1)).astype(np.float32)
        m = np.where(grow, mx, m)
        if masked:
            e = ((x - m[:, None]) * u).astype(np.float32)
        else:
            e = (x.astype(np.float64) * u - (m * u)[:, None]).astype(np.float32)
        p = np.exp2(e).astype(np.float32)
        acc = acc * corr[:, None] + (_bf16(p).astype(np.float64) @ vt).astype(np.float32)
        l = l * corr + p.sum(1)
    return m, l, acc


def _merge(a, b, u):
    """Two partials merged as ``merge_part`` merges them: each side scaled by
    2^((m - M) u), M the larger m."""
    (m1, l1, acc1), (m2, l2, acc2) = a, b
    mx = np.maximum(m1, m2)
    c1 = np.exp2((m1 - mx) * u).astype(np.float32)
    c2 = np.exp2((m2 - mx) * u).astype(np.float32)
    return (mx, (l1 * c1 + l2 * c2).astype(np.float32),
            (acc1 * c1[:, None] + acc2 * c2[:, None]).astype(np.float32))


def _store(out, row0, part):
    rows = row0 + np.arange(FK.WG_ROWS)
    keep = rows < out.shape[0]
    _, l, acc = part
    out[rows[keep]] = (acc / np.maximum(l, 1e-30)[:, None])[keep]


def _walk(q, k, v, scale, causal, window, softcap, head_dim):
    """One head through ``tile_plan`` in the kernel's arithmetic: q (Sq, D),
    k and v (Skv, D) as f32 arrays of bf16 values; returns (Sq, D) f32."""
    sq, skv = q.shape[0], k.shape[0]
    out = np.zeros_like(q)
    for _, wgs in FK.tile_plan(sq, skv, causal, window, 0, head_dim):
        for row0, tiles in wgs:
            _store(out, row0, _partial(q, k, v, row0, tiles, scale, causal, window, softcap,
                                       head_dim))
    return out


# (head_dim, sq, skv, causal, window, softcap, input scale): D 64's plan at
# the tiling's edges (Sq and Skv no multiple of the 128-key tile or the
# block, Sq 1, Skv shorter than a tile, a wholly masked first tile: rows
# 192-255 of the block at 192 whose last tile starts at 256), non-causal Sq
# != Skv, a window, a softcap, and scores large enough to grow the row
# maxima by more than 2^8; D 128's plan; the shared plan at D 32 and 256
WALK_CASES = [(64, 300, 300, True, 0, 0.0, 1.0), (64, 77, 301, False, 0, 0.0, 1.0),
              (64, 300, 190, False, 0, 0.0, 1.0), (64, 1, 1, True, 0, 0.0, 1.0),
              (64, 40, 40, True, 0, 0.0, 1.0), (64, 200, 200, True, 0, 0.0, 1.0),
              (64, 300, 300, True, 100, 0.0, 1.0), (64, 150, 150, True, 0, 30.0, 1.0),
              (64, 384, 384, True, 0, 0.0, 1.0), (128, 300, 300, True, 100, 0.0, 4.0),
              (64, 256, 256, True, 0, 0.0, 4.0), (32, 150, 150, True, 0, 30.0, 1.0),
              (128, 200, 200, True, 0, 0.0, 1.0), (256, 130, 130, True, 0, 50.0, 1.0)]


@pytest.mark.parametrize("head_dim,sq,skv,causal,window,softcap,amp", WALK_CASES)
def test_walk_matches_repro_attention_ref(head_dim, sq, skv, causal, window, softcap, amp):
    """The schedule walked in the kernel's arithmetic against ``repro``'s
    ``attention_ref`` on the same bf16 inputs, within chip_smoke's
    TOL["bfloat16"] for K3: 1e-4 + 2^-7 |ref| + 2^-8 (|p| @ |v|)."""
    rng = np.random.default_rng(head_dim * 1000 + sq + skv)
    q = _bf16(rng.standard_normal((2, sq, head_dim)) * amp)
    k = _bf16(rng.standard_normal((2, skv, head_dim)) * amp)
    v = _bf16(rng.standard_normal((2, skv, head_dim)))
    scale = 1.0 / math.sqrt(head_dim)
    args = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    ref = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **args))
    pv = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(np.abs(v)),
                                  **args))
    got = np.stack([_bf16(_walk(q[h], k[h], v[h], scale, causal, window, softcap, head_dim))
                    for h in range(2)])
    limit = 1e-4 + 2 ** -7 * np.abs(ref) + 2 ** -8 * pv
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= limit).all(), (np.abs(got - ref) / limit).max()


def _walk_work(q, k, v, heads, scale, causal, window, softcap, head_dim):
    """Every head of one batch row through ``work_plan`` in the kernel's
    arithmetic: each block's warpgroups' partials, under "split" warpgroup
    1's merged into warpgroup 0's before the rows are stored. q (heads, Sq,
    D), k and v (heads, Skv, D); returns (heads, Sq, D) f32."""
    prefix = 0
    sq, skv = q.shape[1], k.shape[1]
    mode = FK.launch_plan(1, heads, sq, skv, causal, window, prefix, head_dim)[0]
    u = _units(scale, softcap, head_dim)[2]
    out = np.zeros_like(q)
    for bh, q0, wl in FK.work_plan(1, heads, sq, skv, causal, window, prefix, head_dim):
        args = (scale, causal, window, softcap, head_dim, prefix)
        parts = [_partial(q[bh], k[bh], v[bh], row0, tiles, *args) for row0, tiles in wl]
        if mode == "split":
            _store(out[bh], q0, _merge(*parts, u))
        else:
            for (row0, _), part in zip(wl, parts):
                _store(out[bh], row0, part)
    return out


# (head_dim, heads, sq, skv, causal, window, softcap, input scale):
# seamless's cross prefill reduced (Sq 64 against 900 keys: 8 tiles, 4 a
# warpgroup), ragged Sq and Skv with a softcap, Sq 1, one head of 17 tiles
# with scores large enough to grow the row maxima by more than 2^8, causal
# Sq <= 64 (one tile: warpgroup 1 has none), two tiles (one a warpgroup),
# three heads of ragged 800 keys, and the D 256 and D 32 plans' blocks with
# a window and a softcap
WORK_WALK_CASES = [(64, 2, 64, 900, False, 0, 0.0, 1.0),
                   (64, 2, 33, 700, False, 0, 30.0, 1.0),
                   (64, 2, 1, 500, False, 0, 0.0, 1.0),
                   (64, 1, 64, 2100, False, 0, 0.0, 4.0),
                   (64, 2, 50, 50, True, 0, 0.0, 1.0),
                   (64, 2, 64, 200, False, 0, 0.0, 1.0),
                   (64, 3, 60, 800, False, 0, 0.0, 1.0),
                   (256, 2, 500, 500, True, 100, 50.0, 1.0),
                   (32, 2, 400, 400, True, 0, 30.0, 1.0)]


@pytest.mark.parametrize("head_dim,heads,sq,skv,causal,window,softcap,amp", WORK_WALK_CASES)
def test_split_walk_matches_repro_attention_ref(head_dim, heads, sq, skv, causal, window, softcap,
                                                amp):
    """``work_plan``'s blocks, their warpgroups' partials and, under "split",
    the merge in shared memory walked in the kernel's arithmetic against
    ``repro``'s ``attention_ref`` on the same bf16 inputs, within
    chip_smoke's TOL["bfloat16"] for K3."""
    rng = np.random.default_rng(head_dim * 7 + heads * 1000 + sq + skv)
    q = _bf16(rng.standard_normal((heads, sq, head_dim)) * amp)
    k = _bf16(rng.standard_normal((heads, skv, head_dim)) * amp)
    v = _bf16(rng.standard_normal((heads, skv, head_dim)))
    scale = 1.0 / math.sqrt(head_dim)
    args = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    ref = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **args))
    pv = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(np.abs(v)),
                                  **args))
    got = _bf16(_walk_work(q, k, v, heads, scale, causal, window, softcap, head_dim))
    limit = 1e-4 + 2 ** -7 * np.abs(ref) + 2 ** -8 * pv
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= limit).all(), (np.abs(got - ref) / limit).max()
