"""The ring kernel's schedule (``kernel.ring_plan``) on the CPU.

``decode_ring_kernel`` streams a split's keys through stages of 32 KB, 8192
/ D keys each; 8 consumer warps walk a stage in passes of 4 keys, scoring
each key with 8 lanes and accumulating V with lanes of 8 columns, 256 / D
lane groups at once. At D 256 with G 8 and 16 the tensor-core consumer
(``decode_ring_mma_kernel``) takes the stage instead: four key groups of 8
keys, two column halves, every tile four swizzled 64-column boxes, splits
of whole tiles. ``ring_plan`` writes either schedule out in Python.
These tests hold it to cover the work exactly once, to fit the card's
shared memory and TMA limits, and, walked in numpy in the kernel's order
and arithmetic (base-2 online softmax, lane groups summed, warps and splits
merged), to equal the reference's ``decode_ref``. The kernel itself runs
only on the card (``chip_smoke.py``).
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.decode_attn.ref import decode_ref as ref_decode
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as DK

# (d, g, length, s, splits): partial tiles, one split and many, one key,
# lengths one below and one above a stage, S not a multiple of a stage
# (d, g, length, s, splits); the last five at the tensor-core consumer's
# shapes: recurrentgemma's and paligemma's steps, a partial last tile,
# lengths == 0, S shorter than a tile, more splits than tiles
CASES = [(64, 3, 700, 700, 4), (64, 1, 129, 300, 2), (64, 8, 127, 127, 1), (64, 6, 1, 500, 8),
         (128, 6, 1032, 1032, 8), (128, 7, 65, 300, 1), (128, 4, 63, 200, 3),
         (128, 8, 517, 700, 16), (256, 2, 300, 300, 4), (256, 16, 100, 2048, 2),
         (256, 16, 2048, 2048, 16), (256, 8, 1056, 1056, 8), (256, 8, 1500, 2048, 5),
         (256, 16, 0, 300, 3), (256, 8, 7, 20, 4)]


def _scored(plan):
    """{(split, query row, column half): [absolute key, ...]} of every score
    computed (the column half None but at the tensor-core consumer's
    shapes, whose two column halves score the same keys)."""
    out = {}
    for sp in plan:
        for tile in sp["tiles"]:
            for ps in tile["passes"]:
                half = ps["cols"][0] if "cols" in ps else None
                for row in ps["rows"]:
                    out.setdefault((sp["split"], row, half), []).extend(
                        tile["t0"] + key for _, key in ps["scores"])
    return out


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_every_valid_key_is_scored_once_a_query_row(d, g, length, s, splits):
    """Each key of a split's range is scored by exactly one (warp, pass,
    lane group) for each query row (at the tensor-core consumer's shapes,
    one warp for each query row and column half), and no key outside it
    is."""
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    scored = _scored(plan)
    halves = [0, d // 2] if shape.mma else [None]
    for sp in plan:
        for row in range(g):
            for half in halves:
                keys = sorted(scored.get((sp["split"], row, half), []))
                assert keys == list(range(sp["start"], sp["end"])), (sp["split"], row, half)
        for tile in sp["tiles"]:
            for ps in tile["passes"]:
                assert [j for j, _ in ps["scores"]] == list(range(len(ps["scores"])))
                assert ps["base"] % DK.RING_PASS_KEYS == 0 and ps["base"] < tile["n"]
                assert len(ps["rows"]) == shape.rows


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_every_v_element_is_accumulated_by_one_lane(d, g, length, s, splits):
    """Each (key, column) of V in a split is accumulated by exactly one lane
    for each query row, 8 columns a lane, each lane on columns of its own
    (at the tensor-core consumer's shapes by exactly one warp, in its
    column half)."""
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    for sp in plan:
        for row in range(g):
            hits = np.zeros((s, d), np.int64)
            for tile in sp["tiles"]:
                for ps in tile["passes"]:
                    if row not in ps["rows"]:
                        continue
                    for lane, key, c0 in ps["pv"]:
                        if shape.mma:
                            assert c0 in ps["cols"] and c0 + 7 in ps["cols"]
                        else:
                            assert c0 == 8 * (lane % (d // 8))
                        hits[tile["t0"] + key, c0:c0 + 8] += 1
            assert (hits[sp["start"]:sp["end"]] == 1).all()
            assert hits[:sp["start"]].sum() == 0 and hits[sp["end"]:].sum() == 0


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_tiles_are_whole_boxes_or_row_copies(d, g, length, s, splits):
    """A whole tile is one TMA box of K and one of V; a split's last,
    partial tile copies each of its rows once, several a lane where the
    tile has more keys than 32; the tiles cycle through the stages. At the
    tensor-core consumer's shapes every tile is boxes, the splits start on
    a tile, and only the row's last tile is partial."""
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    n_row = s if length <= 0 else min(length, s)
    for sp in plan:
        tiles = sp["tiles"]
        assert sum(t["n"] for t in tiles) == sp["end"] - sp["start"]
        for i, tile in enumerate(tiles):
            assert tile["stage"] == i % DK.RING_STAGES
            assert tile["t0"] == sp["start"] + i * shape.tile_keys
            if shape.mma:
                assert tile["copy"] == "tma" and not tile["row_copies"]
                assert tile["t0"] % shape.tile_keys == 0
                assert tile["n"] == shape.tile_keys or tile["t0"] + tile["n"] == n_row
            elif tile["copy"] == "tma":
                assert tile["n"] == shape.box[2] == shape.tile_keys and not tile["row_copies"]
            else:
                assert i == len(tiles) - 1 and tile["n"] < shape.tile_keys
                rows = sorted(r for rs in tile["row_copies"].values() for r in rs)
                assert rows == list(range(tile["n"]))
                assert all(r % 32 == lane for lane, rs in tile["row_copies"].items() for r in rs)


@pytest.mark.parametrize("d", DK.RING_DIMS)
def test_ring_fits_shared_memory_and_tma_limits(d):
    """Stage bytes, q and the barriers fit a block's 227 KB at every group;
    each TMA box dimension is at most 256 and its inner extent a multiple
    of 16 bytes; a stage holds 8192 / D keys, whole passes for every warp."""
    groups = DK.GROUPS + (DK.ODD_GROUPS if d in DK.ODD_GROUP_DIMS else ()) + (
        DK.RING_GROUPS if d in DK.RING_GROUP_DIMS else ())
    for g in groups:
        shape = DK.ring_shape(d, g)
        assert shape.smem_bytes <= DK.SMEM_PER_BLOCK
        assert all(1 <= x <= 256 for x in shape.box)
        assert shape.box[0] * 2 % 16 == 0 and shape.box[0] * shape.boxes == d
        assert 2 * shape.tile_keys * shape.row_bytes == DK.RING_STAGE_BYTES
        if shape.mma:
            # 128-byte swizzled boxes, the M = 16 tile, key groups of 8
            assert g in DK.MMA_GROUPS and d in DK.MMA_DIMS and shape.box[0] * 2 == 128
            assert shape.rows == g <= 16
            assert shape.warp_keys * DK.MMA_KEY_GROUPS == shape.tile_keys
            # the key groups' merge ([4][G][D] f32 and m, l) fits the ring
            assert DK.MMA_KEY_GROUPS * g * (d + 2) * 4 <= DK.RING_STAGES * DK.RING_STAGE_BYTES
            continue
        assert shape.box[0] == d
        assert 2 * shape.tile_keys * shape.row_bytes == DK.RING_STAGE_BYTES
        assert shape.tile_keys == 8192 // d and shape.lane_groups * d == 256
        assert shape.warp_keys % DK.RING_PASS_KEYS == 0
        assert shape.warp_keys * DK.RING_CONSUMERS == shape.tile_keys
        assert shape.rows == g <= 8
    with pytest.raises(ValueError):
        DK.ring_shape(32, 1)
    with pytest.raises(ValueError):
        DK.ring_shape(128, 16)


def test_ring_constants_match_the_source():
    """The Python plan's constants are decode_attn.cu's."""
    src = _build.source("decode_attn").read_text()

    def const(name):
        return eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))  # noqa: S307

    assert const("kStageB") == DK.RING_STAGE_BYTES
    assert const("kStages") == DK.RING_STAGES
    assert const("kConsumers") == DK.RING_CONSUMERS
    assert const("kPassKeys") == DK.RING_PASS_KEYS
    assert const("kMmaKeyGroups") == DK.MMA_KEY_GROUPS
    assert const("kMmaGroupKeys") == DK.MMA_GROUP_KEYS
    assert const("kMmaBoxCols") == DK.MMA_BOX_COLS
    assert const("kMmaMaxSplits") == DK.MMA_MAX_SPLITS
    assert "D == 256 && (G == 8 || G == 16)" in src and DK.MMA_GROUPS == (8, 16)
    assert "static_assert(smem <= %d" % DK.SMEM_PER_BLOCK in src


def _walk(q, k, v, length, scale, softcap, splits):
    """The ring kernel's arithmetic in numpy (f64), in ``ring_plan``'s
    order: each warp's base-2 online softmax over its passes (m and l the
    warp's, each lane its own 8-column accumulator), the lane groups
    summed, the warps merged, then the splits."""
    g, d = q.shape
    s = k.shape[0]
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    log2e = 1.0 / math.log(2.0)
    if softcap:
        mul, cap2 = 2.0 * log2e * scale / softcap, softcap * log2e
    else:
        mul = scale * log2e
    nw, r_ = DK.RING_CONSUMERS, shape.rows
    parts = []
    for sp in plan:
        m = np.full((nw, r_), -1e30)
        l_ = np.zeros((nw, r_))
        acc = np.zeros((nw, 32, r_, 8))
        for tile in sp["tiles"]:
            t0 = tile["t0"]
            for ps in tile["passes"]:
                w, rows = ps["warp"], list(ps["rows"])
                keys = [key for _, key in ps["scores"]]
                dot = q[rows] @ k[[t0 + key for key in keys]].T            # (R, keys)
                x = cap2 - 2.0 * cap2 / (np.exp2(dot * mul) + 1.0) if softcap else dot * mul
                if length <= 0:
                    x = np.full_like(x, -1e30)
                mnew = np.maximum(m[w], x.max(axis=1))
                corr = np.exp2(m[w] - mnew)
                p = np.exp2(x - mnew[:, None])
                l_[w] = l_[w] * corr + p.sum(axis=1)
                m[w] = mnew
                acc[w] *= corr[None, :, None]
                for lane, key, c0 in ps["pv"]:
                    acc[w, lane] += p[:, keys.index(key)][:, None] * v[t0 + key, c0:c0 + 8]
        # the lane groups' partials summed, then each query row's warps merged
        warp_acc = np.zeros((nw, r_, d))
        for lane in range(32):
            c0 = 8 * (lane % (d // 8))
            warp_acc[:, :, c0:c0 + 8] += acc[:, lane]
        rows_out = []
        for row in range(g):
            big = m[:, row].max()
            c = np.exp2(m[:, row] - big)
            rows_out.append((big, (l_[:, row] * c).sum(),
                             (warp_acc[:, row] * c[:, None]).sum(axis=0)))
        parts.append(rows_out)
    out = np.zeros((g, d))
    for row in range(g):
        ms = np.array([p[row][0] for p in parts])
        c = np.exp2(ms - ms.max())
        total = (np.array([p[row][1] for p in parts]) * c).sum()
        out[row] = sum(p[row][2] * w for p, w in zip(parts, c)) / max(total, 1e-30)
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3, 4, 6, 7, 8])
@pytest.mark.parametrize("s,length,softcap,splits", [(300, 300, 0.0, 4), (300, 0, 50.0, 3),
                                                    (700, 517, 50.0, 5), (150, 129, 0.0, 1)])
def test_ring_walk_matches_the_reference(d, g, s, length, softcap, splits):
    """The numpy walk of the plan against the reference's decode_ref on the
    same inputs (numpy from a seed), f32 within 2e-5: lengths == 0 (uniform
    over S), partial tiles, one split and several."""
    rng = np.random.default_rng(d * 100 + g * 10 + length)
    q = rng.standard_normal((g, d))
    k, v = rng.standard_normal((s, d)), rng.standard_normal((s, d))
    scale = d ** -0.5
    got = _walk(q, k, v, length, scale, softcap, splits)
    want = ref_decode(jnp.asarray(q[:, None], jnp.float32),
                      jnp.asarray(np.broadcast_to(k, (g, s, d)), jnp.float32),
                      jnp.asarray(np.broadcast_to(v, (g, s, d)), jnp.float32),
                      jnp.full((g,), length, jnp.int32), scale=scale, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want)[:, 0], atol=2e-5, rtol=2e-5)


def _walk_mma(q, k, v, length, scale, softcap, splits):
    """The tensor-core consumer's arithmetic in numpy (f64), in
    ``ring_plan``'s order: each warp's base-2 online softmax over its key
    group's keys of each tile (m and l the key group's, the same in its two
    column halves), the accumulator of its column half, the key groups
    merged, then the splits (one cluster)."""
    g, d = q.shape
    s = k.shape[0]
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    log2e = 1.0 / math.log(2.0)
    if softcap:
        mul, cap2 = 2.0 * log2e * scale / softcap, softcap * log2e
    else:
        mul = scale * log2e
    nw = DK.RING_CONSUMERS
    parts = []
    for sp in plan:
        m = np.full((nw, g), -1e30)
        l_ = np.zeros((nw, g))
        acc = np.zeros((nw, g, d))
        for tile in sp["tiles"]:
            t0 = tile["t0"]
            for ps in tile["passes"]:
                w, cols = ps["warp"], np.asarray(ps["cols"])
                keys = [t0 + key for _, key in ps["scores"]]
                dot = q @ k[keys].T
                x = cap2 - 2.0 * cap2 / (np.exp2(dot * mul) + 1.0) if softcap else dot * mul
                if length <= 0:
                    x = np.full_like(x, -1e30)
                mnew = np.maximum(m[w], x.max(axis=1))
                corr = np.exp2(m[w] - mnew)
                p = np.exp2(x - mnew[:, None])
                l_[w] = l_[w] * corr + p.sum(axis=1)
                m[w] = mnew
                acc[w] *= corr[:, None]
                acc[w][:, cols] += p @ v[keys][:, cols]
        # the key groups (warps kg and kg + 4) merged: m and l from the
        # first column half, each half's columns from its own warp
        big = m[:DK.MMA_KEY_GROUPS].max(axis=0)
        c = np.exp2(m[:DK.MMA_KEY_GROUPS] - big)
        total = (l_[:DK.MMA_KEY_GROUPS] * c).sum(axis=0)
        halves = acc[:DK.MMA_KEY_GROUPS] + acc[DK.MMA_KEY_GROUPS:]
        parts.append((big, total, (halves * c[:, :, None]).sum(axis=0)))
    ms = np.array([p[0] for p in parts])
    c = np.exp2(ms - ms.max(axis=0))
    total = (np.array([p[1] for p in parts]) * c).sum(axis=0)
    out = sum(p[2] * w[:, None] for p, w in zip(parts, c))
    return out / np.maximum(total, 1e-30)[:, None]


@pytest.mark.parametrize("g", DK.MMA_GROUPS)
@pytest.mark.parametrize("s,length,softcap,splits", [(2048, 2048, 0.0, 16), (1056, 1056, 0.0, 8),
                                                    (700, 517, 50.0, 5), (300, 0, 50.0, 3),
                                                    (20, 7, 0.0, 2), (4096, 3000, 50.0, 16)])
def test_mma_walk_matches_the_reference(g, s, length, softcap, splits):
    """The numpy walk of the tensor-core consumer's plan (D 256) against
    the reference's decode_ref on the same inputs (numpy from a seed), f32
    within 2e-5: recurrentgemma's and paligemma's steps, a partial last
    tile with a softcap, lengths == 0 (uniform over S), S shorter than a
    tile with an empty split."""
    d = 256
    rng = np.random.default_rng(g * 10 + length)
    q = rng.standard_normal((g, d))
    k, v = rng.standard_normal((s, d)), rng.standard_normal((s, d))
    scale = d ** -0.5
    got = _walk_mma(q, k, v, length, scale, softcap, splits)
    want = ref_decode(jnp.asarray(q[:, None], jnp.float32),
                      jnp.asarray(np.broadcast_to(k, (g, s, d)), jnp.float32),
                      jnp.asarray(np.broadcast_to(v, (g, s, d)), jnp.float32),
                      jnp.full((g,), length, jnp.int32), scale=scale, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want)[:, 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("batch,s,want", [(4, 2048, 16), (4, 1056, 16), (4, 20, 1), (4, 100, 2),
                                          (1, 65536, 16), (64, 2048, 2), (12, 4096, 11)])
def test_mma_split_plan(batch, s, want):
    """The tensor-core consumer's splits, one cluster a (row, kv head): 16
    at recurrentgemma's 2,048-slot ring and paligemma's 1,056 slots,
    MMA_MIN_TILES stages of 32 keys a split at least, one block an SM at
    most; the splits of whole tiles cover every key once."""
    splits = DK.mma_split_plan(batch, 1, s, sm_count=132)
    assert splits == want
    assert DK.plan_for(batch, 1, s, 256, DK.torch.bfloat16, DK.torch.bfloat16, 132, g=16) == want
    for length in (s, s - 1, 1, 0):
        ranges = [DK.split_range(length, s, splits, i, tile=32) for i in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == (s if length <= 0 else length)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(a % 32 == 0 for a, _ in ranges)
