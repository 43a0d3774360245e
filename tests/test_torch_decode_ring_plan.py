"""The ring kernel's schedule (``kernel.ring_plan``) on the CPU.

``decode_ring_kernel`` streams a split's keys through stages of 32 KB, 8192
/ D keys each; 8 consumer warps walk a stage in passes of 4 keys, scoring
each key with 8 lanes and accumulating V with lanes of 8 columns, 256 / D
lane groups at once. ``ring_plan`` writes that schedule out in Python.
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
CASES = [(64, 3, 700, 700, 4), (64, 1, 129, 300, 2), (64, 8, 127, 127, 1), (64, 6, 1, 500, 8),
         (128, 6, 1032, 1032, 8), (128, 7, 65, 300, 1), (128, 4, 63, 200, 3),
         (128, 8, 517, 700, 16), (256, 2, 300, 300, 4), (256, 16, 100, 2048, 2)]


def _scored(plan):
    """{(split, query row): [absolute key, ...]} of every score computed."""
    out = {}
    for sp in plan:
        for tile in sp["tiles"]:
            for ps in tile["passes"]:
                for row in ps["rows"]:
                    out.setdefault((sp["split"], row), []).extend(
                        tile["t0"] + key for _, key in ps["scores"])
    return out


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_every_valid_key_is_scored_once_a_query_row(d, g, length, s, splits):
    """Each key of a split's range is scored by exactly one (warp, pass,
    lane group) for each query row, and no key outside it is."""
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    scored = _scored(plan)
    for sp in plan:
        for row in range(g):
            keys = sorted(scored.get((sp["split"], row), []))
            assert keys == list(range(sp["start"], sp["end"])), (sp["split"], row)
        for tile in sp["tiles"]:
            for ps in tile["passes"]:
                assert [j for j, _ in ps["scores"]] == list(range(len(ps["scores"])))
                assert ps["base"] % DK.RING_PASS_KEYS == 0 and ps["base"] < tile["n"]
                assert len(ps["rows"]) == shape.rows


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_every_v_element_is_accumulated_by_one_lane(d, g, length, s, splits):
    """Each (key, column) of V in a split is accumulated by exactly one lane
    for each query row, 8 columns a lane, each lane on columns of its own."""
    _, plan = DK.ring_plan(d, g, length, s, splits)
    for sp in plan:
        for row in range(g):
            hits = np.zeros((s, d), np.int64)
            for tile in sp["tiles"]:
                for ps in tile["passes"]:
                    if row not in ps["rows"]:
                        continue
                    for lane, key, c0 in ps["pv"]:
                        assert c0 == 8 * (lane % (d // 8))
                        hits[tile["t0"] + key, c0:c0 + 8] += 1
            assert (hits[sp["start"]:sp["end"]] == 1).all()
            assert hits[:sp["start"]].sum() == 0 and hits[sp["end"]:].sum() == 0


@pytest.mark.parametrize("d,g,length,s,splits", CASES)
def test_tiles_are_whole_boxes_or_row_copies(d, g, length, s, splits):
    """A whole tile is one TMA box of K and one of V; a split's last,
    partial tile copies each of its rows once, several a lane where the
    tile has more keys than 32; the tiles cycle through the stages."""
    shape, plan = DK.ring_plan(d, g, length, s, splits)
    for sp in plan:
        tiles = sp["tiles"]
        assert sum(t["n"] for t in tiles) == sp["end"] - sp["start"]
        for i, tile in enumerate(tiles):
            assert tile["stage"] == i % DK.RING_STAGES
            assert tile["t0"] == sp["start"] + i * shape.tile_keys
            if tile["copy"] == "tma":
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
        assert shape.box[0] * 2 % 16 == 0 and shape.box[0] == d
        assert 2 * shape.tile_keys * shape.row_bytes == DK.RING_STAGE_BYTES
        assert shape.tile_keys == 8192 // d and shape.lane_groups * d == 256
        assert shape.warp_keys % DK.RING_PASS_KEYS == 0
        assert shape.warp_keys * DK.RING_CONSUMERS == shape.tile_keys * shape.row_groups
        assert shape.rows * shape.row_groups == g and shape.rows <= 8
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
            ws = list(range(row // r_, nw, shape.row_groups))
            big = m[ws, row % r_].max()
            c = np.exp2(m[ws, row % r_] - big)
            rows_out.append((big, (l_[ws, row % r_] * c).sum(),
                             (warp_acc[ws, row % r_] * c[:, None]).sum(axis=0)))
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
