"""The decode kernels' split plan (``kernel.split_plan``, ``split_range``) on
the CPU.

Each (batch row, kv head) streams its valid cache slots in ``split_plan``
splits, split ``i`` taking the keys ``split_range(length, S, splits, i)``;
the bf16 kernel runs one block an SM, so at the serving shapes the grid must
be one wave on the H100's 132 SMs with equal shares. The splits' partial
softmaxes are merged in base 2, as the kernel does; a numpy copy of that
merge is held against the reference's ``decode_ref``. The kernels run only
on the card (``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ref import decode_ref as ref_decode
from repro_torch.kernels.decode_attn import kernel as DK

SHAPES = [(4, 4, 4096), (4, 4, 4640), (1, 1, 7), (2, 2, 300), (64, 8, 2048), (2, 4, 20),
          (1, 8, 500), (3, 4, 1000)]


def _coverage(length, s, splits):
    """How many splits take each cache slot."""
    hits = np.zeros(s, np.int64)
    for i in range(splits):
        a, b = DK.split_range(length, s, splits, i)
        assert 0 <= a <= b <= s
        hits[a:b] += 1
    return hits


@pytest.mark.parametrize("batch,hkv,s", SHAPES)
def test_splits_cover_every_valid_slot_once(batch, hkv, s):
    splits = DK.split_plan(batch, hkv, s, sm_count=132)
    rng = np.random.default_rng(s)
    for length in {s, 1, max(s // 3, 1), int(rng.integers(1, s + 1)), s - 1 or 1}:
        hits = _coverage(length, s, splits)
        assert (hits[:length] == 1).all() and (hits[length:] == 0).all()


@pytest.mark.parametrize("s", [300, 4096])
def test_a_zero_length_row_covers_the_whole_cache(s):
    """lengths == 0 masks every score: the softmax is uniform over all S
    slots, so the splits stream all of them."""
    splits = DK.split_plan(4, 4, s, sm_count=132)
    assert (_coverage(0, s, splits) == 1).all()


@pytest.mark.parametrize("s,lengths", [(4096, [4096] * 4), (4640, [4609, 4620, 4631, 4640])])
def test_serving_shapes_are_one_wave_of_equal_shares(s, lengths):
    """gemma2-2b's decode: batch 4, 4 kv heads, the local ring of 4096
    slots and the global cache of 4640. One block an SM: the grid fits the
    132 SMs in one wave, and the splits of a row differ by at most one key."""
    splits = DK.split_plan(4, 4, s, sm_count=132)
    assert splits == 8 and 4 * 4 * splits <= 132
    for length in lengths:
        keys = [b - a for a, b in (DK.split_range(length, s, splits, i) for i in range(splits))]
        assert sum(keys) == length and max(keys) - min(keys) <= 1


@pytest.mark.parametrize("batch,hkv,s,want", [(64, 8, 2048, 1), (1, 1, 7, 1), (2, 2, 300, 5),
                                              (1, 1, 100000, 132), (8, 4, 4096, 4)])
def test_split_plan(batch, hkv, s, want):
    """One wave where the (row, head) pairs fit the SMs, one split a pair
    where they do not, and no more splits than 64-slot pieces of the cache."""
    splits = DK.split_plan(batch, hkv, s, sm_count=132)
    assert splits == want
    assert splits == 1 or batch * hkv * splits <= 132
    assert splits <= math.ceil(s / DK.MIN_KEYS_PER_SPLIT)


@pytest.mark.parametrize("b,hkv,s,d,dtypes,want", [
    (4, 4, 4640, 256, (torch.bfloat16, torch.bfloat16), 8),     # gemma2: the ring kernel
    (4, 4, 4640, 256, (torch.float32, torch.bfloat16), 66),     # f32 q: the split kernel
    (4, 8, 4640, 64, (torch.bfloat16, torch.bfloat16), 4),      # granite-moe: the ring kernel
    (2, 8, 1032, 128, (torch.bfloat16, torch.bfloat16), 8),     # nemotron, arctic: the ring
    (4, 1, 2048, 256, (torch.bfloat16, torch.bfloat16), 32),    # recurrentgemma's 2048-slot ring
    (4, 16, 4096, 64, (torch.bfloat16, torch.bfloat16), 2),     # seamless's cross step: the ring
    (4, 8, 4640, 64, (torch.float32, torch.bfloat16), 33),      # granite, f32 q: the split kernel
    (2, 8, 1032, 128, (torch.float32, torch.float32), 17),      # f32: split, 64-slot cap
    (2, 8, 1032, 32, (torch.bfloat16, torch.bfloat16), 17),     # bf16 at D 32: the split kernel
])
def test_plan_for_gives_the_split_kernel_several_blocks_an_sm(b, hkv, s, d, dtypes, want):
    """The ring kernel (bf16 q and cache at D 64, 128 and 256) keeps one
    block an SM; the split kernel's grid aims at SPLIT_BLOCKS_PER_SM
    resident blocks an SM, within the 64-slot cap."""
    splits = DK.plan_for(b, hkv, s, d, *dtypes, sm_count=132)
    assert splits == want
    per_sm = 1 if DK.uses_ring(*dtypes, d) else DK.SPLIT_BLOCKS_PER_SM
    assert b * hkv * splits <= per_sm * 132
    assert splits <= math.ceil(s / DK.MIN_KEYS_PER_SPLIT)


def _split_merge(q, k, v, length, scale, softcap, splits):
    """The bf16 kernel's arithmetic in numpy (f64): each split's base-2
    online softmax state (m, l, acc), merged across the splits."""
    s = k.shape[0]
    masked = length <= 0
    log2e = 1.0 / math.log(2.0)
    parts = []
    for i in range(splits):
        a, b = DK.split_range(length, s, splits, i)
        x = k[a:b] @ q * scale
        if softcap:
            x = np.tanh(x / softcap) * softcap
        x = np.full_like(x, -1e30) if masked else x * log2e
        m = max(x.max(initial=-1e30), -1e30)
        p = np.exp2(x - m)
        parts.append((m, p.sum(), p @ v[a:b]))
    big = max(m for m, _, _ in parts)
    l_tot = sum(l * np.exp2(m - big) for m, l, _ in parts)
    return sum(acc * np.exp2(m - big) for m, _, acc in parts) / max(l_tot, 1e-30)


@pytest.mark.parametrize("s,length,softcap", [(300, 300, 50.0), (300, 1, 50.0), (300, 0, 50.0),
                                              (1000, 517, 0.0), (700, 3, 30.0), (20, 7, 50.0)])
def test_split_merge_matches_the_reference(s, length, softcap):
    """The splits of one (row, kv head) and G = 2 query heads, merged as the
    kernel merges them, against the reference's decode_ref on the same
    inputs (numpy from a seed), lengths == 0 included."""
    rng = np.random.default_rng(length + s)
    d, g = 64, 2
    q = rng.standard_normal((g, d))
    k, v = rng.standard_normal((s, d)), rng.standard_normal((s, d))
    scale = d ** -0.5
    splits = DK.split_plan(1, 1, s, sm_count=16)
    got = np.stack([_split_merge(q[h], k, v, length, scale, softcap, splits) for h in range(g)])
    want = ref_decode(jnp.asarray(q[:, None], jnp.float32),
                      jnp.asarray(np.broadcast_to(k, (g, s, d)), jnp.float32),
                      jnp.asarray(np.broadcast_to(v, (g, s, d)), jnp.float32),
                      jnp.full((g,), length, jnp.int32), scale=scale, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want)[:, 0], atol=2e-5, rtol=2e-5)


def test_scratch_is_kept_one_set_a_stream(monkeypatch):
    """The bf16 kernel's merge counters and the splits' partials: one set
    for each (device, stream), zeroed counters, reused by every launch on
    that stream and grown when a launch needs more, so launches on two
    streams never share them."""
    monkeypatch.setattr(DK, "_SCRATCH", {})
    cpu = torch.device("cpu")
    tickets, partials = DK._scratch(cpu, 11, 16, 1000)
    assert tickets.dtype == torch.int32 and tickets.numel() >= 16 and not tickets.any()
    assert partials.dtype == torch.float32 and partials.numel() >= 1000
    again = DK._scratch(cpu, 11, 16, 500)
    assert again[0] is tickets and again[1] is partials
    other = DK._scratch(cpu, 12, 16, 1000)
    assert other[0].data_ptr() != tickets.data_ptr()
    assert other[1].data_ptr() != partials.data_ptr()
    grown = DK._scratch(cpu, 11, 1000, 4000)
    assert grown[0].numel() >= 1000 and not grown[0].any() and grown[1].numel() >= 4000
    assert DK._scratch(cpu, 12, 16, 1000)[1] is other[1]
