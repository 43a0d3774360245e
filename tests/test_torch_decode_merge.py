"""K2's log-sum-exp and the merge of its results over slices of one cache
(``models/attention.merge_shards``, which a sharded decode runs across the
ranks that split the cache's slots), on the CPU's plain version.

* ``decode_attention(..., return_lse=True)`` returns the output in f32
  (the same values the call without it rounds to q's dtype, bit for bit
  after that rounding) and the log-sum-exp of the scaled, softcapped,
  masked scores, -1e30 for a row of length 0, against ``torch.logsumexp``
  of the scores written out here.
* the merge of K2 over m in {2, 4, 16} slices along S, each at its local
  lengths ``clamp(len - offset, 0, slots)``, against K2 on the whole cache:
  ragged lengths, rows of length 0 (every slot masked: the whole cache's
  mean, as one call gives), full rows, slices with no valid slot, softcap
  and a wrapped ring's lengths (``decode_lengths``); f32 within 2e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attn.ops import decode_attention, decode_attention_plain
from repro_torch.models.attention import NEG_INF, decode_lengths, merge_stacked

TOL = 2e-5


def _case(b, s, hq, hkv, d, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dtype)
               for shape in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return q, k, v


def _scores_lse(q, k, lengths, scale, softcap):
    """logsumexp over the valid slots of the scaled, softcapped scores."""
    b, _, hq, d = q.shape
    g = hq // k.shape[2]
    kk = k.float().repeat_interleave(g, dim=2)                     # (B, S, Hq, D)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kk) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = torch.arange(k.shape[1])[None, None, :] < lengths[:, None, None]
    return torch.logsumexp(torch.where(valid, s, NEG_INF), dim=-1)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_and_unrounded_output(dtype, softcap):
    q, k, v = _case(4, 40, 8, 2, 32, dtype)
    lengths = torch.tensor([40, 17, 0, 1], dtype=torch.int32)
    out, lse = decode_attention(q, k, v, lengths, softcap=softcap, return_lse=True)
    plain = decode_attention(q, k, v, lengths, softcap=softcap)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (4, 8)
    assert torch.equal(out.to(dtype), plain)
    want = _scores_lse(q, k, lengths, 32 ** -0.5, softcap)
    assert (lse[2] == NEG_INF).all()
    keep = lengths > 0
    err = (lse[keep] - want[keep]).abs()
    assert (err <= 2e-5 * want[keep].abs() + 1e-5).all()


def _merge_slices(q, k, v, lengths, m, softcap):
    """K2 on each of m slices along S at its local lengths, then the merge."""
    s = k.shape[1]
    n = s // m
    outs, lses, has = [], [], []
    for i in range(m):
        mine = torch.clamp(lengths - i * n, 0, n).to(torch.int32)
        o, lse = decode_attention_plain(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                        mine, softcap=softcap, return_lse=True)
        outs.append(o)
        lses.append(lse)
        has.append((mine > 0) | (lengths <= 0))
    return merge_stacked(torch.stack(outs), torch.stack(lses), torch.stack(has))


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("m", [2, 4, 16])
def test_merge_of_slices_equals_the_whole_cache(m, softcap):
    b, s = 6, 64
    q, k, v = _case(b, s, 8, 4, 32, seed=m)
    # ragged, one slot, the first slice only, all masked, full, one past a slice edge
    lengths = torch.tensor([37, 1, s // m, 0, s, s // m + 1], dtype=torch.int32)
    merged = _merge_slices(q, k, v, lengths, m, softcap)
    whole = decode_attention_plain(q, k, v, lengths, softcap=softcap)
    assert (merged - whole).abs().max().item() <= TOL


@pytest.mark.parametrize("m", [2, 4, 16])
def test_merge_over_a_wrapped_ring(m):
    """A ring of W slots after positions past W: every slot is valid, in
    ring order, and attention does not depend on the order."""
    w = 32
    q, k, v = _case(3, w, 4, 1, 64, seed=7)
    pos = torch.tensor([5, w - 1, 3 * w + 11])
    lengths = decode_lengths(pos, w, ring=True)
    assert lengths.tolist() == [6, w, w]
    merged = _merge_slices(q, k, v, lengths, m, 0.0)
    whole = decode_attention_plain(q, k, v, lengths)
    assert (merged - whole).abs().max().item() <= TOL


def test_a_slice_without_valid_slots_weighs_nothing():
    """``has`` decides, whatever the slice's lse: a slice K2 read as all of
    its slots masked (length 0) adds nothing, even with a large lse."""
    q, k, v = _case(2, 16, 4, 2, 32, seed=3)
    o, lse = decode_attention_plain(q, k, v, torch.tensor([16, 16], dtype=torch.int32),
                                    return_lse=True)
    junk = torch.full_like(o, 1e3)
    merged = merge_stacked(torch.stack([o, junk]), torch.stack([lse, lse + 100.0]),
                           torch.tensor([[True, True], [False, False]]))
    assert torch.equal(merged, o)
