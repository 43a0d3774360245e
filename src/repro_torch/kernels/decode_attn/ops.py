"""GQA decode attention against a (B, S, Hkv, D) cache.

``decode_attention`` launches the CUDA kernel when any argument is a CUDA
tensor (the kernel raises unless all are) and takes the plain torch version
only when all are CPU tensors; it never falls back from one to the other.
The kernel has no backward: on CUDA, an input that requires grad under
grad mode raises (``forward_only``).
"""
from __future__ import annotations

import math

from repro_torch.kernels import forward_only
from repro_torch.kernels.decode_attn import kernel
from repro_torch.kernels.decode_attn.ref import decode_ref


def decode_attention(q, cache_k, cache_v, lengths, *, softcap: float = 0.0,
                     scale: float = 0.0):
    """q: (B, 1, Hq, D); cache_k/v: (B, S, Hkv, D); lengths: (B,) number of
    valid cache positions per sequence. Returns (B, 1, Hq, D)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    devices = {t.device.type for t in (q, cache_k, cache_v, lengths)}
    if "cuda" in devices:
        forward_only("decode_attention", q, cache_k, cache_v)
        return kernel.decode_attention_cuda(q, cache_k, cache_v, lengths,
                                            scale=scale, softcap=softcap)
    if devices != {"cpu"}:
        raise ValueError(f"decode_attention runs on cuda or cpu, not {devices}")
    return decode_attention_plain(q, cache_k, cache_v, lengths,
                                  softcap=softcap, scale=scale)


def decode_attention_plain(q, cache_k, cache_v, lengths, *, softcap: float = 0.0,
                           scale: float = 0.0):
    """The plain torch version on any device: KV heads repeated to the query
    heads, heads folded into the batch, then ``decode_ref``."""
    b, _, hq, d = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv

    def fold(c):
        return c.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, s, d)

    qf = q.transpose(1, 2).reshape(b * hq, 1, d)
    out = decode_ref(qf, fold(cache_k), fold(cache_v),
                     lengths.repeat_interleave(hq), scale=scale, softcap=softcap)
    return out.reshape(b, hq, 1, d).transpose(1, 2)
