"""(B, S, H, D) GQA flash attention.

``flash_attention`` launches the CUDA kernel when any argument is a CUDA
tensor (the kernel raises unless all are) and takes the plain torch version
only when all are CPU tensors; it never falls back from one to the other.
The kernel has no backward: on CUDA, an input that requires grad under
grad mode raises (``forward_only``).
"""
from __future__ import annotations

import math

from repro_torch.kernels import forward_only
from repro_torch.kernels.flash_attn import kernel
from repro_torch.kernels.flash_attn.ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0. The window
    applies only when causal. Returns (B, Sq, Hq, D)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    devices = {t.device.type for t in (q, k, v)}
    if "cuda" in devices:
        forward_only("flash_attention", q, k, v)
        return kernel.flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                           window=window, softcap=softcap)
    if devices != {"cpu"}:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {devices}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float = 0.0):
    """The plain torch version on any device: KV heads repeated to the query
    heads, heads folded into the batch, then ``attention_ref``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv

    def fold(t, s):
        return t.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, s, d)

    qf = q.transpose(1, 2).reshape(b * hq, sq, d)
    out = attention_ref(qf, fold(k, skv), fold(v, skv), scale=scale,
                        causal=causal, window=window, softcap=softcap)
    return out.reshape(b, hq, sq, d).transpose(1, 2)
