"""(B, S, H, D) GQA flash attention.

``flash_attention`` launches the CUDA kernel when any argument is a CUDA
tensor (the kernel raises unless all are) and takes the plain torch version
only when all are CPU tensors; it never falls back from one to the other.
The kernel has no backward: on CUDA, an input that requires grad under
grad mode raises (``forward_only``).

``flash_attention_op`` is the same function as the custom op
``repro_torch::flash_attention``, which the model calls: the kernel on CUDA
tensors, the plain version on CPU tensors, shapes only on meta tensors (its
fake implementation), and a FLOP count for ``torch.utils.flop_counter`` and
``launch.op_analysis``: the dense products of the reference's jnp
attention, 4·B·Hq·Sq·Skv·D, whatever the mask.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import forward_only
from repro_torch.kernels.flash_attn import kernel
from repro_torch.kernels.flash_attn.ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, scale: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); Hq % Hkv == 0. The window
    and the prefix (keys before ``prefix_len`` visible to every query, 0 for
    none) apply only when causal, and not together. Returns (B, Sq, Hq, D)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    devices = {t.device.type for t in (q, k, v)}
    if "cuda" in devices:
        forward_only("flash_attention", q, k, v)
        return kernel.flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                           window=window, prefix_len=prefix_len,
                                           softcap=softcap)
    if devices != {"cpu"}:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {devices}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len, softcap=softcap, scale=scale)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          prefix_len: int = 0, softcap: float = 0.0, scale: float = 0.0):
    """The plain torch version on any device: KV heads repeated to the query
    heads, heads folded into the batch, then ``attention_ref``."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv

    def fold(t, s):
        return t.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, s, d)

    qf = q.transpose(1, 2).reshape(b * hq, sq, d)
    out = attention_ref(qf, fold(k, skv), fold(v, skv), scale=scale, causal=causal,
                        window=window, prefix_len=prefix_len, softcap=softcap)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
        prefix_len: int, softcap: float, scale: float) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window, prefix_len=prefix_len,
                           softcap=softcap, scale=scale)


@_op.register_fake
def _fake(q, k, v, causal, window, prefix_len, softcap, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, as the reference's einsums
    compute them."""
    b, sq, hq, d = q_shape
    return 4 * b * hq * sq * k_shape[1] * d


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
                       softcap: float = 0.0, scale: float = 0.0):
    """``flash_attention`` through the custom op (``forward_only`` first,
    since the op's own backward would raise only in the backward pass)."""
    if q.device.type == "cuda":
        forward_only("flash_attention", q, k, v)
    return _op(q, k, v, bool(causal), int(window), int(prefix_len), float(softcap),
               float(scale or 1.0 / math.sqrt(q.shape[-1])))
