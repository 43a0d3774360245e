"""GQA decode attention against a (B, S, Hkv, D) cache.

``decode_attention`` launches the CUDA kernel when any argument is a CUDA
tensor (the kernel raises unless all are) and takes the plain torch version
only when all are CPU tensors; it never falls back from one to the other.
The kernel has no backward: on CUDA, an input that requires grad under
grad mode raises (``forward_only``). With ``return_lse`` it also returns
each query row's log-sum-exp, which a sharded decode merges its sequence
shards by (``models.attention.merge_shards``).

``decode_attention_op`` is the same function as the custom op
``repro_torch::decode_attention``, which the model calls: the kernel on
CUDA tensors, the plain version on CPU tensors, shapes only on meta tensors
(its fake implementation), and a FLOP count for ``torch.utils.flop_counter``
and ``launch.op_analysis``: the dense products of the reference's jnp
decode attention, 4·B·Hq·S·D, whatever the lengths.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import forward_only
from repro_torch.kernels.decode_attn import kernel
from repro_torch.kernels.decode_attn.ref import decode_ref


def decode_attention(q, cache_k, cache_v, lengths, *, softcap: float = 0.0,
                     scale: float = 0.0, return_lse: bool = False):
    """q: (B, 1, Hq, D); cache_k/v: (B, S, Hkv, D); lengths: (B,) number of
    valid cache positions per sequence. Returns (B, 1, Hq, D) in q's dtype;
    with ``return_lse``, the output in f32 (unrounded) and the (B, Hq) f32
    log-sum-exp."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    devices = {t.device.type for t in (q, cache_k, cache_v, lengths)}
    if "cuda" in devices:
        forward_only("decode_attention", q, cache_k, cache_v)
        # the call without the lse is the one it always was
        lse = {"return_lse": True} if return_lse else {}
        return kernel.decode_attention_cuda(q, cache_k, cache_v, lengths, scale=scale,
                                            softcap=softcap, **lse)
    if devices != {"cpu"}:
        raise ValueError(f"decode_attention runs on cuda or cpu, not {devices}")
    return decode_attention_plain(q, cache_k, cache_v, lengths, softcap=softcap, scale=scale,
                                  return_lse=return_lse)


def decode_attention_plain(q, cache_k, cache_v, lengths, *, softcap: float = 0.0,
                           scale: float = 0.0, return_lse: bool = False):
    """The plain torch version on any device: KV heads repeated to the query
    heads, heads folded into the batch, then ``decode_ref``."""
    b, _, hq, d = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    g = hq // hkv

    def fold(c):
        return c.repeat_interleave(g, dim=2).transpose(1, 2).reshape(b * hq, s, d)

    qf = q.transpose(1, 2).reshape(b * hq, 1, d)
    out = decode_ref(qf, fold(cache_k), fold(cache_v), lengths.repeat_interleave(hq),
                     scale=scale, softcap=softcap, return_lse=return_lse)
    if return_lse:
        out, lse = out
        return out.reshape(b, hq, 1, d).transpose(1, 2), lse.reshape(b, hq)
    return out.reshape(b, hq, 1, d).transpose(1, 2)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _op(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, lengths: torch.Tensor,
        softcap: float, scale: float, return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    out = decode_attention(q, cache_k, cache_v, lengths, softcap=softcap, scale=scale,
                           return_lse=return_lse)
    # an op's outputs are fixed: without the lse, an empty tensor stands for it
    return out if return_lse else (out, q.new_empty(0, dtype=torch.float32))


@_op.register_fake
def _fake(q, cache_k, cache_v, lengths, softcap, scale, return_lse):
    lse = (q.new_empty((q.shape[0], q.shape[2]), dtype=torch.float32) if return_lse
           else q.new_empty(0, dtype=torch.float32))
    return torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype), lse


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV over every slot, as the reference's einsums compute them."""
    b, _, hq, d = q_shape
    return 4 * b * hq * k_shape[1] * d


def decode_attention_op(q, cache_k, cache_v, lengths, *, softcap: float = 0.0,
                        scale: float = 0.0, return_lse: bool = False):
    """``decode_attention`` through the custom op (``forward_only`` first,
    since the op's own backward would raise only in the backward pass)."""
    if q.device.type == "cuda":
        forward_only("decode_attention", q, cache_k, cache_v)
    out, lse = _op(q, cache_k, cache_v, lengths, float(softcap),
                   float(scale or 1.0 / math.sqrt(q.shape[-1])), bool(return_lse))
    return (out, lse) if return_lse else out
