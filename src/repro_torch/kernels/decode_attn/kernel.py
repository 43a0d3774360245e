"""ctypes wrapper of the CUDA decode attention kernel (``csrc/decode_attn.cu``).

``decode_attention_cuda.launches`` counts the calls that launched the
kernel; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, cache dtype) pairs the kernel takes: the cache may be bf16
# under f32 queries, as the reference keeps a bf16 cache for f32 params.
DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))
HEAD_DIMS = (32, 64, 128, 256)
GROUPS = (1, 2, 4, 8)
KEYS_PER_STEP = 16   # keys a block takes per loop step (4 warps x 4 keys)


@functools.cache
def _entry():
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, hkv: int, s: int, sm_count: int):
    """(splits, chunk): enough blocks for two per SM, chunks of at least 64
    keys, in whole loop steps."""
    want = math.ceil(2 * sm_count / max(batch * hkv, 1))
    splits = max(1, min(want, math.ceil(s / 64)))
    chunk = math.ceil(math.ceil(s / splits) / KEYS_PER_STEP) * KEYS_PER_STEP
    return math.ceil(s / chunk), chunk


def decode_attention_cuda(q, cache_k, cache_v, lengths, *, scale: float,
                          softcap: float = 0.0):
    """q: (B, 1, Hq, D); cache_k/v: (B, S, Hkv, D); lengths: (B,) valid
    slots per row. Returns (B, 1, Hq, D) in q's dtype."""
    if not all(t.is_cuda for t in (q, cache_k, cache_v, lengths)):
        raise ValueError("decode_attention_cuda takes CUDA tensors only")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)}")
    b, _, hq, d = q.shape
    s, hkv = cache_k.shape[1], cache_k.shape[2]
    if cache_v.shape != cache_k.shape or cache_k.shape[0] != b or cache_k.shape[3] != d:
        raise ValueError("q, cache_k and cache_v disagree in shape")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if d not in HEAD_DIMS or hq % hkv or hq // hkv not in GROUPS:
        raise ValueError(f"unsupported head_dim {d} or group {hq}/{hkv}")
    if cache_v.dtype != cache_k.dtype or (q.dtype, cache_k.dtype) not in DTYPE_PAIRS:
        raise ValueError(f"unsupported dtypes q {q.dtype} cache {cache_k.dtype}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("the KV cache must be contiguous")
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    for t in (q, cache_k, cache_v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention_cuda needs 16-byte aligned tensors")

    splits, chunk = split_plan(b, hkv, s, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part_acc = torch.empty(b * hq * splits * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * hq * splits * 2, dtype=torch.float32, device=q.device)
    lib, fn = _entry()
    code = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
              out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
              b, s, hq, hkv, d, splits, chunk, float(scale), float(softcap),
              DTYPE_CODES[q.dtype], DTYPE_CODES[cache_k.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attn", code)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
