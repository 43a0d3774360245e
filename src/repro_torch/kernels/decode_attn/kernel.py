"""ctypes wrapper of the CUDA decode attention kernels (``csrc/decode_attn.cu``).

``decode_attention_cuda.launches`` counts the calls that launched a kernel;
nothing else changes it. With ``return_lse`` a call also returns each query
row's log-sum-exp through ``decode_attn_launch_lse``; without it, it calls
``decode_attn_launch`` as before.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
# Head dims of the ring kernel (decode_ring_kernel), which takes bf16 q and
# cache there; f32 queries, and bf16 at D 32 (the reduced models), take the
# split + combine kernels.
RING_DIMS = (64, 128, 256)
# Query heads a KV head (G = Hq/Hkv) the kernels are built for: both
# kernels take GROUPS at every head dim and ODD_GROUPS at ODD_GROUP_DIMS
# (granite-moe's G 3 at D 64, nemotron's 6 and arctic's 7 at D 128); the
# ring kernel also takes RING_GROUPS at D 256 (recurrentgemma's 16 query
# heads on one KV head). decode_attn.cu's switches hold the same table.
GROUPS = (1, 2, 4, 8)
ODD_GROUPS, ODD_GROUP_DIMS = (3, 6, 7), (64, 128)
RING_GROUPS, RING_GROUP_DIMS = (16,), (256,)
# No more splits than 64-slot pieces of the cache, for either kernel: at
# the zoo's 1,032-slot caches that gives the ring kernel 8 splits (of 129
# keys, two stages at D 128) where the (row, kv head) pairs leave it room.
MIN_KEYS_PER_SPLIT = 64
# Blocks an SM that the split kernel's plan aims at. Its warps load a few
# keys into registers a step with nothing in flight between steps, so one
# block an SM leaves the memory system idle; several resident blocks (each
# holds few registers and under 8 KB of shared memory at D <= 128) keep
# more loads in flight. The ring kernel pipelines its own loads (128 KB a
# block) and keeps one block an SM.
SPLIT_BLOCKS_PER_SM = 8
# The ring kernel's pipeline (decode_attn.cu): stages of a fixed byte size
# (K rows, then V rows), consumer warps beside one producer warp, keys a
# warp scores at once (8 lanes each), and a block's shared memory limit on
# the H100 (227 KB).
RING_STAGE_BYTES, RING_STAGES, RING_CONSUMERS, RING_PASS_KEYS = 32 * 1024, 4, 8, 4
SMEM_PER_BLOCK = 232448


@functools.cache
def _entry():
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _entry_lse():
    """The launch that also writes the log-sum-exp: ``decode_attn_launch``'s
    arguments with the lse buffer after the output."""
    lib = _build.load("decode_attn")
    fn = lib.decode_attn_launch_lse
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_supported(hq: int, hkv: int, d: int, q_dtype, kv_dtype) -> None:
    """Raise ``ValueError`` for a head shape or dtype pair the CUDA side
    refuses (it returns cudaErrorInvalidValue for the same)."""
    if (q_dtype, kv_dtype) not in DTYPE_PAIRS:
        raise ValueError(f"unsupported dtypes q {q_dtype} cache {kv_dtype}")
    groups = GROUPS + (ODD_GROUPS if d in ODD_GROUP_DIMS else ()) + (
        RING_GROUPS if d in RING_GROUP_DIMS and uses_ring(q_dtype, kv_dtype, d) else ())
    if d not in HEAD_DIMS or hkv <= 0 or hq % hkv or hq // hkv not in groups:
        raise ValueError(f"unsupported head_dim {d} or group {hq}/{hkv}")


def split_plan(batch: int, hkv: int, s: int, sm_count: int, blocks_per_sm: int = 1) -> int:
    """Splits of each (batch row, kv head)'s keys: ``blocks_per_sm`` blocks
    an SM, and the grid in one wave (batch * hkv * splits <= blocks_per_sm
    * sm_count) wherever the pairs alone do not exceed it, but no more
    splits than the cache has pieces of MIN_KEYS_PER_SPLIT slots."""
    pairs = max(batch * hkv, 1)
    return max(1, min(blocks_per_sm * sm_count // pairs, math.ceil(s / MIN_KEYS_PER_SPLIT)))


def uses_ring(q_dtype, kv_dtype, d: int) -> bool:
    """Whether a call goes to the ring kernel (bf16 q and cache at D 64, 128
    and 256) rather than the split + combine kernels."""
    return q_dtype == kv_dtype == torch.bfloat16 and d in RING_DIMS


def plan_for(b: int, hkv: int, s: int, d: int, q_dtype, kv_dtype, sm_count: int) -> int:
    """The splits a call takes: one block an SM for the ring kernel,
    SPLIT_BLOCKS_PER_SM for the split kernel."""
    per_sm = 1 if uses_ring(q_dtype, kv_dtype, d) else SPLIT_BLOCKS_PER_SM
    return split_plan(b, hkv, s, sm_count, per_sm)


def split_range(length: int, s: int, splits: int, split: int):
    """(start, end) of the keys that split ``split`` streams, as the kernels
    compute it: an equal share of the row's valid slots, or of all ``s``
    when ``length`` <= 0 (every score masked, the softmax uniform)."""
    n = s if length <= 0 else min(length, s)
    return split * n // splits, (split + 1) * n // splits


@dataclasses.dataclass(frozen=True)
class RingShape:
    """The ring kernel's shape at head dim ``d`` and ``g`` query rows a KV
    head, as decode_attn.cu's ``RingShape`` and ``kRingRows`` give it."""
    d: int
    g: int
    row_bytes: int      # one K or V row
    tile_keys: int      # keys a stage holds: 8192 / d
    lane_groups: int    # PV: keys a warp takes at once, d / 8 lanes each
    rows: int           # query rows a consumer warp holds (R)
    row_groups: int     # warps that share a key, one a group of R rows (H)
    warp_keys: int      # keys of a stage a consumer warp walks
    box: tuple          # the TMA box over (D, Hkv, S, B), innermost first
    smem_bytes: int     # the ring, q as f32, the mbarriers and a flag


def ring_shape(d: int, g: int) -> RingShape:
    if d not in RING_DIMS or g not in GROUPS + (ODD_GROUPS if d in ODD_GROUP_DIMS else ()) + (
            RING_GROUPS if d in RING_GROUP_DIMS else ()):
        raise ValueError(f"the ring kernel takes no head_dim {d} with group {g}")
    row = 2 * d
    tile = RING_STAGE_BYTES // (2 * row)
    rows = min(g, 8)
    return RingShape(d=d, g=g, row_bytes=row, tile_keys=tile, lane_groups=256 // d, rows=rows,
                     row_groups=g // rows, warp_keys=tile * (g // rows) // RING_CONSUMERS,
                     box=(d, 1, tile, 1),
                     smem_bytes=RING_STAGES * RING_STAGE_BYTES + g * d * 4 + 16 * RING_STAGES + 16)


def ring_plan(d: int, g: int, length: int, s: int, splits: int):
    """The ring kernel's schedule for one (batch row, kv head), as
    ``decode_ring_kernel`` runs it: ``(shape, plan)``, where ``plan`` holds
    for each split its keys ``[start, end)`` and its tiles in order. A tile
    (keys ``t0 .. t0 + n`` of the cache, in ring stage ``i % RING_STAGES``)
    is one TMA box of K and one of V when it is whole, else row copies,
    ``row_copies[lane]`` the rows a producer lane copies. Its ``passes`` are
    what each consumer warp does with it, in order: a pass of the warp's
    query rows ``rows`` over the 4 keys from ``base`` (keys of the tile),
    ``scores`` the (lane group, key) pairs scored, 8 lanes 8j .. 8j + 7 for
    lane group j, and ``pv`` the (lane, key, first column) of each V chunk
    of 8 columns a lane accumulates. Keys at or past ``n`` are neither
    scored nor accumulated."""
    shape = ring_shape(d, g)
    per_row = d // 8                  # lanes a V row spans
    plan = []
    for split in range(splits):
        start, end = split_range(length, s, splits, split)
        tiles = []
        for i, t0 in enumerate(range(start, end, shape.tile_keys)):
            n = min(shape.tile_keys, end - t0)
            whole = n == shape.tile_keys
            passes = []
            for warp in range(RING_CONSUMERS):
                half = warp % shape.row_groups
                key0 = shape.warp_keys * (warp // shape.row_groups)
                for u in range(shape.warp_keys // RING_PASS_KEYS):
                    base = key0 + RING_PASS_KEYS * u
                    if base >= n:
                        break
                    pv = [(lane, base + lane // per_row + shape.lane_groups * w,
                           8 * (lane % per_row))
                          for w in range(RING_PASS_KEYS // shape.lane_groups)
                          for lane in range(32)
                          if base + lane // per_row + shape.lane_groups * w < n]
                    passes.append({
                        "warp": warp, "pass": u, "base": base,
                        "rows": range(half * shape.rows, (half + 1) * shape.rows),
                        "scores": [(j, base + j) for j in range(RING_PASS_KEYS) if base + j < n],
                        "pv": pv})
            tiles.append({"stage": i % RING_STAGES, "t0": t0, "n": n,
                          "copy": "tma" if whole else "rows",
                          "row_copies": {} if whole else {
                              lane: list(range(lane, n, 32)) for lane in range(min(n, 32))},
                          "passes": passes})
        plan.append({"split": split, "start": start, "end": end, "tiles": tiles})
    return shape, plan


_SCRATCH = {}


def _scratch(device: torch.device, stream: int, n_tickets: int, n_partials: int):
    """(tickets, partials) for launches on ``stream`` (a CUDA stream handle)
    of ``device``: at least ``n_tickets`` int32 counters, zero between
    launches (the ring kernel's last block of each (row, kv head) resets
    its own), and at least ``n_partials`` f32 for the splits' partials.
    Launches on one stream never overlap and each stream has its own set,
    so a call allocates nothing but its output."""
    key = (device.type, device.index, stream)
    tickets, partials = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32, device=device)
    if partials is None or partials.numel() < n_partials:
        partials = torch.empty(n_partials, dtype=torch.float32, device=device)
    _SCRATCH[key] = tickets, partials
    return tickets, partials


def decode_attention_cuda(q, cache_k, cache_v, lengths, *, scale: float,
                          softcap: float = 0.0, return_lse: bool = False):
    """q: (B, 1, Hq, D); cache_k/v: (B, S, Hkv, D); lengths: (B,) valid
    slots per row. Returns (B, 1, Hq, D) in q's dtype; with ``return_lse``,
    the output in f32 (the value q's dtype would round) and the (B, Hq) f32
    log-sum-exp of each row's scaled, softcapped, masked scores (-1e30 for
    a row of length <= 0)."""
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
    if cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache_k {cache_k.dtype} and cache_v {cache_v.dtype} differ")
    check_supported(hq, hkv, d, q.dtype, cache_k.dtype)
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("the KV cache must be contiguous")
    if s == 0:
        raise ValueError("the KV cache has no slots")
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    for t in (q, cache_k, cache_v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention_cuda needs 16-byte aligned tensors")

    splits = plan_for(b, hkv, s, d, q.dtype, cache_k.dtype, _sm_count(q.device.index or 0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    n_acc = b * hq * splits * d      # part_acc, then part_ml (b * hq * splits * 2)
    tickets, partials = _scratch(q.device, stream, b * hkv, n_acc + b * hq * splits * 2)
    part_acc = partials.data_ptr()
    ptrs = [q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            out.data_ptr()]
    lse = None
    if return_lse:
        lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        ptrs.append(lse.data_ptr())
    lib, fn = _entry_lse() if return_lse else _entry()
    code = fn(*ptrs, part_acc, part_acc + 4 * n_acc, tickets.data_ptr(),
              b, s, hq, hkv, d, splits, float(scale), float(softcap),
              DTYPE_CODES[q.dtype], DTYPE_CODES[cache_k.dtype], stream)
    _build.check(lib, "decode_attn", code)
    decode_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


decode_attention_cuda.launches = 0
