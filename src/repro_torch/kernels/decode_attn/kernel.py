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
# The ring kernel's tensor-core consumer (decode_ring_mma_kernel): bf16 at
# D 256 with G 8 and 16 (paligemma's and recurrentgemma's query heads on
# one KV head). The consumer warps split a stage's keys into MMA_KEY_GROUPS
# groups of MMA_GROUP_KEYS and the output's columns into halves; each TMA
# box is MMA_BOX_COLS columns (128 bytes), swizzled by 128 bytes.
MMA_GROUPS, MMA_DIMS = (8, 16), (256,)
MMA_KEY_GROUPS, MMA_GROUP_KEYS, MMA_BOX_COLS = 4, 8, 64
# The tensor-core consumer's splits of a (row, kv head) are one thread-block
# cluster and merge in its distributed shared memory, with no merge through
# global memory: at most MMA_MAX_SPLITS of them (the largest cluster the
# H100 runs), each of at least MMA_MIN_TILES stages of 32 keys. At
# recurrentgemma's and paligemma's steps on an H100, in turns over CUDA
# graphs: 16 splits 0.0135 / 0.0096 ms, 8 0.0158 / 0.0103, 4 0.0220 /
# 0.0136; 8 splits whose partials the last block merged through global
# memory 0.0236 / 0.0149 (PERF.md).
MMA_MIN_TILES, MMA_MAX_SPLITS = 2, 16


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


def uses_mma(d: int, g: int) -> bool:
    """Whether the ring kernel's tensor-core consumer serves head dim ``d``
    with ``g`` query rows a KV head (bf16 q and cache)."""
    return d in MMA_DIMS and g in MMA_GROUPS


def mma_split_plan(batch: int, hkv: int, s: int, sm_count: int) -> int:
    """Splits of each (batch row, kv head)'s keys for the tensor-core
    consumer, one cluster: no more than one block an SM in one wave, no
    more than MMA_MAX_SPLITS, and no split of fewer than MMA_MIN_TILES
    stages of 32 keys."""
    pairs = max(batch * hkv, 1)
    tiles = math.ceil(s / (RING_STAGE_BYTES // (2 * 2 * MMA_DIMS[0])))
    return max(1, min(sm_count // pairs, MMA_MAX_SPLITS, tiles // MMA_MIN_TILES))


def uses_ring(q_dtype, kv_dtype, d: int) -> bool:
    """Whether a call goes to the ring kernel (bf16 q and cache at D 64, 128
    and 256) rather than the split + combine kernels."""
    return q_dtype == kv_dtype == torch.bfloat16 and d in RING_DIMS


def plan_for(b: int, hkv: int, s: int, d: int, q_dtype, kv_dtype, sm_count: int,
             g: int = 1) -> int:
    """The splits a call with ``g`` query rows a KV head takes: one block
    an SM for the ring kernel (``mma_split_plan`` for its tensor-core
    consumer), SPLIT_BLOCKS_PER_SM for the split kernel."""
    ring = uses_ring(q_dtype, kv_dtype, d)
    if ring and uses_mma(d, g):
        return mma_split_plan(b, hkv, s, sm_count)
    return split_plan(b, hkv, s, sm_count, 1 if ring else SPLIT_BLOCKS_PER_SM)


def split_range(length: int, s: int, splits: int, split: int, tile: int = 1):
    """(start, end) of the keys that split ``split`` streams, as the kernels
    compute it: an equal share of the row's valid slots, or of all ``s``
    when ``length`` <= 0 (every score masked, the softmax uniform); with
    ``tile`` > 1 (the tensor-core consumer's ``split_range_tiles``) an equal
    share of the row's tiles of ``tile`` slots, the last one partial."""
    n = s if length <= 0 else min(length, s)
    if tile > 1:
        tiles = -(-n // tile)
        return min(n, split * tiles // splits * tile), min(n, (split + 1) * tiles // splits * tile)
    return split * n // splits, (split + 1) * n // splits


@dataclasses.dataclass(frozen=True)
class RingShape:
    """The ring kernel's shape at head dim ``d`` and ``g`` query rows a KV
    head, as decode_attn.cu's ``RingShape`` gives it, or
    at the tensor-core consumer's shapes (``mma``) its key groups."""
    d: int
    g: int
    row_bytes: int      # one K or V row
    tile_keys: int      # keys a stage holds: 8192 / d
    lane_groups: int    # PV: keys a warp takes at once, d / 8 lanes each
    rows: int           # query rows a consumer warp holds: all G
    warp_keys: int      # keys of a stage a consumer warp walks
    box: tuple          # a TMA box over (D, Hkv, S, B), innermost first
    smem_bytes: int     # the ring, then q as f32, the mbarriers and a flag (mma: the barriers)
    mma: bool = False   # decode_ring_mma_kernel: tensor cores, swizzled boxes
    boxes: int = 1      # boxes a K (or V) row takes: D / 64 when mma


def ring_shape(d: int, g: int) -> RingShape:
    if d not in RING_DIMS or g not in GROUPS + (ODD_GROUPS if d in ODD_GROUP_DIMS else ()) + (
            RING_GROUPS if d in RING_GROUP_DIMS else ()):
        raise ValueError(f"the ring kernel takes no head_dim {d} with group {g}")
    row = 2 * d
    tile = RING_STAGE_BYTES // (2 * row)
    if uses_mma(d, g):
        return RingShape(d=d, g=g, row_bytes=row, tile_keys=tile, lane_groups=1, rows=g,
                         warp_keys=MMA_GROUP_KEYS,
                         box=(MMA_BOX_COLS, 1, tile, 1),
                         smem_bytes=RING_STAGES * RING_STAGE_BYTES + 16 * RING_STAGES,
                         mma=True, boxes=d // MMA_BOX_COLS)
    return RingShape(d=d, g=g, row_bytes=row, tile_keys=tile, lane_groups=256 // d, rows=g,
                     warp_keys=tile // RING_CONSUMERS,
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
    scored nor accumulated.

    At the tensor-core consumer's shapes (``shape.mma``) every tile, the
    row's partial last one too, is ``shape.boxes`` swizzled boxes of K and
    of V (``copy`` "tma"), the splits are whole tiles (``split_range`` with
    ``tile``), and a tile's ``passes`` are its key groups' warps: warp w
    scores the keys ``base`` = 8 (w % 4) .. + 8 below ``n`` for all ``rows``
    (an M = 16 tile, G of them real) and accumulates them into the columns
    ``cols`` (its half of D, w // 4); ``pv`` lists (warp, key, first
    column) of each 8-column block of V it reads."""
    shape = ring_shape(d, g)
    if shape.mma:
        return shape, _mma_plan(shape, length, s, splits)
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
                key0 = shape.warp_keys * warp
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
                        "rows": range(shape.rows),
                        "scores": [(j, base + j) for j in range(RING_PASS_KEYS) if base + j < n],
                        "pv": pv})
            tiles.append({"stage": i % RING_STAGES, "t0": t0, "n": n,
                          "copy": "tma" if whole else "rows",
                          "row_copies": {} if whole else {
                              lane: list(range(lane, n, 32)) for lane in range(min(n, 32))},
                          "passes": passes})
        plan.append({"split": split, "start": start, "end": end, "tiles": tiles})
    return shape, plan


def _mma_plan(shape, length: int, s: int, splits: int):
    """``ring_plan`` at the tensor-core consumer's shapes."""
    t = shape.tile_keys
    half = shape.d // (RING_CONSUMERS // MMA_KEY_GROUPS)
    plan = []
    for split in range(splits):
        start, end = split_range(length, s, splits, split, tile=t)
        tiles = []
        for i, t0 in enumerate(range(start, end, t)):
            n = min(t, end - t0)
            passes = []
            for warp in range(RING_CONSUMERS):
                base = MMA_GROUP_KEYS * (warp % MMA_KEY_GROUPS)
                if base >= n:
                    continue
                keys = [base + j for j in range(MMA_GROUP_KEYS) if base + j < n]
                cols = range(half * (warp // MMA_KEY_GROUPS), half * (warp // MMA_KEY_GROUPS + 1))
                passes.append({"warp": warp, "pass": 0, "base": base, "rows": range(shape.g),
                               "scores": list(enumerate(keys)), "cols": cols,
                               "pv": [(warp, key, c0) for key in keys for c0 in cols[::8]]})
            tiles.append({"stage": i % RING_STAGES, "t0": t0, "n": n, "copy": "tma",
                          "row_copies": {}, "passes": passes})
        plan.append({"split": split, "start": start, "end": end, "tiles": tiles})
    return plan


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

    splits = plan_for(b, hkv, s, d, q.dtype, cache_k.dtype, _sm_count(q.device.index or 0),
                      g=hq // hkv)
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
