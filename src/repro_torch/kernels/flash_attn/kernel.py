"""ctypes wrapper of the CUDA flash attention kernel (``csrc/flash_attn.cu``).

``flash_attention_cuda.launches`` counts the calls that launched the
kernel; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import check_mask

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
WG_ROWS = 64      # query rows a consumer warpgroup


@dataclasses.dataclass(frozen=True)
class Plan:
    """The bf16 kernel's plan at one head dim (``Plan<D>`` in
    ``flash_attn.cu``): keys a tile, consumer warpgroups of WG_ROWS query
    rows, the row maximum on the raw scores with the scale folded into the
    exponent's FMA, and key splits over both warpgroups at Sq <= WG_ROWS
    (``split``; ``launch_plan`` gives the mode a shape takes)."""
    block_k: int
    warpgroups: int
    fold: bool
    split: bool = False

    @property
    def block_q(self) -> int:
        return WG_ROWS * self.warpgroups


# D 32 and 256 share the plan tuned at D 256; D 64 and 128 have their own.
_D256_PLAN = Plan(block_k=64, warpgroups=2, fold=False)
PLANS = {32: _D256_PLAN, 64: Plan(block_k=128, warpgroups=3, fold=True, split=True),
         128: Plan(block_k=128, warpgroups=2, fold=True), 256: _D256_PLAN}
STAGES = 2        # K and V ring stages (kStages)
SPLIT_STAGES = 4  # the ring's stages under key splits (kSplitStages)
# D 256's tiles: a block takes BLOCK_Q query rows, WG_ROWS to a consumer
# warpgroup, and walks its keys in tiles of BLOCK_K (``tile_plan``'s default)
BLOCK_Q, BLOCK_K = _D256_PLAN.block_q, _D256_PLAN.block_k


def block_warpgroups(head_dim: int, sq: int) -> int:
    """Consumer warpgroups of a block at ``head_dim`` for ``sq`` query rows:
    the plan's, but two where the plan has three and the sequence fits one
    block of two (``short_block`` in ``flash_attn.cu``)."""
    wgs = PLANS[head_dim].warpgroups
    return 2 if wgs == 3 and sq <= 2 * WG_ROWS else wgs


def tile_plan(sq: int, skv: int, causal: bool = True, window: int = 0, prefix_len: int = 0,
              head_dim: int = 256):
    """The bf16 kernel's schedule for one (batch, q head) at ``head_dim``'s
    plan (``PLANS``, ``block_warpgroups``), as ``flash_wgmma_kernel``
    computes it on the card: blocks in launch order (the last q-block
    first), and for each consumer warpgroup its first row and its KV tiles
    in the order it runs them (the last tile first), each as (first key,
    masked). A block reaches keys up to the end of its rows or of the
    prefix, whichever is later. A tile is unmasked only when every key in it
    is before ``skv``, at or below the diagonal of every row of the
    warpgroup or wholly inside the prefix, and inside its window.
    Returns ``[(q0, [(row0, [(k0, masked), ...]), ...]), ...]``."""
    block_q = WG_ROWS * block_warpgroups(head_dim, sq)
    block_k = PLANS[head_dim].block_k
    window = window if causal else 0
    prefix = prefix_len if causal else 0
    plan = []
    for q0 in reversed(range(0, sq, block_q)):
        lo, hi = 0, skv
        if causal:
            hi = min(skv, max(min(q0 + block_q, sq), prefix))
            if window > 0:
                lo = max(0, q0 - window + 1)
        lo -= lo % block_k
        starts = list(reversed(range(lo, hi, block_k)))
        wgs = []
        for row0 in range(q0, q0 + block_q, WG_ROWS):
            def masked(k0):
                return (k0 + block_k > skv or causal and (
                    k0 + block_k - 1 > row0 and k0 + block_k > prefix
                    or window > 0 and row0 + WG_ROWS - 1 - k0 >= window))
            wgs.append((row0, [(k0, masked(k0)) for k0 in starts]))
        plan.append((q0, wgs))
    return plan


def launch_plan(batch: int, heads: int, sq: int, skv: int, causal: bool = True, window: int = 0,
                prefix_len: int = 0, head_dim: int = 256):
    """The bf16 kernel's launch at a shape, as ``launch_wgmma_cap`` chooses
    it: (mode, consumer warpgroups, blocks), one block an item. Modes:
    "split" at Sq <= WG_ROWS under a plan with ``split`` (both warpgroups on
    alternate key tiles of the same rows); else "per block"."""
    if PLANS[head_dim].split and sq <= WG_ROWS:
        return "split", 2, batch * heads
    wgs = block_warpgroups(head_dim, sq)
    return "per block", wgs, batch * heads * -(-sq // (WG_ROWS * wgs))


def work_plan(batch: int, heads: int, sq: int, skv: int, causal: bool = True, window: int = 0,
              prefix_len: int = 0, head_dim: int = 256):
    """Each block's item in launch order (``flash_wgmma_kernel`` under
    ``launch_plan``'s mode), longest first: the last q-block of every
    (batch, head), then the one before, ... An item's tiles are
    ``tile_plan``'s for its q-block; under "split" the item is the 64 rows
    of one (batch, head), and warpgroup w takes every other of its tiles
    from the w-th.
    Returns ``[(bh, q0, [(row0, [(k0, masked), ...]), ...]), ...]`` a block,
    bh = batch * heads + head."""
    mode = launch_plan(batch, heads, sq, skv, causal, window, prefix_len, head_dim)[0]
    per_q = dict(tile_plan(sq, skv, causal, window, prefix_len, head_dim))
    q0s = [0] if mode == "split" else sorted(per_q, reverse=True)
    bh_n = batch * heads
    blocks = []
    for t in range(bh_n * len(q0s)):
        bh, q0 = t % bh_n, q0s[t // bh_n]
        wgs = per_q[q0]
        if mode == "split":
            tiles = wgs[0][1]                  # descending keys
            wgs = [(q0, tiles[w::2]) for w in range(2)]
        blocks.append((bh, q0, wgs))
    return blocks


@functools.cache
def _entry():
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = True,
                         window: int = 0, prefix_len: int = 0, softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), one dtype (f32 or bf16).
    ``window`` and ``prefix_len`` (0: none) apply only when causal, and not
    together. Returns (B, Sq, Hq, D)."""
    if not all(t.is_cuda for t in (q, k, v)):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError("q and k/v disagree in batch, head_dim or heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {d}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype} {k.dtype} {v.dtype}")
    check_mask(causal, window, prefix_len)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention_cuda needs 16-byte aligned tensors")

    out = torch.empty_like(q)
    lib, fn = _entry()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, sq, skv, hq, hkv, d, float(scale), float(softcap), int(causal),
              int(window) if causal else 0, int(prefix_len) if causal else 0,
              DTYPE_CODES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attn", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
