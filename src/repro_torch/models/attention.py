"""GQA attention: projections, prefill attention, KV caches, decode.

Counterparts of the reference's ``models/attention.py``: qk-norm, q/k/v/o
biases, cross-attention (K/V from another sequence, no RoPE) and the
causal, local, full and prefix-LM masks. ``attention_core`` computes what
the reference's flash-attention kernel computes and goes through
``kernels/flash_attn``; ``decode_attend``
computes what its decode kernel computes and goes through
``kernels/decode_attn``. On CUDA tensors both launch the port's kernels, on
CPU tensors their plain torch versions.

``attention_chunked`` is the training path's attention: the reference's
jnp ``attention_core``, an online softmax over KV chunks that autograd
differentiates. The kernels have no backward, as the reference's have none.

The projections are 2-D products against the weights reshaped to
(d, H·Dh) and (H·Dh, d), so each lowers to one ``aten::mm``: remat's
"dots" policy tells them from attention's batched products by that.

The cache writers update the cache tensors in place (the reference returns
new arrays) and return them, so a step allocates no second cache.

On a mesh (DTensor activations and caches, ``parallel.sharding``): prefill
attends each rank's batch rows and heads under ``local_map`` (K3 a rank).
The caches are placed by ``model.cache_specs`` under the decode rules, the
slots over ``model``: each rank writes only the slots it holds, and a
decode step runs K2 on each rank's slots at its local lengths, then
``merge_shards`` combines the ranks' outputs by their log-sum-exp with
three all-reduces over the mesh dimensions that split the slots: the
max, and the sums of the weighted outputs and of the weights. These are
the all-reduces GSPMD gives the reference's ``decode_attend`` over a
sharded ``act_kv_seq``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.decode_attn.ops import decode_attention_op
from repro_torch.kernels.flash_attn.ops import flash_attention_op
from repro_torch.models.layers import rms_headnorm, rope, softcap
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import constrain


NEG_INF = -1e30


def _scale(cfg) -> float:
    return cfg.query_scale or 1.0 / math.sqrt(cfg.head_dim)


class _GradPlacedLike(torch.autograd.Function):
    """The identity on a DTensor, whose gradient comes back in the input's
    placements; a sum still pending over a mesh dimension stays pending
    (the FSDP gather's backward reduce-scatters it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, [q if q.is_partial() else p
                                         for q, p in zip(g.placements, ctx.placements)])


def _flat_weight(w, shape, heads_dim: int):
    """``w.reshape(shape)``. On a mesh where a dimension of size n does not
    divide w's heads, DTensor may split the product's gradient over the
    flattened heads n ways, which the reshape's backward cannot unflatten;
    the gradient then comes back in the weight's placements first."""
    flat = w.reshape(shape)
    if isinstance(w, DTensor) and any(
            p == Replicate() and w.shape[heads_dim] % n
            for p, n in zip(w.placements, w.device_mesh.shape)):
        return _GradPlacedLike.apply(flat)
    return flat


def _rows_times(x, w, shape, heads_dim: int, env=None):
    """x (..., k) times w reshaped to ``shape`` (k, n) as one 2-D product
    over x's rows, whatever x's strides: ``matmul`` may otherwise take a
    batched product against w expanded over the rows (on a mesh, a copy of
    w a row). On a mesh the product gathers w over its FSDP split or brings
    x's rows to it (``sharding.product``)."""
    y = SH.product(x.reshape(-1, x.shape[-1]), w, env,
                   view=lambda t: _flat_weight(t, shape, heads_dim))
    return y.unflatten(0, x.shape[:-1])


def _heads(x, w, env=None):
    """x (B, S, d) times w (d, H, Dh) -> (B, S, H, Dh), as one 2-D product.
    On a mesh, DTensor may split the product's H·Dh columns over more ranks
    than divide H (2 kv heads over a ``model`` of 4); those columns are
    gathered before they are split into heads."""
    y = _rows_times(x, w, (w.shape[0], -1), 1, env)
    if isinstance(y, DTensor):
        col = Shard(y.dim() - 1)
        ways = math.prod(n for p, n in zip(y.placements, y.device_mesh.shape) if p == col)
        if w.shape[1] % ways:
            y = y.redistribute(y.device_mesh, [Replicate() if p == col else p
                                               for p in y.placements])
    return y.unflatten(-1, w.shape[1:])


def _split_apart(params) -> bool:
    """Whether a mesh dimension splits wq's heads and not wk's (or the
    reverse)."""
    wq, wk = params["wq"], params["wk"]
    return isinstance(wq, DTensor) and any(
        (p == Shard(1)) != (q == Shard(1)) and n > 1
        for p, q, n in zip(wq.placements, wk.placements, wq.device_mesh.shape))


def project_qkv(cfg, params, x, kv_x=None, *, positions=None, kv_positions=None,
                use_rope: bool = True, env=None):
    """x (B, S, d) -> q (B, S, Hq, Dh); k, v (B, Skv, Hkv, Dh) from ``kv_x``
    (x itself unless given: cross-attention projects another sequence).
    The biases (when the config has them), qk-norm on q and k, then RoPE at
    absolute positions (k at ``kv_positions`` when given), so cached K never
    needs re-rotation; cross-attention passes ``use_rope=False``."""
    if kv_x is None and _split_apart(params):
        # x's gradient sums a product's partial over ``model`` and another's
        # whole there: reduced here, where DTensor's choice moved with the
        # torch version (recurrentgemma's split wq beside MQA's whole wk, wv)
        x = constrain(env, x, "act_batch", "act_seq", "act_embed", grad=True)
    kv_x = x if kv_x is None else kv_x
    q, k, v = (_heads(t, params[w], env) for t, w in ((x, "wq"), (kv_x, "wk"), (kv_x, "wv")))
    if cfg.attn_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.use_qk_norm:
        q = rms_headnorm(params["q_norm"], q, cfg.norm_eps)
        k = rms_headnorm(params["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions, cfg.rope_theta)
    q = constrain(env, q, "act_batch", "act_seq", "act_heads", None)
    k = constrain(env, k, "act_batch", "act_kv_seq", "act_kv_heads", None)
    v = constrain(env, v, "act_batch", "act_kv_seq", "act_kv_heads", None)
    return q, k, v


def cross_query(cfg, params, x_t, env=None):
    """A decode step's cross-attention query: ``wq`` and the bias only (no
    qk-norm, no RoPE), as the reference's decode step projects it."""
    q = _heads(x_t, params["wq"], env)
    return q + params["bq"] if cfg.attn_bias else q


def output_proj(cfg, params, o, env=None):
    """o (B, S, Hq, Dh) times wo (Hq, Dh, d) -> (B, S, d), one 2-D product."""
    wo = params["wo"]
    out = _rows_times(o.flatten(-2), wo, (-1, wo.shape[-1]), 0, env)
    out = out + params["bo"] if cfg.attn_bias else out
    return constrain(env, out, "act_batch", "act_seq", "act_embed", grad=True)


def attention_core(cfg, q, k, v, *, mask_kind: str, prefix_len: int = 0):
    """Prefill attention, q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh).

    ``mask_kind``: "causal"; "local" (causal within ``cfg.local_window``);
    "full" (no mask: the encoder's self-attention, and cross-attention with
    Sq != Skv); "prefix" (causal, and keys before ``prefix_len`` visible to
    every query: paligemma's image prefix). On a mesh (DTensors) K3 runs on
    each rank's rows and heads (``_attend_shards``).
    """
    if mask_kind not in ("causal", "local", "full", "prefix"):
        raise ValueError(f"unknown mask_kind {mask_kind!r}")
    if isinstance(q, DTensor):
        return _attend_shards(functools.partial(attention_core, cfg, mask_kind=mask_kind,
                                                prefix_len=prefix_len), q, k, v)
    window = cfg.local_window if mask_kind == "local" else 0
    return flash_attention_op(q, k, v, causal=mask_kind != "full", window=window,
                              prefix_len=prefix_len if mask_kind == "prefix" else 0,
                              softcap=cfg.attn_logit_softcap, scale=_scale(cfg))


def _mask_block(mask_kind: str, qpos, kpos, window: int, prefix_len):
    """(Sq, C) validity of a KV chunk, positions absolute: every pair for
    "full"; else causal, within ``window`` for "local" (when it is set),
    and every key before ``prefix_len`` for "prefix"."""
    if mask_kind == "full":
        return torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool, device=qpos.device)
    q, k = qpos[:, None], kpos[None, :]
    valid = k <= q
    if mask_kind == "local" and window:
        valid &= (q - k) < window
    if mask_kind == "prefix" and prefix_len:
        valid |= k < prefix_len
    return valid


def pick_chunk(s: int, want: int) -> int:
    """The reference's KV chunk: ``want`` (1024 when 0), at most S, lowered
    until it divides S."""
    want = min(want if want > 0 else 1024, s)
    while s % want:
        want -= 1
    return max(want, 1)


def attention_chunked(cfg, q, k, v, *, mask_kind: str, q_offset: int = 0,
                      prefix_len=None, chunk: int = 0):
    """The training path's attention: the reference's ``attention_core``
    (``models/attention.py``), an online softmax over KV chunks in plain
    torch, differentiated by autograd. It is not a fallback for the
    prefill kernel: the reference's training step runs this jnp code, not
    a Pallas kernel, and the port's kernels have no backward, so the
    training forward calls this explicitly, on either device.

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); queries at absolute
    positions ``q_offset + i``. Masks as ``attention_core``'s (``prefix_len``
    for "prefix"). KV chunks of ``chunk`` keys (``pick_chunk``; 0: all of
    Skv up to 2048, else 1024). m, l and the accumulator are f32; the
    scores are q·k in f32 times the scale, softcapped, masked with -1e30;
    p is rounded to v's dtype before the PV product, as the reference's
    ``p.astype(vc.dtype)``. No (Sq, Skv) score tensor exists at once: a
    chunk's is (B, Hkv, G, Sq, C). Returns (B, Sq, Hq, Dh) in q's dtype.
    """
    if isinstance(q, DTensor):
        return _attend_shards(functools.partial(
            attention_chunked, cfg, mask_kind=mask_kind, q_offset=q_offset,
            prefix_len=prefix_len, chunk=chunk), q, k, v)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = pick_chunk(skv, chunk or (skv if skv <= 2048 else 1024))
    # (B, Hkv, G·Sq, Dh): the group's queries as rows of one product a kv head
    qf = q.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * sq, dh).float()
    kt = k.permute(0, 2, 3, 1)                                   # (B, Hkv, Dh, Skv)
    vt = v.transpose(1, 2)                                       # (B, Hkv, Skv, Dh)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g * sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, c):
        s = (qf @ kt[..., c0:c0 + c].float()).view(b, hkv, g, sq, c) * _scale(cfg)
        s = softcap(s, cfg.attn_logit_softcap)
        valid = _mask_block(mask_kind, qpos, torch.arange(c0, c0 + c, device=q.device),
                            cfg.local_window, prefix_len)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = p.to(v.dtype).float().view(b, hkv, g * sq, c) @ vt[:, :, c0:c0 + c].float()
        acc = acc * corr.view(b, hkv, g * sq, 1) + pv
        m = m_new
    out = acc / torch.clamp_min(l.view(b, hkv, g * sq, 1), 1e-30)
    out = out.view(b, hkv, g, sq, dh).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def _attend_shards(attend, q, k, v):
    """``attend`` (over plain tensors) on each rank's shards of the DTensors
    q, k, v under ``local_map``: the batch and the heads split as the
    constraints left them, so each rank attends its own rows and heads, as
    the reference's attention under GSPMD does. k and v take q's head
    split; with a single kv head (MQA) they stay whole on every rank, and
    their gradients sum over the ranks that split q's heads."""
    mesh = q.device_mesh
    for t in (q, k, v):
        if any(not isinstance(p, (Shard, Replicate)) or (isinstance(p, Shard) and p.dim not in (0, 2))
               for p in t.placements):
            raise NotImplementedError(f"attention over {t.placements}: the sequence split "
                                      "(sequence parallelism) is not ported")
    head_ways = 1
    for p, n in zip(q.placements, mesh.shape):
        head_ways *= n if p == Shard(2) else 1
    if k.shape[2] % head_ways and k.shape[2] > 1:
        q = q.redistribute(mesh, [Replicate() if p == Shard(2) else p for p in q.placements])
    mqa = k.shape[2] % head_ways > 0
    kv_pl = [Replicate() if mqa and p == Shard(2) else p for p in q.placements]
    kv_grad = [Partial() if mqa and p == Shard(2) else p for p in q.placements]
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    return local_map(attend, out_placements=list(q.placements),
                     in_placements=(q.placements, kv_pl, kv_pl),
                     in_grad_placements=(q.placements, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


# ---------------------------------------------------------------- on a mesh
def slot_shard(cache):
    """(first slot, slots, the mesh dimensions that split them, major to
    minor) of this rank's part of a cache DTensor (B, S, H, D). A cache
    whose S no mesh dimension of more than one rank splits (``ShardEnv._fit``
    left it whole, or the mesh has one rank) is all on every rank: (0, S,
    [])."""
    mesh = cache.device_mesh
    dims = [i for i, p in enumerate(cache.placements) if p == Shard(1) and mesh.size(i) > 1]
    coord, idx = mesh.get_coordinate(), 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    n = cache.to_local().shape[1]
    return idx * n, n, dims


def _row_placements(cache):
    return [Shard(0) if p == Shard(0) else Replicate() for p in cache.placements]


def rows_like(x, cache):
    """``x`` (a DTensor whose dim 0 is the batch) split over the batch as
    ``cache`` is, whole elsewhere: each rank's rows, every position and
    head."""
    return x.redistribute(cache.device_mesh, _row_placements(cache))


def _write_local(cache_k, cache_v, k, v, src_of):
    """Each rank writes its own slots: local slot j takes position
    ``src_of(global slot)`` of k/v (None: unchanged)."""
    off, n, _ = slot_shard(cache_k)
    dst, src = [], []
    for j in range(n):
        p = src_of(off + j)
        if p is not None:
            dst.append(j)
            src.append(p)
    dev = cache_k.device
    dst, src = torch.tensor(dst, device=dev), torch.tensor(src, device=dev)
    for cache, x in ((cache_k, k), (cache_v, v)):
        rows = rows_like(x, cache).to_local()   # a collective: every rank takes part
        if len(dst):
            local = cache.to_local()
            local[:, dst] = rows[:, src].to(local.dtype)
    return cache_k, cache_v


def write_full_cache(cache_k, cache_v, k, v):
    """Write a prefill's k/v into slots [0, S) of a full-length cache."""
    s = k.shape[1]
    if isinstance(cache_k, DTensor):
        return _write_local(cache_k, cache_v, k, v, lambda g: g if g < s else None)
    cache_k[:, :s] = k.to(cache_k.dtype)
    cache_v[:, :s] = v.to(cache_v.dtype)
    return cache_k, cache_v


def write_ring_cache(cache_k, cache_v, k, v):
    """Write the tail of a prefill's k/v into a ring buffer of size W; the
    slot of absolute position p is p % W."""
    w, s = cache_k.shape[1], k.shape[1]
    n = min(s, w)
    if isinstance(cache_k, DTensor):
        def src_of(g):      # the position in [s - n, s) whose slot is g
            p = s - n + (g - (s - n)) % w
            return p if p < s else None
        return _write_local(cache_k, cache_v, k, v, src_of)
    idx = torch.arange(s - n, s, device=k.device) % w
    cache_k[:, idx] = k[:, s - n:].to(cache_k.dtype)
    cache_v[:, idx] = v[:, s - n:].to(cache_v.dtype)
    return cache_k, cache_v


def decode_write(cache_k, cache_v, k_t, v_t, pos, ring: bool):
    """Insert one token per sequence. k_t: (B, 1, H, D); pos: (B,) absolute
    position of the new token (slot ``pos % W`` in a ring)."""
    w = cache_k.shape[1]
    slots = pos % w if ring else pos
    if isinstance(cache_k, DTensor):
        return _decode_write_local(cache_k, cache_v, k_t, v_t, slots)
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[rows, slots] = k_t[:, 0].to(cache_k.dtype)
    cache_v[rows, slots] = v_t[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def _decode_write_local(cache_k, cache_v, k_t, v_t, slots):
    """``decode_write`` on caches split over the slots: the rank holding a
    row's slot writes it; the others write back what they hold."""
    off, n, _ = slot_shard(cache_k)
    slot = rows_like(slots, cache_k).to_local() - off
    mine = (slot >= 0) & (slot < n)
    slot = slot.clamp(0, n - 1)
    for cache, x in ((cache_k, k_t), (cache_v, v_t)):
        local = cache.to_local()
        rows = torch.arange(local.shape[0], device=local.device)
        new = rows_like(x, cache).to_local()[:, 0].to(local.dtype)
        local[rows, slot] = torch.where(mine[:, None, None], new, local[rows, slot])
    return cache_k, cache_v


def decode_lengths(pos, slots: int, *, ring: bool):
    """Valid cache slots per sequence as a prefix length, for the decode
    kernel's mask ``slot < length``.

    * ring cache of W slots: the filled slots, min(pos+1, W). ``init_cache``
      sizes the ring to min(window, max_len), so it holds only positions
      inside the window, and attention does not depend on slot order;
    * full cache (a global layer, no window): slots 0..pos.
    """
    if ring:
        return torch.clamp(pos + 1, max=slots).to(torch.int32)
    return (pos + 1).to(torch.int32)


def merge_shards(out, lse, has, reduce_max, reduce_sum):
    """Combine K2's results over disjoint parts of one cache: ``out`` (B, 1,
    Hq, D) f32 and ``lse`` (B, Hq) of each part (``return_lse``), ``has``
    (B,) whether the part holds a valid slot of the row. ``reduce_max`` and
    ``reduce_sum`` reduce over the parts: all-reduces over the mesh
    dimensions that split the slots, or reductions over a stacked dimension
    (``chip_smoke.py`` phase 10b). A part with no valid slot gets weight 0
    by ``has``, whatever its ``lse`` (K2 reads a length of 0 as all of its
    slots, masked). Returns the merged (B, 1, Hq, D) in f32."""
    m = reduce_max(torch.where(has[..., None], lse, NEG_INF))
    w = torch.where(has[..., None], torch.exp(lse - m), 0.0)
    num = reduce_sum(w.unsqueeze(-2).unsqueeze(-1) * out)
    return num / reduce_sum(w).unsqueeze(-2).unsqueeze(-1)


def merge_stacked(out, lse, has):
    """``merge_shards`` over parts stacked on a leading dimension: out (P, B,
    1, Hq, D), lse (P, B, Hq), has (P, B)."""
    return merge_shards(out, lse, has, lambda x: x.amax(0, keepdim=True), lambda x: x.sum(0))


def _all_reduce(mesh, dims, op):
    """A reduction over the mesh dimensions ``dims``, one all-reduce each."""
    def reduce(x):
        for i in dims:
            x = funcol.all_reduce(x, op, (mesh, i))
        return x
    return reduce


def _decode_shards(attend, q_t, cache_k, cache_v, pos):
    """``attend(q, k, v, pos, offset, slots)`` (over plain tensors, with
    ``return_lse`` when the slots are split) on each rank's rows and slots
    under ``local_map``, merged over the ranks that split the slots."""
    mesh = cache_k.device_mesh
    off, n, dims = slot_shard(cache_k)
    row_pl = _row_placements(cache_k)

    def local(q, k, v, p):
        if not dims:
            return attend(q, k, v, p, off, n)
        o, lse, has = attend(q, k, v, p, off, n)
        merged = merge_shards(o, lse, has, _all_reduce(mesh, dims, "max"),
                              _all_reduce(mesh, dims, "sum"))
        return merged.to(q.dtype)

    pos_pl = None if pos is None else row_pl
    return local_map(local, out_placements=row_pl,
                     in_placements=(row_pl, cache_k.placements, cache_v.placements, pos_pl),
                     device_mesh=mesh)(rows_like(q_t, cache_k), cache_k, cache_v,
                                       None if pos is None else rows_like(pos, cache_k))


def decode_attend(cfg, q_t, cache_k, cache_v, pos, *, ring: bool, cross: bool = False):
    """One-token attention against a cache. q_t: (B, 1, Hq, Dh); cache:
    (B, S, Hkv, Dh); pos: (B,) position of the new token, already written.
    ``cross``: the cache holds an encoder's K/V, every slot valid for every
    row (``pos`` is not read). The reference constrains its scores here
    (the KV sequence over ``model`` under ``DECODE_RULES``); K2 keeps them
    inside the kernel, and on a mesh each rank runs it on its own slots
    (``_decode_shards``), its valid slots the first ``clamp(len − offset,
    0, slots)`` of them."""
    s = cache_k.shape[1]
    kw = dict(softcap=cfg.attn_logit_softcap, scale=_scale(cfg))

    def attend(q, k, v, p, off=0, n=s):
        length = (torch.full((q.shape[0],), s, dtype=torch.int32, device=k.device) if cross
                  else decode_lengths(p, s, ring=ring))
        if n == s:
            return decode_attention_op(q, k, v, length, **kw)
        mine = torch.clamp(length - off, 0, n).to(torch.int32)
        o, lse = decode_attention_op(q, k, v, mine, return_lse=True, **kw)
        return o, lse, (mine > 0) | (length <= 0)

    if isinstance(cache_k, DTensor):
        return _decode_shards(attend, q_t, cache_k, cache_v, None if cross else pos)
    return attend(q_t, cache_k, cache_v, pos)
