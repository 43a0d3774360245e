"""Primitive layers: init, softcap, RMSNorm, RoPE, MLP, embedding, the
causal depthwise conv of the SSD and RG-LRU blocks.

Counterparts of the reference's ``models/layers.py`` on torch tensors, with
the same layouts and the same places of f32 computation and rounding.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import constrain, product


# The largest f32 temporary nd_init makes: 2.5 GiB, just above gemma2-2b's
# 256000 x 2304 table (2.36 GB in f32), which is thus drawn whole.
DRAW_BYTES = 5 << 29


def nd_init(shape, fan_in: int, dtype, generator: torch.Generator, device):
    """Truncated normal over +-3 sigma, sigma = 1/sqrt(fan_in), drawn in f32.

    A tensor whose f32 copy would exceed DRAW_BYTES is drawn in slices along
    its first axis, so drawing a full-width expert stack or a 256000-row
    table never holds more than that much f32 beside the result."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.shape[0] if out.dim() else 1
    per_row = 4 * out.numel() // max(rows, 1)
    step = max(1, DRAW_BYTES // max(per_row, 1))
    for r0 in range(0, rows, step):
        part = out[r0:r0 + step] if out.dim() else out
        w = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
        part.copy_(w * std)
    return out


def softcap(x, cap: float):
    """gemma2-style tanh logit soft-capping."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm in f32 with the gemma ``1 + scale`` gain."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


@functools.lru_cache(maxsize=16)
def rope_freq(d: int, theta: float, device: torch.device):
    """The reference's f32 frequencies, computed by numpy as it does, and
    kept on the device so a step copies nothing from the host."""
    return torch.from_numpy(
        theta ** (-np.arange(0, d // 2, dtype=np.float32) * 2.0 / d)).to(device)


def rms_headnorm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (qwen3): RMSNorm over head_dim in f32 with the
    ``1 + scale`` gain, ``scale`` f32 of shape (head_dim,)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale)).to(dtype)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split layout. x: (..., S, H, D); positions
    (..., S) broadcast against x's sequence dims, taken as f32."""
    d = x.shape[-1]
    half = d // 2
    angles = positions.float()[..., None, None] * rope_freq(d, theta, x.device)
    sin, cos = torch.sin(angles), torch.cos(angles)   # angles: (..., S, 1, half)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


GATED = ("swiglu", "geglu")


def mlp_activate(activation: str, h, g=None):
    """The MLP's nonlinearity: gated (swiglu, geglu: of the gate ``g``, times
    ``h``) or not (tanh-approximate gelu, squared relu: of ``h``)."""
    if activation == "swiglu":
        return F.silu(g) * h
    if activation == "geglu":
        return F.gelu(g, approximate="tanh") * h
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")
    if activation == "squared_relu":
        return torch.relu(h).square()
    raise ValueError(activation)


def mlp_apply(params, x, activation: str, env=None):
    """Input projection (and the gate's, for the gated kinds), the
    activation, then the output projection; the hidden and the output
    constrained as the reference's (``env``: ``parallel.sharding``); each
    product gathers its weight over its FSDP split or brings its rows to
    it (``sharding.product``)."""
    h = product(x, params["w_in"], env)
    g = product(x, params["w_gate"], env) if activation in GATED else None
    h = constrain(env, h, "act_batch", "act_seq", "act_mlp")
    out = product(mlp_activate(activation, h, g), params["w_out"], env)
    return constrain(env, out, "act_batch", "act_seq", "act_embed", grad=True)


def embed_lookup(params, tokens, scale: bool, env=None):
    """Row gather, times sqrt(d) rounded to the activation dtype. On a mesh
    the table's d is gathered (``_sharded_rows``), or, where the step's
    tokens are fewer than the table's rows (``sharding.moves_rows``), the
    tokens come to the table (``_rows_at_table``)."""
    table = params["table"]
    if not isinstance(table, DTensor):
        x = table[tokens]
    elif SH.moves_rows(table, env, table.shape[0]):
        x = _rows_at_table(table, tokens)
    else:
        x = _sharded_rows(table, tokens)
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=x.dtype).item()
    return constrain(env, x, "act_batch", "act_seq", "act_embed")


def _sharded_rows(table, tokens):
    """``table[tokens]`` of a DTensor table (V, d) split over the vocab on
    one mesh dimension and over d (FSDP) on others: d gathered first (the
    reference's constraint on the table), then under ``local_map`` each
    rank gathers the rows of its vocab slice (zeros for tokens outside it)
    from its own tokens, and the rows sum over the vocab's mesh dimension.
    The table's gradient sums over the ranks that split the batch."""
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab) > 1:
        raise NotImplementedError("the vocab split over more than one mesh dimension")
    table = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    out = [Partial() if i in vocab else p for i, p in enumerate(tokens.placements)]
    grad = [Shard(0) if i in vocab else (Partial() if p.is_shard() else Replicate())
            for i, p in enumerate(tokens.placements)]

    def rows(tab, tok):
        v = tab.shape[0]
        v0 = mesh.get_local_rank(vocab[0]) * v if vocab else 0
        mine = (tok >= v0) & (tok < v0 + v)
        return torch.where(mine[..., None], tab[(tok - v0).clamp(0, v - 1)], 0)

    return local_map(rows, out_placements=out, in_placements=(table.placements, tokens.placements),
                     in_grad_placements=(grad, tokens.placements), device_mesh=mesh)(table, tokens)


def _rows_at_table(table, tokens):
    """``table[tokens]`` of a DTensor table (V, d) split over the vocab on
    one mesh dimension and over d (FSDP) on others, without gathering it
    (no gradient): the tokens come whole over each dimension that splits
    d (an all-gather), each rank looks up its vocab slice's rows (zeros
    for tokens outside it) in its d slice, the rows sum over the vocab's
    dimension (one row nonzero: exact), and each rank hands its d slice of
    the other ranks' rows back (an all-to-all)."""
    mesh = table.device_mesh
    tl, table_l = tokens.to_local(), table.to_local()
    out, back = [], []
    for i, (pt, pw) in enumerate(zip(tokens.placements, table.placements)):
        size = mesh.size(i)
        rows = pt == Shard(0) and size > 1
        if pw == Shard(1) and size > 1:                 # d split (FSDP)
            if rows:
                tl = funcol.all_gather_tensor(tl, 0, (mesh, i))
                back.append(i)
            out.append(Shard(0) if rows else Shard(tokens.dim()))
        else:
            out.append(Shard(0) if rows else Replicate())
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0) and mesh.size(i) > 1]
    v = table_l.shape[0]
    v0 = mesh.get_local_rank(vocab[0]) * v if vocab else 0
    mine = (tl >= v0) & (tl < v0 + v)
    x = torch.where(mine[..., None], table_l[(tl - v0).clamp(0, v - 1)], 0)
    for i in vocab:
        x = funcol.all_reduce(x, "sum", (mesh, i))
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    for i in reversed(back):
        x = SH.slices_to_rows(x, mesh.size(i), (mesh, i))
    x = funcol.wait_tensor(x)
    shape = (*tokens.shape, table.shape[1])
    x = x.reshape(-1, *lead[1:], x.shape[-1])
    return DTensor.from_local(x, mesh, out, shape=torch.Size(shape),
                              stride=SH.contiguous_stride(shape))


def unembed(params_embed, x, tie: bool = True, head=None, cap: float = 0.0, env=None):
    """Logits through the tied embedding table, or through the untied head
    ``head["w"]`` of shape (d, V), then the final softcap. On a mesh the
    product gathers the weight over its FSDP split or brings its rows to it
    (``sharding.product``)."""
    if tie:
        logits = product(x, params_embed["table"], env, view=lambda t: t.T)
    else:
        logits = product(x, head["w"], env)
    return constrain(env, softcap(logits, cap), "act_batch", "act_seq", "act_vocab")


def conv1d_apply(params, x):
    """Causal depthwise conv over (B, S, C) with ``params["w"]`` (width, C)
    and ``params["b"]`` (C,): output t sums inputs t-width+1..t, each times
    its tap, in f32 in the reference's order (the newest input first), plus
    the bias, cast back to x's dtype. On a mesh (a DTensor x, split by its
    rows and channels) it runs on each rank's shard under ``local_map``,
    the weights split as x's channels."""
    if not isinstance(x, DTensor):
        return _conv1d(params["w"], params["b"], x)
    mesh, last = x.device_mesh, x.dim() - 1
    if any(p.is_shard() and p.dim not in (0, last) for p in x.placements):
        raise NotImplementedError(f"a conv over inputs placed {x.placements}")
    w_pl = [Shard(1) if p == Shard(last) else Replicate() for p in x.placements]
    b_pl = [Shard(0) if p == Shard(last) else Replicate() for p in x.placements]
    w, b = params["w"].redistribute(mesh, w_pl), params["b"].redistribute(mesh, b_pl)
    summed = [Partial() if p == Shard(0) else None for p in x.placements]
    x_pl = list(x.placements)
    grads = ([s or q for s, q in zip(summed, w_pl)], [s or q for s, q in zip(summed, b_pl)], x_pl)
    return local_map(_conv1d, out_placements=x_pl, in_placements=(w_pl, b_pl, x_pl),
                     in_grad_placements=grads, device_mesh=mesh)(w, b, x)


def _conv1d(w, b, x):
    width, s = w.shape[0], x.shape[1]
    w = w.float()
    out = torch.zeros_like(x, dtype=torch.float32)
    for j in range(width):
        shifted = x if j == 0 else F.pad(x, (0, 0, j, 0))[:, :s]
        out = out + shifted.float() * w[width - 1 - j]
    return (out + b.float()).to(x.dtype)


def conv1d_tail(hist, width: int):
    """The last width-1 inputs of ``hist`` (B, T, C), zero-padded on the
    left when T is shorter: the conv state a decode step continues from."""
    keep = width - 1
    if hist.shape[1] >= keep:
        return hist[:, -keep:]
    return F.pad(hist, (0, 0, keep - hist.shape[1], 0))


def conv1d_step(params, x_t, state):
    """One decode step. x_t: (B, C); state: (B, width-1, C), the past
    inputs, oldest first. Returns (out (B, C) in x_t's dtype, the new
    state: the window's last width-1 inputs)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)           # (B, width, C)
    out = (window.float() * params["w"].float()).sum(dim=1) + params["b"].float()
    return out.to(x_t.dtype), window[:, 1:]
