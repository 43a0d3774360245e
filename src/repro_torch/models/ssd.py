"""Mamba-2 SSD (state-space duality) block, chunked.

The counterpart of the reference's ``models/ssd.py``. The recurrence

    h_t = exp(dA_t) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t

runs chunk-wise (chunk q from ``cfg.ssm_chunk``): within a chunk the dual
quadratic form (C B^T ⊙ L ⊙ dt) X is a batch of q × q products; across
chunks a Python loop carries the (B, nh, P, N) f32 state, the counterpart
of the reference's ``lax.scan``. Layout: d_inner = expand·d_model, nh =
d_inner / P heads, one B/C group, a scalar A a head, a depthwise conv of
width ``conv_width`` over (x, B, C). Every cast sits where the reference
casts, so a bf16 run rounds where it rounds. Plain torch: the reference
computes these products in jnp, not in a kernel.

On a mesh the fused input projection (z, x, B‖C, dt) is split over
``model`` in slices that straddle its parts' ends; each part is projected
against its own columns, regrouped so that the split falls on the part
(``sharding.column_parts``): z, x and dt keep their split (x and dt by
heads), B‖C is gathered after its conv, as the reference gathers B and C.
The conv follows the same parts, and the scan runs on each rank's heads
under ``local_map``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import conv1d_apply, conv1d_step, conv1d_tail
from repro_torch.parallel.sharding import (column_parts, constrain, joined_columns,
                                           product, reduced)


def chunk_len(cfg, s: int) -> int:
    """The reference's chunk rule: min(ssm_chunk, S), decremented until it
    divides S."""
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    return q


def _parts(cfg, params, x, env=None):
    """x (..., d) times the fused input projection, as its parts: z
    (d_inner), x (d_inner), B‖C (2N) and dt (nh). On a mesh each part is
    its own product against its columns (``column_parts``), each split
    over ``model`` as the weight's columns are (B‖C until its conv)."""
    di, n, nh = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    sizes = (di, di, 2 * n, nh)
    if not isinstance(params["w_in"], DTensor):
        return list(torch.split(x @ params["w_in"], list(sizes), dim=-1))
    seq = ("act_seq",) if x.dim() == 3 else ()
    return [constrain(env, product(x, w, env), "act_batch", *seq, "act_mlp")
            for w in column_parts(params["w_in"], sizes)]


def _conv_parts(cfg, params):
    """The conv's weights and biases as x's and B‖C's, split as those are."""
    sizes = (cfg.d_inner, 2 * cfg.ssm_state_dim)
    ws, bs = (column_parts(params["conv"][k], sizes) for k in ("w", "b"))
    return [{"w": w, "b": b} for w, b in zip(ws, bs)]


def _gated_norm(params, y, z, eps):
    """y · silu(z), RMS-normalised with the ``1 + scale`` gain, in f32 (on
    a mesh the mean of squares all-reduced over the split of d_inner)."""
    y = y * F.silu(z.float())
    if isinstance(y, DTensor):
        var = reduced(y.square().sum(dim=-1, keepdim=True)) / y.shape[-1]
    else:
        var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + eps)
    return y * (1.0 + params["norm_scale"])


def _on_heads(fn, xs, bc, dt, heads, state, out_ranks):
    """``fn(xs, bc, dt, a_log, dt_bias, d_skip, state)`` on plain tensors,
    or on a mesh under ``local_map`` on each rank's batch rows and heads:
    xs (B, ..., nh·P) and dt (B, ..., nh) split as the projection left
    them, bc (B, ..., 2N) whole over ``model`` (its gradient a sum there),
    the head vectors ``heads`` split as dt's heads, the state (B, nh, ...)
    too. ``out_ranks``: the ranks of fn's outputs, each split by batch and
    heads as xs (the last dimension) or the state (dimension 1)."""
    if not isinstance(xs, DTensor):
        return fn(xs, bc, dt, *heads, state)
    mesh, last = xs.device_mesh, dt.dim() - 1
    batch = [p == Shard(0) for p in dt.placements]
    split = [p == Shard(last) for p in dt.placements]

    def placed(head_dim, across=Replicate()):
        """Split by batch rows and by heads (at ``head_dim``; ``across``
        where the heads are split but the tensor has none)."""
        return [Shard(0) if b else ((Shard(head_dim) if head_dim is not None else across)
                                    if s else Replicate()) for b, s in zip(batch, split)]

    head_pl = [Shard(0) if s else Replicate() for s in split]
    heads = [h.redistribute(mesh, head_pl) for h in heads]
    head_grad = [Partial() if b else p for b, p in zip(batch, head_pl)]
    state_pl = placed(1)
    outs = tuple(placed(r - 1) if r == xs.dim() else state_pl for r in out_ranks)
    in_pl = (xs.placements, placed(None), dt.placements, *([head_pl] * 3),
             None if state is None else state_pl)
    grads = (xs.placements, placed(None, Partial()), dt.placements, *([head_grad] * 3),
             None if state is None else state_pl)
    return local_map(fn, out_placements=outs, in_placements=in_pl, in_grad_placements=grads,
                     device_mesh=mesh)(xs, bc, dt, *heads, state)


def _heads_of(params):
    return [params[k] for k in ("a_log", "dt_bias", "d_skip")]


def ssd_forward(cfg, params, x, *, state=None, conv_state=None,
                return_state: bool = False, env=None):
    """x: (B, S, d). Returns out (B, S, d), and with ``return_state`` also
    (h (B, nh, P, N) f32, conv state (B, width-1, d_inner+2N) f32)."""
    z, xs, bc, dt = _parts(cfg, params, x, env)
    convs = _conv_parts(cfg, params)
    if conv_state is not None:
        past = column_parts(conv_state, (cfg.d_inner, 2 * cfg.ssm_state_dim))
        hist = [torch.cat([p.to(t.dtype), t], dim=1) for p, t in zip(past, (xs, bc))]
        xs_c, bc_c = (F.silu(conv1d_apply(c, h)[:, conv_state.shape[1]:])
                      for c, h in zip(convs, hist))
    else:
        hist = [xs, bc]
        xs_c, bc_c = (F.silu(conv1d_apply(c, t)) for c, t in zip(convs, hist))
    new_conv = joined_columns([conv1d_tail(h, cfg.conv_width) for h in hist])
    bc_c = constrain(env, bc_c, "act_batch", "act_seq", None)
    y, h = _on_heads(functools.partial(_scan, cfg), xs_c, bc_c, dt, _heads_of(params), state,
                     (3, 4))
    y = _gated_norm(params, y, z, cfg.norm_eps).to(x.dtype)
    out = constrain(env, product(y, params["w_out"], env), "act_batch", "act_seq", "act_embed",
                    grad=True)
    if return_state:
        return out, (h, new_conv.float())
    return out


def _scan(cfg, xs, bc, dt, a_log, dt_bias, d_skip, state):
    """The chunked SSD over plain tensors: xs (B, S, nh·P) after the conv,
    bc (B, S, 2N) after it, dt (B, S, nh) raw, the heads' a_log, dt_bias
    and d_skip (nh,), the state (B, nh, P, N) f32 or None (zeros). Returns
    (y (B, S, nh·P) f32 with the skip, the last state)."""
    bsz, s, _ = xs.shape
    n, p_dim, nh = cfg.ssm_state_dim, cfg.ssm_head_dim, dt.shape[-1]
    q = chunk_len(cfg, s)
    nc = s // q
    xs = xs.reshape(bsz, s, nh, p_dim)
    bmat, cmat = bc[..., :n], bc[..., n:]                          # (B, S, N) each

    dt = F.softplus(dt.float() + dt_bias)                          # (B, S, nh)
    da = -torch.exp(a_log) * dt                                    # (B, S, nh) <= 0

    xs_c = xs.reshape(bsz, nc, q, nh, p_dim).float()
    b_c = bmat.reshape(bsz, nc, q, n).float()
    c_c = cmat.reshape(bsz, nc, q, n).float()
    da_c = da.reshape(bsz, nc, q, nh)
    dt_c = dt.reshape(bsz, nc, q, nh)

    cum = torch.cumsum(da_c, dim=2)                                # (B, nc, q, nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B, nc, q, q, nh)
    causal = torch.ones(q, q, dtype=torch.bool, device=xs.device).tril()[None, None, :, :, None]
    # the mask before the exp: on causal entries seg <= 0, so exp never
    # overflows (the reference's order)
    l_mat = torch.exp(torch.where(causal, seg, -1e30))
    del seg

    # intra-chunk: Y = (C B^T ⊙ L ⊙ dt_j) X
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)                 # (B, nc, q, q)
    att = cb[..., None] * l_mat * dt_c[:, :, None, :, :]           # (B, nc, q, q, nh)
    del l_mat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xs_c)
    del att

    # each chunk's contribution to the state: sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                 # (B, nc, q, nh)
    s_in = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_end * dt_c, b_c, xs_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B, nc, nh)

    h = (torch.zeros(bsz, nh, p_dim, n, dtype=torch.float32, device=xs.device)
         if state is None else state)
    y_inter = []
    for c in range(nc):
        # inter-chunk: y_i += C_i exp(cum_i) h_prev
        y_inter.append(torch.einsum("bin,bih,bhpn->bihp",
                                    c_c[:, c], torch.exp(cum[:, c]), h))
        h = chunk_decay[:, c, :, None, None] * h + s_in[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)                      # (B, nc, q, nh, P)
    y = y.reshape(bsz, s, nh, p_dim)
    y = y + d_skip[:, None] * xs.float()
    return y.reshape(bsz, s, nh * p_dim), h


def _step(cfg, xs, bc, dt, a_log, dt_bias, d_skip, h):
    """One step of the recurrence over plain tensors: xs (B, nh·P) and bc
    (B, 2N) after the conv, dt (B, nh) raw, h (B, nh, P, N) f32. Returns (y
    (B, nh·P) f32 with the skip, the new state)."""
    n, p_dim, nh = cfg.ssm_state_dim, cfg.ssm_head_dim, dt.shape[-1]
    xs = xs.reshape(-1, nh, p_dim).float()
    bvec, cvec = bc[..., :n].float(), bc[..., n:].float()
    dt = F.softplus(dt.float() + dt_bias)
    da = torch.exp(-torch.exp(a_log) * dt)                         # (B, nh)
    h_new = da[:, :, None, None] * h + torch.einsum("bh,bn,bhp->bhpn", dt, bvec, xs)
    y = torch.einsum("bn,bhpn->bhp", cvec, h_new)
    y = y + d_skip[:, None] * xs
    return y.reshape(-1, nh * p_dim), h_new


def ssd_step(cfg, params, x_t, state, env=None):
    """One decode step. x_t: (B, 1, d); state: (h (B, nh, P, N) f32, conv
    state (B, width-1, d_inner+2N) f32). Returns (out (B, 1, d), new state);
    ``env`` constrains the projection and the output as ``ssd_forward``."""
    h, conv_state = state
    z, xs, bc, dt = _parts(cfg, params, x_t[:, 0], env)
    past = column_parts(conv_state, (cfg.d_inner, 2 * cfg.ssm_state_dim))
    (xs_c, conv_x), (bc_c, conv_bc) = (
        conv1d_step(c, t, p.to(t.dtype)) for c, t, p in zip(_conv_parts(cfg, params), (xs, bc), past))
    new_conv = joined_columns([conv_x, conv_bc])
    bc_c = constrain(env, F.silu(bc_c), "act_batch", None)
    y, h_new = _on_heads(functools.partial(_step, cfg), F.silu(xs_c), bc_c, dt,
                         _heads_of(params), h, (2, 4))
    y = _gated_norm(params, y, z, cfg.norm_eps).to(x_t.dtype)
    out = constrain(env, product(y, params["w_out"], env), "act_batch", "act_embed")
    return out[:, None, :], (h_new, new_conv.float())
