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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import conv1d_apply, conv1d_step, conv1d_tail
from repro_torch.parallel.sharding import constrain, fsdp_gathered


def chunk_len(cfg, s: int) -> int:
    """The reference's chunk rule: min(ssm_chunk, S), decremented until it
    divides S."""
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    return q


def _split_proj(cfg, proj):
    """The fused input projection's parts: z (d_inner), xBC (d_inner + 2N)
    and dt (nh)."""
    di, n = cfg.d_inner, cfg.ssm_state_dim
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _gated_norm(params, y, z, eps):
    """y · silu(z), RMS-normalised with the ``1 + scale`` gain, in f32."""
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + eps)
    return y * (1.0 + params["norm_scale"])


def ssd_forward(cfg, params, x, *, state=None, conv_state=None,
                return_state: bool = False, env=None):
    """x: (B, S, d). Returns out (B, S, d), and with ``return_state`` also
    (h (B, nh, P, N) f32, conv state (B, width-1, d_inner+2N) f32)."""
    bsz, s, _ = x.shape
    di, n, nh, p_dim = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    q = chunk_len(cfg, s)
    nc = s // q

    proj = constrain(env, x @ fsdp_gathered(params["w_in"]), "act_batch", "act_seq", "act_mlp")
    z, xbc, dt = _split_proj(cfg, proj)
    if conv_state is not None:
        hist = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        xbc_c = F.silu(conv1d_apply(params["conv"], hist)[:, conv_state.shape[1]:])
    else:
        hist = xbc
        xbc_c = F.silu(conv1d_apply(params["conv"], xbc))
    new_conv = conv1d_tail(hist, cfg.conv_width)
    xs = xbc_c[..., :di].reshape(bsz, s, nh, p_dim)
    bmat = xbc_c[..., di:di + n]                                   # (B, S, N)
    cmat = xbc_c[..., di + n:]                                     # (B, S, N)

    dt = F.softplus(dt.float() + params["dt_bias"])                # (B, S, nh)
    da = -torch.exp(params["a_log"]) * dt                          # (B, S, nh) <= 0

    xs_c = xs.reshape(bsz, nc, q, nh, p_dim).float()
    b_c = bmat.reshape(bsz, nc, q, n).float()
    c_c = cmat.reshape(bsz, nc, q, n).float()
    da_c = da.reshape(bsz, nc, q, nh)
    dt_c = dt.reshape(bsz, nc, q, nh)

    cum = torch.cumsum(da_c, dim=2)                                # (B, nc, q, nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B, nc, q, q, nh)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
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

    h = (torch.zeros(bsz, nh, p_dim, n, dtype=torch.float32, device=x.device)
         if state is None else state)
    y_inter = []
    for c in range(nc):
        # inter-chunk: y_i += C_i exp(cum_i) h_prev
        y_inter.append(torch.einsum("bin,bih,bhpn->bihp",
                                    c_c[:, c], torch.exp(cum[:, c]), h))
        h = chunk_decay[:, c, :, None, None] * h + s_in[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)                      # (B, nc, q, nh, P)
    y = y.reshape(bsz, s, nh, p_dim)
    y = y + params["d_skip"][:, None] * xs.float()
    y = y.reshape(bsz, s, di)
    y = _gated_norm(params, y, z, cfg.norm_eps).to(x.dtype)
    out = constrain(env, y @ fsdp_gathered(params["w_out"]), "act_batch", "act_seq", "act_embed")
    if return_state:
        return out, (h, new_conv.float())
    return out


def ssd_step(cfg, params, x_t, state, env=None):
    """One decode step. x_t: (B, 1, d); state: (h (B, nh, P, N) f32, conv
    state (B, width-1, d_inner+2N) f32). Returns (out (B, 1, d), new state);
    ``env`` constrains the projection and the output as ``ssd_forward``."""
    h, conv_state = state
    di, n, nh, p_dim = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    proj = constrain(env, x_t[:, 0] @ fsdp_gathered(params["w_in"]), "act_batch", "act_mlp")
    z, xbc, dt = _split_proj(cfg, proj)
    xbc_c, new_conv = conv1d_step(params["conv"], xbc, conv_state.to(xbc.dtype))
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :di].reshape(-1, nh, p_dim).float()
    bvec = xbc_c[..., di:di + n].float()
    cvec = xbc_c[..., di + n:].float()
    dt = F.softplus(dt.float() + params["dt_bias"])
    da = torch.exp(-torch.exp(params["a_log"]) * dt)               # (B, nh)
    h_new = da[:, :, None, None] * h + torch.einsum("bh,bn,bhp->bhpn", dt, bvec, xs)
    y = torch.einsum("bn,bhpn->bhp", cvec, h_new)
    y = y + params["d_skip"][:, None] * xs
    y = y.reshape(-1, di)
    y = _gated_norm(params, y, z, cfg.norm_eps).to(x_t.dtype)
    out = constrain(env, y @ fsdp_gathered(params["w_out"]), "act_batch", "act_embed")
    return out[:, None, :], (h_new, new_conv.float())
