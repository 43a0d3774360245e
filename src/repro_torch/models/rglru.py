"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of the reference's ``models/rglru.py``. Block: x -> [branch
A: linear -> GeLU (tanh form)] * [branch B: linear -> causal conv ->
RG-LRU] -> output projection, with per-channel (diagonal) gates:

    r_t = sigmoid(w_r * u_t + b_r)          (recurrence gate)
    i_t = sigmoid(w_i * u_t + b_i)          (input gate)
    a_t = exp(-c * softplus(lam) * r_t)     (per-channel decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The sequence recurrence is a chunked linear scan: inside each chunk a
log-depth Hillis–Steele scan in plain torch (torch has no stable
``associative_scan``), across chunks a Python loop carrying h, the
counterpart of the reference's ``lax.scan``. The scan combines in another
order than XLA's ``associative_scan``, so f32 results differ by rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import conv1d_apply, conv1d_step, conv1d_tail
from repro_torch.parallel.sharding import constrain, product

RGLRU_C = 8.0


def _gates(params, u):
    """(a, b) of h_t = a_t h_{t-1} + b_t, in f32, from the conv's output u."""
    uf = u.float()
    r = torch.sigmoid(params["w_r"] * uf + params["b_r"])
    i = torch.sigmoid(params["w_i"] * uf + params["b_i"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * uf)
    return a, b


def scan_chunks(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 2 of (..., c, W)
    from h = 0, as (cum_a, cum_b) with h_t = cum_a_t h_start + cum_b_t:
    ceil(log2 c) passes, pass k combining each t with t - 2^k as
    (a1 a2, a2 b1 + b2)."""
    c, shift = a.shape[2], 1
    while shift < c:
        a_prev, b_prev = a[:, :, :-shift], b[:, :, :-shift]
        a_cur, b_cur = a[:, :, shift:], b[:, :, shift:]
        a = torch.cat([a[:, :, :shift], a_prev * a_cur], dim=2)
        b = torch.cat([b[:, :, :shift], a_cur * b_prev + b_cur], dim=2)
        shift *= 2
    return a, b


def _linear_scan(a, b, h0, chunk: int):
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b: (B, S, W) f32; h0 (B, W).
    Returns (h for every t (B, S, W), the last h (B, W))."""
    bsz, s, w = a.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    nc = s // c
    cum_a, cum_b = scan_chunks(a.reshape(bsz, nc, c, w), b.reshape(bsz, nc, c, w))
    h, h_seq = h0, []
    for k in range(nc):
        h_all = cum_a[:, k] * h[:, None, :] + cum_b[:, k]
        h_seq.append(h_all)
        h = h_all[:, -1]
    return torch.stack(h_seq, dim=1).reshape(bsz, s, w), h


def rglru_forward(cfg, params, x, *, chunk: int = 256, h0=None, conv_state=None,
                  return_state: bool = False, env=None):
    """x: (B, S, d). Returns out (B, S, d), and with ``return_state`` also
    (h (B, W) f32, conv state (B, width-1, W) f32)."""
    bsz = x.shape[0]
    rw = params["w_out"].shape[0]
    ga = F.gelu(product(x, params["w_a"], env), approximate="tanh")
    u = constrain(env, product(x, params["w_b"], env), "act_batch", "act_seq", "act_mlp")
    if conv_state is not None:
        hist = torch.cat([conv_state.to(u.dtype), u], dim=1)
        u_conv = conv1d_apply(params["conv"], hist)[:, conv_state.shape[1]:]
    else:
        hist = u
        u_conv = conv1d_apply(params["conv"], u)
    new_conv = conv1d_tail(hist, cfg.conv_width)
    a, b = _gates(params, u_conv)
    if h0 is None:
        h0 = torch.zeros(bsz, rw, dtype=torch.float32, device=x.device)
    h_seq, h_last = _linear_scan(a, b, h0, chunk)
    out = product((ga.float() * h_seq).to(x.dtype), params["w_out"], env)
    out = constrain(env, out, "act_batch", "act_seq", "act_embed", grad=True)
    if return_state:
        return out, (h_last, new_conv.float())
    return out


def rglru_step(cfg, params, x_t, state, env=None):
    """One decode step. x_t: (B, 1, d); state = (h (B, W) f32, conv state
    (B, width-1, W) f32). Returns (out (B, 1, d), new state); ``env``
    constrains the recurrent input and the output as ``rglru_forward``."""
    h, conv_state = state
    ga = F.gelu(product(x_t[:, 0], params["w_a"], env), approximate="tanh")
    u = constrain(env, product(x_t[:, 0], params["w_b"], env), "act_batch", "act_mlp")
    u_conv, new_conv = conv1d_step(params["conv"], u, conv_state.to(u.dtype))
    a, b = _gates(params, u_conv)
    h_new = a * h + b
    out = product((ga.float() * h_new).to(x_t.dtype), params["w_out"], env)
    return constrain(env, out, "act_batch", "act_embed")[:, None, :], (h_new, new_conv.float())
