"""Plain reference of the GQA-attention + top-k MoE decoder (granite-moe),
served greedily: the logits after a prompt and after one token more.

float32 throughout (TF32 off), from the weights the benchmark drew, in the
program's parameter layout. Each block: RMSNorm with a (1 + gain), the q/k/v
projections, RoPE (halves rotated together) at absolute positions, causal
attention with the query heads grouped on the KV heads, the output
projection into the residual; then RMSNorm, the router's top-k with a
softmax over the k picks, and each kept assignment's SwiGLU expert times its
gate into the residual. The tied embedding is the head.

The MoE's capacity rule (GShard): within one call of the layer, T tokens
(a batch's prompts, or a decode step's batch of one token a row) give each
expert ``min(max(8, int(cf * T * k / E)), T * k)`` slots; assignments taken
in (token, k) order beyond an expert's slots are dropped. A request is one
prefill and then one step, so its positions fall in two such groups.

Plain torch; imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, exact_f32, rmsnorm, rope

QUERY_BLOCK = 1024


def causal_attention(q, k, v, scale: float):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), f32: each query attends the
    keys at its position and before. Query head h reads KV head h // (Hq /
    Hkv). In blocks of QUERY_BLOCK queries, each against the keys up to its
    last, so no (S, S) score tensor exists at once."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    out = torch.empty_like(q)
    for i0 in range(0, s, QUERY_BLOCK):
        i1 = min(i0 + QUERY_BLOCK, s)
        qb = q[:, i0:i1].reshape(b, i1 - i0, hkv, g, dh)
        scores = torch.einsum("biagd,bjad->bagij", qb, k[:, :i1]) * scale
        allowed = (torch.arange(i1, device=q.device)[None, :]
                   <= torch.arange(i0, i1, device=q.device)[:, None])
        p = torch.softmax(scores.masked_fill_(~allowed, float("-inf")), dim=-1)
        del scores
        out[:, i0:i1] = torch.einsum("bagij,bjad->biagd", p, v[:, :i1]).reshape(b, i1 - i0, hq, dh)
    return out


def moe(c, p, h, groups, prec, capacity_factor: float):
    """The MoE layer on h (B, S, d) f32, the capacity rule applied within
    each group of positions [s0, s1) over all rows."""
    b, _, d = h.shape
    e, k = c["num_local_experts"], c["num_experts_per_tok"]
    top, ids = torch.topk(h @ p["router"].float(), k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for s0, s1 in groups:
        hg = h[:, s0:s1].reshape(-1, d)
        t = hg.shape[0]
        cap = min(max(8, int(capacity_factor * t * k / e)), t * k)
        flat = ids[:, s0:s1].reshape(-1)                        # (token, k) order
        rank = F.one_hot(flat, e).cumsum(0).gather(1, flat[:, None])[:, 0] - 1
        kept = rank < cap
        gate = gates[:, s0:s1].reshape(-1)
        og = torch.zeros_like(hg)
        for x in range(e):
            a = torch.nonzero((flat == x) & kept)[:, 0]
            if a.numel() == 0:
                continue
            tok = a // k
            xe = hg[tok]
            y = F.silu(prec.mm(xe, p["w_gate"][x])) * prec.mm(xe, p["w_in"][x])
            og.index_add_(0, tok, prec.mm(y, p["w_out"][x]) * gate[a, None])
        out[:, s0:s1] = og.view(b, s1 - s0, d)
    return out


@torch.no_grad()
def logits(c, params, prompts, served, prec: Precision = Precision(), capacity_factor=2.0):
    """prompts (B, S) and served (B,) token ids: the logits (B, 2, V) f32
    at position S-1 (after the prompt) and at S (after ``served``, fed
    there)."""
    exact_f32()
    b, s = prompts.shape
    d, hq, hkv, dh = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                      c["head_dim"])
    eps, theta, scale = c["rms_norm_eps"], float(c["rope_theta"]), c["attention_multiplier"]
    tokens = torch.cat([prompts, served[:, None]], dim=1)
    table = params["embed"]["table"]
    x = table[tokens].float()
    pos = torch.arange(s + 1, device=x.device)
    groups = ((0, s), (s, s + 1))                        # the prefill, then the step
    for lp in params["layers"]:
        a = lp["attn"]
        h = rmsnorm(x, lp["ln1"]["scale"], eps)
        q = prec.mm(h, a["wq"].reshape(d, -1)).view(b, s + 1, hq, dh)
        kk = prec.mm(h, a["wk"].reshape(d, -1)).view(b, s + 1, hkv, dh)
        v = prec.mm(h, a["wv"].reshape(d, -1)).view(b, s + 1, hkv, dh)
        o = causal_attention(rope(q, pos, theta), rope(kk, pos, theta), v, scale)
        x = x + prec.mm(o.reshape(b, s + 1, hq * dh), a["wo"].reshape(hq * dh, d))
        x = x + moe(c, lp["moe"], rmsnorm(x, lp["ln2"]["scale"], eps), groups, prec,
                    capacity_factor)
    h = rmsnorm(x[:, s - 1:], params["final_norm"]["scale"], eps)
    return prec.mm(h, table.T)
