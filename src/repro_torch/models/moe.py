"""Mixture-of-Experts on one device: token-choice top-k routing with
capacity-bounded, sort-based dispatch.

The counterpart of the reference's ``models/moe.py`` with one shard: its
per-device body ``_dispatch_compute`` with every expert local (``e0 = 0``,
``e_local = E``), no FSDP gather and no ``psum``.

* Routing: router logits in f32, top-k, softmax over the k picks.
* Capacity: ``max(8, int(cf * T * k / E))`` slots an expert, at most T * k.
* Dispatch: a stable sort of the T * k assignments by expert id; an
  assignment's rank in its expert's group comes from a running max of the
  group starts, and assignments ranked at or past the capacity are dropped
  (GShard). A stable sort keeps the reference's order, so the kept and
  dropped assignments are the reference's.
* The grouped expert products are batched matmuls (the reference's einsums).
* Combine: each kept assignment's output times its gate weight, rounded to
  the activation dtype as the reference rounds it, put back in (token, k)
  order and summed over k in f32, then rounded once. The reference
  scatter-adds in the activation dtype; the sum here is deterministic (no
  atomics), so a rerun on the card gives the same bits, and in f32 the two
  agree to ~1e-6.

Nothing here waits on the host: no ``.item()``, no ``nonzero``, no boolean
indexing; dropped assignments write to a spare row and read zeros.

Rounding: in f32 the arithmetic is the reference's. In bf16, as in the
reference, the expert products ``h`` and ``g`` stay in f32 up to the
activation (``bmm_f32``), which rounds once, and ``w_out``'s product rounds
once; only the combine differs: it sums a token's k terms in f32 where the
reference rounds after each add, so the two differ by a few bf16 ulps of
the output (``tests/test_torch_moe.py`` states the bound).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import GATED, mlp_activate


def route(cfg, params, x):
    """x: (B, S, d) -> gate weights (B, S, k) f32 and expert ids (B, S, k)."""
    logits = x.float() @ params["router"]
    gate_w, ids = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    return torch.softmax(gate_w, dim=-1), ids


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Slots an expert: ``max(8, int(cf * T * k / E))``, at most T * k."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return min(max(8, int(capacity_factor * tokens * k / e)), tokens * k)


def dispatch_plan(ids, num_experts: int, cap: int):
    """ids: (N,) expert id of each assignment, in (token, k) order.

    Returns (order, dest, valid), all (N,): ``order`` sorts the assignments
    by expert, stably; the sorted assignment j goes to slot ``dest[j]`` =
    expert * cap + rank in its expert's group, or to the spare slot
    E * cap when ``valid[j]`` is False (its rank is cap or more)."""
    n = ids.numel()
    order = torch.argsort(ids, stable=True)
    sk = ids[order]
    pos = torch.arange(n, device=ids.device)
    change = torch.ones(n, dtype=torch.bool, device=ids.device)
    change[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(change, pos, 0), dim=0).values
    rank = pos - first
    valid = rank < cap
    dest = torch.where(valid, sk * cap + rank, num_experts * cap)
    return order, dest, valid


class _BmmF32(torch.autograd.Function):
    """bf16 (or other) operands, the product accumulated and returned in
    f32; the backward takes the f32 cotangent against the operands widened
    to f32 and rounds each gradient to its operand's dtype, as JAX
    transposes a dot with ``preferred_element_type``. torch's ``bmm`` with
    ``out_dtype`` has no derivative, hence this function."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().transpose(1, 2)).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = (a.float().transpose(1, 2) @ g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def bmm_f32(a, b):
    """``a @ b`` batched, accumulated and returned in f32 (the reference's
    ``preferred_element_type=float32``). On the card cuBLAS writes the f32
    result of bf16 operands directly; the CPU build has no such overload, so
    there the operands are widened first (exact for bf16 values).
    Differentiable on both (``_BmmF32``)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def moe_apply(cfg, params, x, *, capacity_factor: float = 2.0):
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    gate_w, ids = route(cfg, params, x)
    cap = capacity(cfg, t, capacity_factor)
    order, dest, valid = dispatch_plan(ids.reshape(t * k), e, cap)

    x_f = x.reshape(t, d)
    tok = torch.div(order, k, rounding_mode="floor")     # token of each sorted assignment
    gathered = x.new_zeros((e * cap + 1, d))
    gathered[dest] = torch.where(valid[:, None], x_f[tok], 0)
    gx = gathered[:-1].view(e, cap, d)

    h = bmm_f32(gx, params["w_in"])
    g = bmm_f32(gx, params["w_gate"]) if cfg.mlp_activation in GATED else None
    h = mlp_activate(cfg.mlp_activation, h, g)
    y = torch.bmm(h.to(x.dtype), params["w_out"]).view(e * cap, d)

    y_assign = torch.where(valid[:, None], y[torch.where(valid, dest, 0)], 0)
    contrib = y_assign * gate_w.reshape(t * k)[order].to(x.dtype)[:, None]
    per_tk = torch.empty_like(contrib)
    per_tk[order] = contrib                           # back to (token, k) order
    return per_tk.view(t, k, d).float().sum(dim=1).to(x.dtype).view(b, s, d)


def moe_ref(cfg, params, x):
    """Dense oracle: every expert on every token, weighted by the routing.
    No capacity limit: equals ``moe_apply`` when nothing is dropped."""
    gate_w, ids = route(cfg, params, x)
    h = torch.einsum("bsd,edf->bsef", x.float(), params["w_in"].float())
    g = (torch.einsum("bsd,edf->bsef", x.float(), params["w_gate"].float())
         if "w_gate" in params else None)
    h = mlp_activate(cfg.mlp_activation, h, g).to(x.dtype)
    y = torch.einsum("bsef,efd->bsed", h.float(), params["w_out"].float())
    mask = torch.nn.functional.one_hot(ids, cfg.num_experts).float() * gate_w[..., None]
    return torch.einsum("bsed,bse->bsd", y, mask.sum(dim=2)).to(x.dtype)
