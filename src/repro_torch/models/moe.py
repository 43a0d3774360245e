"""Mixture-of-Experts: token-choice top-k routing with capacity-bounded,
sort-based dispatch (the reference's ``models/moe.py``).

The per-device body is the reference's ``_dispatch_compute``: on one device
with every expert local (``e0 = 0``, ``e_local = E``); on a mesh, under
``local_map`` in place of ``shard_map``:

* **EP mode** (arctic: experts divide over ``model``): each model rank owns
  ``E / tp`` experts from ``e0 = model_rank * E_local``, gathers its own
  experts' tokens from its local batch (no all-to-all), and a sum over
  ``model`` (a DTensor ``Partial`` made ``Replicate``: the reference's
  ``psum``) combines the experts' contributions. The expert weights are
  FSDP-gathered over ``data`` before the body (the backward reduce-scatters
  their gradients).
* **TP mode** (granite: 40 experts): experts replicated, each expert's ff
  split over ``model``; the same body with ``E_local = E`` gives ff-shard
  partials, summed over ``model``.

Routing runs before the body (its own ``local_map``, so the router's
gradient sums over the batch shards while each model rank's copy of the
routing is the same).

* Routing: router logits in f32, top-k, softmax over the k picks.
* Capacity: ``max(8, int(cf * T * k / E))`` slots an expert, at most T * k,
  with T the **local** token count ``B * S / dp`` (on one device, B * S).
  A sharded step thus drops per data shard: what a single device drops
  differs once the capacity binds.
* Dispatch: a stable sort of the T * k assignments by expert id (other
  ranks' experts last); an assignment's rank in its expert's group comes
  from a running max of the group starts, and assignments ranked at or
  past the capacity are dropped (GShard). A stable sort keeps the
  reference's order, so the kept and dropped assignments are the
  reference's.
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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


def dispatch_plan(ids, num_experts: int, cap: int, e0=None):
    """ids: (N,) expert id of each assignment, in (token, k) order; this
    device's experts are ``e0 .. e0 + num_experts - 1``, or all of them
    when ``e0`` is None.

    Returns (order, dest, valid), all (N,): ``order`` sorts the assignments
    by local expert, stably, other devices' experts last; the sorted
    assignment j goes to slot ``dest[j]`` = local expert * cap + rank in
    its expert's group, or to the spare slot num_experts * cap when
    ``valid[j]`` is False (another device's expert, or its rank is cap or
    more)."""
    n = ids.numel()
    key = ids if e0 is None else torch.where((ids >= e0) & (ids < e0 + num_experts), ids - e0,
                                             num_experts)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    pos = torch.arange(n, device=ids.device)
    change = torch.ones(n, dtype=torch.bool, device=ids.device)
    change[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(change, pos, 0), dim=0).values
    rank = pos - first
    valid = rank < cap if e0 is None else (sk < num_experts) & (rank < cap)
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


def dispatch_compute(x, ids, gate_w, w_in, w_gate, w_out, *, activation: str, cap: int,
                     e0=None):
    """The per-device body: x (B, S, d), ids and gate_w (B, S, k), this
    device's experts' weights (E_local, ...) from expert ``e0`` (every
    expert when None). Returns the kept assignments' gated outputs summed
    a token, (B, S, d)."""
    b, s, d = x.shape
    k = ids.shape[-1]
    t = b * s
    e_local = w_in.shape[0]
    order, dest, valid = dispatch_plan(ids.reshape(t * k), e_local, cap, e0)

    x_f = x.reshape(t, d)
    tok = torch.div(order, k, rounding_mode="floor")     # token of each sorted assignment
    gathered = x.new_zeros((e_local * cap + 1, d))
    gathered[dest] = torch.where(valid[:, None], x_f[tok], 0)
    gx = gathered[:-1].view(e_local, cap, d)

    h = bmm_f32(gx, w_in)
    g = bmm_f32(gx, w_gate) if activation in GATED else None
    h = mlp_activate(activation, h, g)
    y = torch.bmm(h.to(x.dtype), w_out).view(e_local * cap, d)

    y_assign = torch.where(valid[:, None], y[torch.where(valid, dest, 0)], 0)
    contrib = y_assign * gate_w.reshape(t * k)[order].to(x.dtype)[:, None]
    per_tk = torch.empty_like(contrib)
    per_tk[order] = contrib                           # back to (token, k) order
    return per_tk.view(t, k, d).float().sum(dim=1).to(x.dtype).view(b, s, d)


def moe_apply(cfg, params, x, *, capacity_factor: float = 2.0, env=None):
    """x: (B, S, d) -> (B, S, d); sharded as the env's rules say when x is
    a DTensor (``_moe_sharded``)."""
    if isinstance(x, DTensor):
        return _moe_sharded(cfg, params, x, capacity_factor, env)
    b, s, _ = x.shape
    gate_w, ids = route(cfg, params, x)
    return dispatch_compute(x, ids, gate_w, params["w_in"], params.get("w_gate"),
                            params["w_out"], activation=cfg.mlp_activation,
                            cap=capacity(cfg, b * s, capacity_factor))


def _moe_sharded(cfg, params, x, capacity_factor, env):
    """``moe_apply`` of a DTensor x on its mesh: the body on each rank's
    batch shard and experts (EP) or ff shard (TP) under ``local_map``."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    b, s, _ = x.shape
    ep = cfg.moe_parallelism == "ep"
    tp = env.tp
    if ep and cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not divide over model = {tp}")
    cap = capacity(cfg, b * s // env.dp, capacity_factor)
    x = env.constrain(x, "act_batch", None, None)
    x_pl = list(x.placements)
    if any(p.is_shard() and p.dim != 0 for p in x_pl):
        raise NotImplementedError(f"the MoE over activations placed {x_pl}")
    # the sum over ``model``, on the output and on the gradients of the
    # inputs the model ranks share
    model_partial = [Partial() if n == "model" else p for n, p in zip(names, x_pl)]

    def route_local(xl, router):
        return route(cfg, {"router": router}, xl)

    router = params["router"].redistribute(mesh, [Replicate()] * len(names))
    batch_partial = [Partial() if p.is_shard() else Replicate() for p in x_pl]
    gate_w, ids = local_map(route_local, out_placements=(x_pl, x_pl),
                            in_placements=(x_pl, router.placements),
                            in_grad_placements=(x_pl, batch_partial),
                            device_mesh=mesh)(x, router)

    # each weight whole over pod and data (the FSDP gather), split over
    # model on its expert (EP) or ff (TP) dimension
    def gathered(w, split_dim):
        pl = [Shard(split_dim) if n == "model" and tp > 1 else Replicate() for n in names]
        grad = [q if n == "model" else (Partial() if xp.is_shard() else Replicate())
                for n, q, xp in zip(names, pl, x_pl)]
        return w.redistribute(mesh, pl), pl, grad

    gated = cfg.mlp_activation in GATED
    w_in, in_pl, in_gr = gathered(params["w_in"], 0 if ep else 2)
    w_out, out_pl, out_gr = gathered(params["w_out"], 0 if ep else 1)
    w_gate = gathered(params["w_gate"], 0 if ep else 2)[0] if gated else None
    model_rank = mesh.get_local_rank("model") if "model" in names else 0

    def body(xl, idl, gwl, wi, wg, wo):
        return dispatch_compute(xl, idl, gwl, wi, wg, wo, activation=cfg.mlp_activation,
                                cap=cap, e0=model_rank * wi.shape[0] if ep else None)

    args = (x, ids, gate_w, w_in, w_gate, w_out)
    out = local_map(body, out_placements=model_partial,
                    in_placements=(x_pl, x_pl, x_pl, in_pl, in_pl if gated else None, out_pl),
                    in_grad_placements=(model_partial, x_pl, model_partial, in_gr,
                                        in_gr if gated else None, out_gr),
                    device_mesh=mesh)(*args)
    return out.redistribute(mesh, x_pl)


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
