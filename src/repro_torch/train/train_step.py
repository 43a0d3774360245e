"""The train step and the serve steps (the reference's
``train/train_step.py`` without the mesh).

``make_train_step(cfg, run)`` returns ``step(state, batch) -> (state,
metrics)``: the loss and its gradients (accumulated over ``grad_accum``
microbatches as the reference's scan does: loss/n and gradient/n summed in
f32), clip by the global norm, the lr at the step before it is counted, the
optimizer, and each parameter updated as the reference does: its update,
rounded to the parameter's dtype, added in f32 and rounded again. The
state ``{"params", "opt", "step"}`` is updated in place, the counterpart
of the reference's donated buffers; metrics ``loss``, ``grad_norm`` and
``lr`` are 0-d f32 tensors on the device (read one to wait for the step).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import reference_leaf
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import optim as O
from repro_torch.train.tree import flatten_with_paths, tree_leaves, tree_map


def loss_and_grads(cfg, run, params, batch):
    """(loss, gradients in the parameters' dtype; zeros for a parameter the
    loss does not read, such as a parallel block's ``ln2``). ``params`` are
    read, not changed."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss = M.loss_fn(cfg, tree_map(lambda _: next(it), params), batch, run)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves))
    return loss.detach(), tree_map(lambda _: next(it), params)


def optimizer_groups(cfg: ModelConfig, params):
    """Each parameter leaf's leaf in the reference's tree, which stacks a
    pattern position's layers (``convert.reference_leaf``): the groups an
    optimizer that couples elements within a leaf (Adafactor) updates as
    one."""
    return [reference_leaf(cfg, path) for path in flatten_with_paths(params)]


def make_train_step(cfg: ModelConfig, run: RunConfig):
    if run.gradient_compression == "int8":
        raise NotImplementedError(
            "int8 gradient compression is cross-pod sharding, which the port does not have "
            "yet (ROADMAP item 11)")
    if run.gradient_compression:
        raise ValueError(f"unknown gradient_compression {run.gradient_compression!r}")
    _, opt_update = O.make_optimizer(cfg.optimizer)

    def grads_of(params, batch):
        n = run.grad_accum
        if n <= 1:
            return loss_and_grads(cfg, run, params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
        loss = 0.0
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for i in range(n):
            micro = {k: x[i * rows // n:(i + 1) * rows // n] for k, x in batch.items()}
            loss_i, g = loss_and_grads(cfg, run, params, micro)
            loss = loss + loss_i / n
            tree_map(lambda a, b: a.add_(b / n), grads, g)
            del g
        return loss, grads

    def train_step(state, batch):
        params, step = state["params"], state["step"]
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            grads, gnorm = O.clip_by_global_norm(grads, run.max_grad_norm)
            lr = O.lr_schedule(step, base_lr=run.learning_rate, warmup=run.warmup_steps)
            updates = opt_update(grads, state["opt"], params, lr=lr, b1=run.adam_b1,
                                 b2=run.adam_b2, weight_decay=run.weight_decay,
                                 groups=optimizer_groups(cfg, params))
            del grads
            tree_map(lambda p, u: p.copy_(p.float() + u.float()), params, updates)
            step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def init_train_state(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                     device=None):
    """{"params": ``init_params`` in ``run.param_dtype``, "opt": the
    optimizer's zeroed state, "step": 0 (int32)}, on the card unless
    ``device="cpu"`` (``"meta"``: shapes and dtypes only, for ``restore``);
    ``generator`` lives on that device."""
    dev = resolve_device(device)
    params = M.init_params(cfg, generator, dev, getattr(torch, run.param_dtype))
    opt_init, _ = O.make_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt_init(params, optimizer_groups(cfg, params)),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_struct(cfg: ModelConfig, run: RunConfig):
    """The train state's shapes and dtypes on the meta device (no storage)."""
    return init_train_state(cfg, run, torch.Generator(), "meta")


def make_serve_steps(cfg: ModelConfig, run: RunConfig):
    """(prefill_fn(params, batch, max_len=0), decode_fn(params, token, pos,
    cache)) over ``model.prefill`` and ``model.decode_step``."""
    def prefill_fn(params, batch, max_len: int = 0):
        return M.prefill(cfg, params, batch, max_len=max_len)

    def decode_fn(params, token, pos, cache):
        return M.decode_step(cfg, params, token, pos, cache)

    return prefill_fn, decode_fn
