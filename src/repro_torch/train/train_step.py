"""The train step and the serve steps (the reference's
``train/train_step.py``), with their sharding specs.

``make_train_step(cfg, run, env=None)`` returns ``step(state, batch) ->
(state, metrics)``: the loss and its gradients (accumulated over
``grad_accum`` microbatches as the reference's scan does: loss/n and
gradient/n summed in f32), clip by the global norm, the lr at the step
before it is counted, the optimizer, and each parameter updated as the
reference does: its update, rounded to the parameter's dtype, added in f32
and rounded again. The state ``{"params", "opt", "step"}`` (and ``err``
with gradient compression) is updated in place, the counterpart of the
reference's donated buffers; metrics ``loss``, ``grad_norm`` and ``lr`` are
0-d f32 tensors on the device (read one to wait for the step).

With an ``env`` whose mesh is a DeviceMesh and a state and batch placed by
``parallel.sharding.tree_shardings`` (DTensors), the same step runs
sharded: the model's constraints redistribute the activations, DTensor
turns the products into collectives, and each gradient comes back in its
parameter's placements. With ``gradient_compression="int8"`` on a mesh with
``pod`` > 1, each pod takes the loss and gradients of its slice of the
batch on the mesh without ``pod``, and the pods exchange them in int8 with
error feedback (``parallel.compression``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import reference_leaf
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel import compression as C
from repro_torch.parallel.sharding import contiguous_stride, placed_like, spec_map
from repro_torch.train import optim as O
from repro_torch.train.tree import flatten_with_paths, tree_leaves, tree_map


def loss_and_grads(cfg, run, params, batch, env=None):
    """(loss, gradients in the parameters' dtype; zeros for a parameter the
    loss does not read, such as a parallel block's ``ln2``). ``params`` are
    read, not changed."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with _sharded(params):
        loss = M.loss_fn(cfg, tree_map(lambda _: next(it), params), batch, run, env)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else placed_like(g, p)
              for g, p in zip(grads, leaves))
    loss = loss.detach()
    if isinstance(loss, DTensor):
        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    return loss, tree_map(lambda _: next(it), params)


def _sharded(params):
    """Plain tensors among DTensors (RoPE's frequencies, positions, masks)
    count as replicated while a sharded step runs."""
    if isinstance(tree_leaves(params)[0], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


def optimizer_groups(cfg: ModelConfig, params):
    """Each parameter leaf's leaf in the reference's tree, which stacks a
    pattern position's layers (``convert.reference_leaf``): the groups an
    optimizer that couples elements within a leaf (Adafactor) updates as
    one."""
    return [reference_leaf(cfg, path) for path in flatten_with_paths(params)]


# ------------------------------------------------------------------- specs
def batch_logical_specs(cfg: ModelConfig, mode: str) -> Dict[str, Any]:
    """The logical axes of a batch's leaves (the reference's)."""
    if mode == "decode":
        return {"token": ("act_batch", None), "pos": ("act_batch",),
                "cache": M.cache_specs(cfg)}
    sp: Dict[str, Any] = {"tokens": ("act_batch", None)}
    if mode == "train":
        sp["targets"] = ("act_batch", None)
    if cfg.frontend == "vision":
        sp["patch_embeds"] = ("act_batch", None, None)
    if cfg.is_encoder_decoder:
        sp["src_embeds"] = ("act_batch", None, None)
    return sp


def state_logical_specs(cfg: ModelConfig, run: RunConfig):
    """The train state's logical axes: the parameters', the optimizer
    state's (``optim.opt_specs``), the step's, and with gradient
    compression the error feedback's, ``("pod_stack",) + spec``."""
    p_specs = M.param_specs(cfg)
    struct = M.param_shapes(cfg, run)
    state = {"params": p_specs,
             "opt": O.opt_specs(cfg.optimizer, p_specs, struct, optimizer_groups(cfg, struct)),
             "step": ()}
    if run.gradient_compression:
        state["err"] = spec_map(lambda sp: ("pod_stack",) + sp, p_specs)
    return state


def make_train_step(cfg: ModelConfig, run: RunConfig, env=None):
    if run.gradient_compression not in ("", "int8"):
        raise ValueError(f"unknown gradient_compression {run.gradient_compression!r}")
    _, opt_update = O.make_optimizer(cfg.optimizer)
    npod = env.axis_size("pod") if env is not None else 1
    use_pod_compress = run.gradient_compression == "int8" and npod > 1

    def grads_of(params, batch, env_):
        n = run.grad_accum
        if n <= 1:
            return loss_and_grads(cfg, run, params, batch, env_)
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches")
        loss = 0.0
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for i in range(n):
            micro = {k: x[i * rows // n:(i + 1) * rows // n] for k, x in batch.items()}
            loss_i, g = loss_and_grads(cfg, run, params, micro, env_)
            loss = loss + loss_i / n
            tree_map(lambda a, b: a.add_(b / n), grads, g)
            del g
        return loss, grads

    def train_step(state, batch):
        params, step = state["params"], state["step"]
        with _sharded(params):
            if use_pod_compress:
                loss, grads, new_err = pod_compressed_grads(cfg, run, env, state, batch)
                with torch.no_grad():
                    tree_map(lambda e, n: e.copy_(n), state["err"], new_err)
                del new_err
            else:
                loss, grads = grads_of(params, batch, env)
            with torch.no_grad():
                grads, gnorm = O.clip_by_global_norm(grads, run.max_grad_norm)
                lr = O.lr_schedule(step, base_lr=run.learning_rate, warmup=run.warmup_steps)
                updates = opt_update(grads, state["opt"], params, lr=lr, b1=run.adam_b1,
                                     b2=run.adam_b2, weight_decay=run.weight_decay,
                                     groups=optimizer_groups(cfg, params))
                del grads
                O.apply_updates(params, updates)
                step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def pod_compressed_grads(cfg, run, env, state, batch):
    """Each pod's loss and gradients on its slice of the batch, taken on
    the mesh without ``pod``; their mean loss, and the int8 exchange of the
    gradients with the error feedback (the reference's vmap of
    ``value_and_grad`` over a ``(npod, B/npod, ...)`` batch, which takes no
    microbatches). Returns (loss, mean gradients placed as the parameters,
    new err)."""
    mesh = env.mesh
    pod = mesh.mesh_dim_names.index("pod")
    if any(x.placements[pod] != Shard(0) for x in batch.values()):
        raise ValueError("the batch must split over pod on its first dimension "
                         "(batch_logical_specs, with a batch the pods divide)")
    inner = tuple(n for n in mesh.mesh_dim_names if n != "pod")
    env_pod = dataclasses.replace(env.without_axes("pod"), mesh=mesh[inner])
    params_p = tree_map(lambda p: _pod_view(p, env_pod.mesh), state["params"])
    batch_p = {k: _pod_view(x, env_pod.mesh) for k, x in batch.items()}
    with _sharded(params_p):
        loss_p, grads_p = loss_and_grads(cfg, run, params_p, batch_p, env_pod)
        loss = _pod_stack(loss_p, mesh).mean()
        grads_p = tree_map(lambda g: _pod_stack(g, mesh), grads_p)
        grads, new_err = C.pod_mean_compressed(grads_p, state["err"],
                                               optimizer_groups(cfg, state["params"]))
        return loss, tree_map(placed_like, grads, state["params"]), new_err


def _pod_view(x, pod_mesh):
    """A DTensor on a mesh with ``pod`` seen by each pod on its own mesh
    (``pod_mesh``, the others): the same local shard, the pod dimension's
    placement dropped; a dimension split over ``pod`` keeps the pod's
    slice of it."""
    names = list(x.device_mesh.mesh_dim_names)
    i = names.index("pod")
    pods = x.device_mesh.shape[i]
    shape = list(x.shape)
    if x.placements[i].is_shard():
        shape[x.placements[i].dim] //= pods
    placements = x.placements[:i] + x.placements[i + 1:]
    return DTensor.from_local(x.to_local(), pod_mesh, placements, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _pod_stack(x, mesh):
    """Each pod's DTensor ``x`` (on the mesh without ``pod``) as one DTensor
    on ``mesh`` with a leading pod dimension split over ``pod``."""
    i = mesh.mesh_dim_names.index("pod")
    inner = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
    placements = inner[:i] + [Shard(0)] + inner[i:]
    shape = (mesh.shape[i],) + tuple(x.shape)
    return DTensor.from_local(x.to_local().unsqueeze(0), mesh, placements,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def init_train_state(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                     device=None, npod: int = 1):
    """{"params": ``init_params`` in ``run.param_dtype``, "opt": the
    optimizer's zeroed state, "step": 0 (int32)}, and with gradient
    compression "err": ``npod`` zeroed error-feedback copies of the
    parameters in f32; on the card unless ``device="cpu"`` (``"meta"``:
    shapes and dtypes only, for ``restore``); ``generator`` lives on that
    device."""
    dev = resolve_device(device)
    params = M.init_params(cfg, generator, dev, getattr(torch, run.param_dtype))
    opt_init, _ = O.make_optimizer(cfg.optimizer)
    state = {"params": params, "opt": opt_init(params, optimizer_groups(cfg, params)),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if run.gradient_compression:
        state["err"] = C.init_error_feedback(params, npod)
    return state


def train_state_struct(cfg: ModelConfig, run: RunConfig, npod: int = 1):
    """The train state's shapes and dtypes on the meta device (no storage)."""
    return init_train_state(cfg, run, torch.Generator(), "meta", npod)


def make_serve_steps(cfg: ModelConfig, run: RunConfig, env=None):
    """(prefill_fn(params, batch, max_len=0), decode_fn(params, token, pos,
    cache)) over ``model.prefill`` and ``model.decode_step``, each under
    ``env`` (a prefill cell's or a decode cell's rules on a mesh; the
    prefill's cache is placed under ``phase_env(env, "decode")``)."""
    def prefill_fn(params, batch, max_len: int = 0):
        return M.prefill(cfg, params, batch, max_len=max_len, env=env)

    def decode_fn(params, token, pos, cache):
        return M.decode_step(cfg, params, token, pos, cache, env=env)

    return prefill_fn, decode_fn
