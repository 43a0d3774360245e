"""AdamW and Adafactor, clip-by-global-norm and the lr schedule: the
reference's ``train/optim.py`` on the port's parameter trees.

The reference's arithmetic, step for step: moments and updates in f32,
each update rounded to its parameter's dtype before the step adds it
(``train_step``). Not ``torch.optim.AdamW``, whose rounding differs. The
state is updated in place (the counterpart of the reference's donated
buffers); ``*_update`` returns the updates. Scalars (the lr, the step
count) are 0-d tensors on the parameters' device, so a step never waits on
the host. Adafactor keeps factored second moments (a row and a column
vector an (…, R, C) leaf) and no momentum. Its state couples elements
within a leaf (the factored moments, the update's RMS clip), and the
reference stacks the layers of a pattern position into one leaf: so
Adafactor takes ``groups``, a key a parameter leaf, and updates each
group's leaves stacked as the reference's one leaf (``train_step`` groups
them as the reference stacks them, ``convert.reference_leaf``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.train.tree import flatten_with_paths, tree_leaves, tree_map


def lr_schedule(step, *, base_lr: float, warmup: int, total: int = 100_000):
    """Linear warmup over ``warmup`` steps, then a cosine from 1 to 0.1 of
    ``base_lr`` by ``total``; f32, from the 0-d ``step`` tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base_lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares, in f32."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(the leaves in f32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda x: x.float() * scale, tree), norm


def _count_up(state):
    state["count"] += 1
    return state["count"].float()


# ------------------------------------------------------------------ AdamW
def adamw_init(params, groups=None):
    """{"m", "v": f32 zeros in the parameters' tree, "count"}. ``groups``
    is unused: AdamW couples no elements."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 groups=None):
    """Updates m and v in place; returns the updates, each in its
    parameter's dtype. ``groups`` is unused: AdamW couples no elements."""
    c = _count_up(state)
    bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c

    def upd(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.float()
        return (-lr * u).to(p.dtype)

    return tree_map(upd, grads, state["m"], state["v"], params)


# -------------------------------------------------------------- Adafactor
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _groups(params, groups):
    """{group key: indices of its leaves in ``tree_leaves`` order}; each
    leaf under its own path when ``groups`` is None."""
    keys = list(flatten_with_paths(params)) if groups is None else groups
    out: dict = {}
    for i, key in enumerate(keys):
        out.setdefault(key, []).append(i)
    return out


def _stack(ts):
    """A group's tensors stacked along a new first axis; one tensor alone
    as it is."""
    return ts[0] if len(ts) == 1 else torch.stack(ts)


def adafactor_init(params, groups=None):
    """{"v": {group key: {"r", "c"} for a factored stack, else {"v"}},
    "count"}. A group's leaves are stacked along a new first axis, as the
    reference stacks a pattern position's layers into one leaf, so its
    state has the reference's shapes (a stack of vectors (L, d) is factored
    too); a group of one leaf keeps the leaf's shape (where the reference
    stacks one layer, (1, ...), the same moments without the leading 1)."""
    leaves = tree_leaves(params)
    state = {}
    for key, idx in _groups(params, groups).items():
        shape = ((len(idx),) if len(idx) > 1 else ()) + tuple(leaves[idx[0]].shape)
        f32 = dict(dtype=torch.float32, device=leaves[idx[0]].device)
        state[key] = ({"r": torch.zeros(shape[:-1], **f32),
                       "c": torch.zeros(shape[:-2] + shape[-1:], **f32)}
                      if _factored(shape) else {"v": torch.zeros(shape, **f32)})
    return {"v": state, "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def adafactor_update(grads, state, params, *, lr, eps=1e-30, weight_decay=0.0,
                     clip_threshold=1.0, groups=None, **_):
    """Updates the second-moment state in place; returns the updates, each
    in its parameter's dtype. ``groups`` as ``adafactor_init`` had them:
    each group's gradients are stacked and updated as one leaf (the
    factored moments and the update's RMS clip span the stack)."""
    beta2 = 1.0 - _count_up(state) ** -0.8
    g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
    updates = [None] * len(p_leaves)
    for key, idx in _groups(params, groups).items():
        v = state["v"][key]
        g = _stack([g_leaves[i].float() for i in idx])
        g2 = g * g + eps
        if "r" in v:
            r = v["r"].copy_(beta2 * v["r"] + (1 - beta2) * g2.mean(dim=-1))
            c = v["c"].copy_(beta2 * v["c"] + (1 - beta2) * g2.mean(dim=-2))
            denom = torch.clamp_min(r.mean(dim=-1, keepdim=True), eps)
            vhat = (r / denom)[..., None] * c[..., None, :]
        else:
            vhat = v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
        del g2
        u = g * torch.rsqrt(vhat + eps)
        rms_u = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
        for i, u_i in zip(idx, [u] if len(idx) == 1 else u.unbind(0)):
            p = p_leaves[i]
            updates[i] = (-lr * (u_i + weight_decay * p.float())).to(p.dtype)
    it = iter(updates)
    return tree_map(lambda _: next(it), params)


def make_optimizer(name: str):
    """(init, update) of "adamw" or "adafactor"."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
