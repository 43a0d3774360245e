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

In a sharded step (DTensors placed alike for a parameter, its gradient and
its moments) clip, AdamW and the update run on each rank's shards, which
are element-wise; the global norm sums the shards' squares over the mesh.
Adafactor runs on the shards too; its factored moments' means and its
RMS clip sum the shards over the mesh dimensions that split them.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.parallel.sharding import placed_like
from repro_torch.train.tree import flatten_with_paths, tree_leaves, tree_map


def lr_schedule(step, *, base_lr: float, warmup: int, total: int = 100_000):
    """Linear warmup over ``warmup`` steps, then a cosine from 1 to 0.1 of
    ``base_lr`` by ``total``; f32, from the 0-d ``step`` tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return base_lr * warm * (0.1 + 0.9 * cos)


def _local(x):
    """A DTensor's shard on this rank (a plain tensor as it is): the
    element-wise work of a step runs on the shards, whose placements the
    parameter, its gradient and its moments share."""
    return x.to_local() if isinstance(x, DTensor) else x


def _like(local, p):
    """``local`` as a shard of a DTensor placed as ``p`` (a plain ``p``:
    ``local`` itself)."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements, shape=p.shape,
                              stride=p.stride())


def _square_sum(x):
    """The sum of x's squares in f32; of a DTensor, its shard's, partial
    over the mesh dimensions that split it."""
    sq = _local(x).float().square().sum()
    if not isinstance(x, DTensor):
        return sq
    return DTensor.from_local(sq, x.device_mesh, [Partial() if p.is_shard() else Replicate()
                                                  for p in x.placements])


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares, in f32. DTensor leaves
    are summed locally by their placements, and each group's sum is
    all-reduced once, so the reductions do not depend on how DTensor would
    add sums pending over different mesh dimensions."""
    groups: dict = {}
    for x in tree_leaves(tree):
        sq = _square_sum(x)
        key = (sq.device_mesh, tuple(sq.placements)) if isinstance(sq, DTensor) else None
        groups[key] = groups.get(key, 0.0) + (_local(sq) if key is not None else sq)
    total = 0.0
    for key, local in groups.items():
        if key is None:
            total = total + local
            continue
        mesh, placements = key
        total = total + DTensor.from_local(local, mesh, placements).redistribute(
            mesh, [Replicate()] * mesh.ndim)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(the leaves in f32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(tree)
    if isinstance(norm, DTensor):
        norm = norm.redistribute(norm.device_mesh, [Replicate()] * norm.device_mesh.ndim)
    scale = _local(torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0))
    return tree_map(lambda x: _like(_local(x).float() * scale, x), tree), norm


def apply_updates(params, updates) -> None:
    """Each parameter plus its update, added in f32 and rounded to the
    parameter's dtype, in place."""
    tree_map(lambda p, u: _local(p).copy_(_local(p).float() + _local(placed_like(u, p)).float()),
             params, updates)


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
    c = _local(_count_up(state))
    bc1, bc2, lr = 1.0 - b1 ** c, 1.0 - b2 ** c, _local(lr)

    def upd(g, m, v, p):
        g, m, v, p_l = _local(g).float(), _local(m), _local(v), _local(p)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p_l.float()
        return _like((-lr * u).to(p.dtype), p)

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


def _split_dims(p, lead: int):
    """{dimension of ``p`` stacked behind ``lead`` new dimensions: the mesh
    dimensions (of more than one device) that split it}; empty for a plain
    tensor."""
    if not isinstance(p, DTensor):
        return {}
    out: dict = {}
    for i, (pl, n) in enumerate(zip(p.placements, p.device_mesh.shape)):
        if pl.is_shard() and n > 1:
            out.setdefault(pl.dim + lead, []).append(i)
    return out


def _sum_over(x, mesh, mesh_dims):
    """``x`` (a shard's partial sum) summed over ``mesh_dims``, in place."""
    for i in mesh_dims:
        dist.all_reduce(x, group=mesh.get_group(i))
    return x


def _mean(x, dim, split, mesh, keepdim=False):
    """``x.mean(dim)`` of a stacked group's shard: where ``dim`` is split
    over mesh dimensions, the shards' sums summed over them, over the whole
    dimension's length."""
    d = dim % x.dim()
    if d not in split:
        return x.mean(dim=dim, keepdim=keepdim)
    ways = math.prod(mesh.shape[i] for i in split[d])
    return _sum_over(x.sum(dim=d, keepdim=keepdim), mesh, split[d]) / (x.shape[d] * ways)


def adafactor_update(grads, state, params, *, lr, eps=1e-30, weight_decay=0.0,
                     clip_threshold=1.0, groups=None, **_):
    """Updates the second-moment state in place; returns the updates, each
    in its parameter's dtype. ``groups`` as ``adafactor_init`` had them:
    each group's gradients are stacked and updated as one leaf (the
    factored moments and the update's RMS clip span the stack). On
    DTensors (placed alike within a group) it runs on the shards, the
    means over split dimensions summed across the mesh."""
    beta2, lr = 1.0 - _local(_count_up(state)) ** -0.8, _local(lr)
    g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
    updates = [None] * len(p_leaves)
    for key, idx in _groups(params, groups).items():
        v = {k: _local(t) for k, t in state["v"][key].items()}
        p0 = p_leaves[idx[0]]
        split = _split_dims(p0, 1 if len(idx) > 1 else 0)
        mesh = p0.device_mesh if split else None
        g = _stack([_local(placed_like(g_leaves[i], p_leaves[i])).float() for i in idx])
        g2 = g * g + eps
        if "r" in v:
            r = v["r"].copy_(beta2 * v["r"] + (1 - beta2) * _mean(g2, -1, split, mesh))
            c = v["c"].copy_(beta2 * v["c"] + (1 - beta2) * _mean(g2, -2, split, mesh))
            r_split = {d: m for d, m in split.items() if d < g.dim() - 1}
            denom = torch.clamp_min(_mean(r, -1, r_split, mesh, keepdim=True), eps)
            vhat = (r / denom)[..., None] * c[..., None, :]
        else:
            vhat = v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
        del g2
        u = g * torch.rsqrt(vhat + eps)
        if split:
            sq = _sum_over(u.square().sum(), mesh, sorted({i for m in split.values() for i in m}))
            rms_u = torch.sqrt(sq / math.prod(_global_shape(p0, len(idx))) + 1e-12)
        else:
            rms_u = torch.sqrt(u.square().mean() + 1e-12)
        u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
        for i, u_i in zip(idx, [u] if len(idx) == 1 else u.unbind(0)):
            p = p_leaves[i]
            updates[i] = _like((-lr * (u_i + weight_decay * _local(p).float())).to(p.dtype), p)
    it = iter(updates)
    return tree_map(lambda _: next(it), params)


def _global_shape(p, members: int):
    return ((members,) if members > 1 else ()) + tuple(p.shape)


def opt_specs(name: str, p_specs, params=None, groups=None):
    """The optimizer state's logical specs from the parameters' (the
    reference's ``opt_specs``). AdamW's moments take their parameter's spec.
    Adafactor's state is keyed by group as ``adafactor_init`` builds it from
    ``params`` (meta tensors will do) and ``groups``: a stacked group's spec
    gains the reference's leading "layers", its factors drop the last
    dimension (``r``) or the one before (``c``)."""
    from repro_torch.parallel.sharding import spec_map
    if name == "adamw":
        return {"m": p_specs, "v": p_specs, "count": ()}
    if name != "adafactor":
        raise ValueError(name)
    leaves, flat = tree_leaves(params), []
    spec_map(flat.append, p_specs)
    out = {}
    for key, idx in _groups(params, groups).items():
        spec = (("layers",) if len(idx) > 1 else ()) + flat[idx[0]]
        shape = ((len(idx),) if len(idx) > 1 else ()) + tuple(leaves[idx[0]].shape)
        out[key] = ({"r": spec[:-1], "c": spec[:-2] + spec[-1:]} if _factored(shape)
                    else {"v": spec})
    return {"v": out, "count": ()}


def make_optimizer(name: str):
    """(init, update) of "adamw" or "adafactor"."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
