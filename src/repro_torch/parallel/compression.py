"""Cross-pod gradient compression with error feedback (the reference's
``parallel/compression.py``).

On a multi-pod mesh the ``pod`` axis rides the slowest links, so only that
hop is compressed:

  1. the batch is split ``(npod, B/npod, ...)`` and each pod takes its own
     gradients (the train step: the per-pod loss runs on the mesh without
     ``pod``); the intra-pod reductions over data/model stay in f32;
  2. each pod quantizes its gradient (plus the error-feedback residual of
     the previous step) to **int8 + one f32 scale**;
  3. the int8 codes and the scales are all-gathered over ``pod`` (a
     DTensor redistribution of the pod-stacked codes: int8 on the wire);
  4. every pod dequantizes and averages; the quantization residual is
     carried in the error-feedback accumulator (EF-SGD, Seide et al.), so
     the compression is unbiased over time.

The arithmetic is the reference's: scale = max|x| / 127 + 1e-30, codes
rounded half to even (``torch.round``, as ``jnp.round``) and clipped to
±127.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.train.tree import tree_leaves, tree_map


def quantize_int8(x, axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 scale): one scale for the tensor, or one a slice
    when ``axes`` (the reduced dimensions) is given."""
    if axes is None:
        scale = x.abs().max() / 127.0 + 1e-30
    else:
        scale = torch.amax(x.abs(), dim=axes, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def _over_pods(t):
    """``t`` (pod-stacked) replicated over the mesh's ``pod`` dimension, its
    other placements kept: an all-gather over ``pod`` in ``t``'s dtype. A
    plain tensor (one device) holds every pod already."""
    if not isinstance(t, DTensor) or "pod" not in t.device_mesh.mesh_dim_names:
        return t
    placements = list(t.placements)
    placements[t.device_mesh.mesh_dim_names.index("pod")] = Replicate()
    return t.redistribute(t.device_mesh, placements)


def _one(g, e):
    g = g.float() + e
    q, scale = quantize_int8(g, axes=tuple(range(1, g.dim())))
    new_e = g - dequantize_int8(q, scale)
    return dequantize_int8(_over_pods(q), _over_pods(scale)).mean(dim=0), new_e


def pod_mean_compressed(grads_p, err, groups=None):
    """Mean per-pod gradients over ``pod`` in int8 with error feedback.

    grads_p, err: trees whose leaves carry a leading ``npod`` dimension,
    either plain tensors (every pod on one device) or DTensors sharded over
    the ``pod`` mesh axis on that dimension (their other placements are the
    intra-pod shards, kept through the exchange). ``groups`` (a key a leaf,
    as ``train_step.optimizer_groups`` gives them) stacks each group's
    leaves after the pod dimension before quantizing, as the reference
    stacks a pattern position's layers into one leaf: each pod then has one
    scale a group, the reference's. Returns (mean gradients, new err)."""
    g_leaves, e_leaves = tree_leaves(grads_p), tree_leaves(err)
    keys = range(len(g_leaves)) if groups is None else groups
    members: dict = {}
    for i, key in enumerate(keys):
        members.setdefault(key, []).append(i)
    means, errs = [None] * len(g_leaves), [None] * len(g_leaves)
    for idx in members.values():
        if len(idx) == 1:
            means[idx[0]], errs[idx[0]] = _one(g_leaves[idx[0]], e_leaves[idx[0]])
            continue
        mean, new_e = _one(torch.stack([g_leaves[i] for i in idx], dim=1),
                           torch.stack([e_leaves[i] for i in idx], dim=1))
        for i, m, e in zip(idx, mean.unbind(0), new_e.unbind(1)):
            means[i], errs[i] = m, e
    it_m, it_e = iter(means), iter(errs)
    return tree_map(lambda _: next(it_m), grads_p), tree_map(lambda _: next(it_e), grads_p)


def init_error_feedback(params, npod: int = 1):
    return tree_map(lambda p: torch.zeros((npod,) + tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)
