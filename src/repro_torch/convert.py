"""Convert the reference's parameter tree (as numpy arrays) to the port's.

The reference stacks each position of its block pattern along a leading
layer axis (``stack/b{i}`` of shape (repeats, ...)) and keeps remainder
layers in ``rem``. Layer ``r*len(pattern)+i`` of the port is
``stack/b{i}[r]``; remainder layer ``i`` follows the stack. An
encoder-decoder's encoder stacks its layers along ``encoder/stack``
directly (no ``b{i}`` level): encoder layer ``r`` is ``encoder/stack[r]``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_torch(a) -> torch.Tensor:
    """A copy of a numpy array (bf16 from ml_dtypes included) as a CPU
    torch tensor."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(tree, r=None):
    """A sub-tree as torch tensors; layer ``r`` of it when it is stacked."""
    return {k: _tree(v, r) if isinstance(v, dict) else to_torch(v if r is None else v[r])
            for k, v in tree.items()}


def params_from_jax(np_tree, cfg: ModelConfig) -> Dict[str, Any]:
    """``np_tree``: the reference's ``init_params`` output with every leaf
    turned into a numpy array. Returns the port's parameter dictionary, on
    the CPU; a block keeps the reference's keys (ln1, attn with its qk-norm
    scales and biases, ln2, mlp, moe: its stacked leaves (repeats, E, ...)
    become (E, ...) a layer; rglru and ssd with their nested conv {w, b};
    an encoder-decoder's ln_cross and cross), an untied head its
    ``lm_head`` and an encoder-decoder its ``encoder``."""
    stack = np_tree.get("stack", {})
    layers = [_tree(stack[f"b{i}"], r)
              for r in range(cfg.scan_repeats) for i in range(len(cfg.pattern))]
    layers += [_tree(rem) for rem in np_tree.get("rem", ())]
    out = {"embed": _tree(np_tree["embed"]), "layers": layers,
           "final_norm": _tree(np_tree["final_norm"])}
    if "lm_head" in np_tree:
        out["lm_head"] = _tree(np_tree["lm_head"])
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        out["encoder"] = {"layers": [_tree(enc["stack"], r)
                                     for r in range(cfg.num_encoder_layers)],
                          "final_norm": _tree(enc["final_norm"])}
    return out


def reference_leaf(cfg: ModelConfig, path: str) -> str:
    """The leaf of the reference's parameter tree that holds the port's
    leaf at ``path`` ("layers/5/attn/wq"): "stack/b{i}/..." for a layer of
    the scanned stack (the reference stacks every repeat of pattern
    position i into one leaf), "rem/{i}/..." for a remainder layer,
    "encoder/stack/..." for an encoder layer; other paths are the same in
    both."""
    parts = path.split("/")
    if parts[0] == "layers":
        j, stacked = int(parts[1]), cfg.scan_repeats * len(cfg.pattern)
        head = [f"stack/b{j % len(cfg.pattern)}"] if j < stacked else [f"rem/{j - stacked}"]
        return "/".join(head + parts[2:])
    if parts[:2] == ["encoder", "layers"]:
        return "/".join(["encoder", "stack"] + parts[3:])
    return path
