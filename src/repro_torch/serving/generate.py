"""Greedy generation: prefill a batch of prompts, then decode token by token.

The counterpart of the reference's ``examples/serve_ciao.py``
``real_model_decode`` loop, as a function.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH
from repro_torch.train.train_step import batch_logical_specs


def generate(cfg, params, prompts, max_new_tokens: int, *, frontend=None, device=None,
             kv_dtype=torch.bfloat16, env=None):
    """Greedy decode of ``max_new_tokens`` steps after the prompts (B, S).

    ``frontend``: the frontend's inputs, passed to ``prefill`` beside the
    tokens: ``{"src_embeds": (B, S_src, d)}`` for an encoder-decoder,
    ``{"patch_embeds": (B, P, d)}`` for a vision frontend (the cache then
    holds the P prefix positions too). tokens[:, 0] is the greedy pick from
    the prompt; decode step i feeds tokens[:, i] at position P+S+i and
    returns logits[:, i], whose argmax is tokens[:, i+1]. Returns (tokens
    (B, n) int64, logits (B, n, V)) on the device, n = max_new_tokens. Runs
    on the card unless ``device="cpu"``; ``params`` must already live on
    that device.

    ``env``: the decode steps' ``ShardEnv`` (the decode or long-decode
    rules) on a DeviceMesh, with ``params`` placed by ``param_specs``. The
    prompts and frontend inputs are placed by the prefill batch's specs;
    the prefill runs under ``phase_env(env, "prefill")``, the cache is
    placed under ``env``, and tokens and logits come back as DTensors.
    """
    dev = resolve_device(device)
    batch = {name: torch.as_tensor(t, device=dev) for name, t in (frontend or {}).items()}
    batch["tokens"] = torch.as_tensor(prompts, device=dev)
    prefill_env = SH.phase_env(env, "prefill")
    if SH.on_devices(env):
        batch = SH.distribute_tree(batch, SH.tree_shardings(
            prefill_env, {k: batch_logical_specs(cfg, "prefill")[k] for k in batch}, batch))
    logits, cache, pos = M.prefill(cfg, params, batch,
                                   max_len=M.prompt_len(batch) + max_new_tokens,
                                   kv_dtype=kv_dtype, env=prefill_env, cache_env=env)
    tok = greedy(logits)
    tokens, step_logits = [], []
    for i in range(max_new_tokens):
        tokens.append(tok)
        logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache, env=env)
        step_logits.append(logits)
        tok = greedy(logits)
    return torch.cat(tokens, dim=1), torch.stack(step_logits, dim=1)


def greedy(logits):
    """The argmax over the vocab of (B, V) logits, as (B, 1); on a mesh the
    vocab is gathered first, so each rank picks from all of it."""
    if isinstance(logits, DTensor):
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p == Shard(1) else p for p in logits.placements])
    return logits.argmax(dim=-1)[:, None]
