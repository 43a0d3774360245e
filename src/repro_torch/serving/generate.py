"""Greedy generation: prefill a batch of prompts, then decode token by token.

The counterpart of the reference's ``examples/serve_ciao.py``
``real_model_decode`` loop, as a function.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import check_serving_env


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
    that device. ``env``: a mesh of one device; a larger one raises
    (serving over a mesh is ROADMAP item 12).
    """
    check_serving_env(env)
    dev = resolve_device(device)
    batch = {name: torch.as_tensor(t, device=dev) for name, t in (frontend or {}).items()}
    batch["tokens"] = torch.as_tensor(prompts, device=dev)
    logits, cache, pos = M.prefill(cfg, params, batch,
                                   max_len=M.prompt_len(batch) + max_new_tokens,
                                   kv_dtype=kv_dtype, env=env)
    tok = logits.argmax(dim=-1)[:, None]
    tokens, step_logits = [], []
    for i in range(max_new_tokens):
        tokens.append(tok)
        logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache, env=env)
        step_logits.append(logits)
        tok = logits.argmax(dim=-1)[:, None]
    return torch.cat(tokens, dim=1), torch.stack(step_logits, dim=1)
