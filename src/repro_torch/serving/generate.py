"""Greedy generation: prefill a batch of prompts, then decode token by token.

The counterpart of the reference's ``examples/serve_ciao.py``
``real_model_decode`` loop, as a function.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M


def generate(cfg, params, prompts, max_new_tokens: int, *, device=None,
             kv_dtype=torch.bfloat16):
    """Greedy decode of ``max_new_tokens`` steps after the prompts (B, S).

    tokens[:, 0] is the greedy pick from the prompt; decode step i feeds
    tokens[:, i] at position S+i and returns logits[:, i], whose argmax is
    tokens[:, i+1]. Returns (tokens (B, n) int64, logits (B, n, V)) on the
    device, n = max_new_tokens. Runs on the card unless ``device="cpu"``;
    ``params`` must already live on that device.
    """
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    s = prompts.shape[1]
    logits, cache, pos = M.prefill(cfg, params, {"tokens": prompts},
                                   max_len=s + max_new_tokens, kv_dtype=kv_dtype)
    tok = logits.argmax(dim=-1)[:, None]
    tokens, step_logits = [], []
    for i in range(max_new_tokens):
        tokens.append(tok)
        logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
        step_logits.append(logits)
        tok = logits.argmax(dim=-1)[:, None]
    return torch.cat(tokens, dim=1), torch.stack(step_logits, dim=1)
