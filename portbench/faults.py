"""Faults planted in the timed path, each of which the check has to catch:
the CPU tests (``tests/test_portbench_faults.py``) plant them at a small
size, ``calibrate.py --fault <name>`` at the cell's own size on the card.

Each fault is a function of ``setattr(target, name, value)`` (pytest's
``monkeypatch.setattr``, or the builtin for a whole process) that replaces
one attribute the program calls through:

* ``state_unchanged``: the prefill leaves the cache as it found it (the
  one decode step reads it; nothing reads the step's own cache);
* ``half_batch``: half of the batch left out, the other half served twice;
* ``token_altered``: every greedy token altered where it is produced;
* ``one_row_cache``: one row's cache holds another row's keys and values
  (one slot of a batch wrong);
* ``one_row_token``: one row's greedy token altered where it is produced.
"""
from __future__ import annotations

import importlib


def _generate():
    return importlib.import_module("repro_torch.serving.generate")


def state_unchanged(setattr):
    import repro_torch.models.attention as A
    setattr(A, "write_full_cache", lambda ck, cv, k, v: (ck, cv))


def half_batch(setattr):
    import torch
    G = _generate()
    real = G.generate

    def half(cfg, params, prompts, n, **kw):
        b = prompts.shape[0]
        tokens, logits = real(cfg, params, prompts[:b // 2], n, **kw)
        rest = b - b // 2
        return torch.cat([tokens, tokens[:rest]]), torch.cat([logits, logits[:rest]])

    setattr(G, "generate", half)


def token_altered(setattr):
    G = _generate()
    real = G.greedy
    setattr(G, "greedy", lambda logits: (real(logits) + 1) % logits.shape[-1])


def one_row_cache(setattr):
    import repro_torch.models.attention as A
    real = A.write_full_cache

    def write(ck, cv, k, v):
        ck, cv = real(ck, cv, k, v)
        ck[0], cv[0] = ck[1].clone(), cv[1].clone()
        return ck, cv

    setattr(A, "write_full_cache", write)


def one_row_token(setattr):
    G = _generate()
    real = G.greedy

    def greedy(logits):
        tok = real(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    setattr(G, "greedy", greedy)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, token_altered, one_row_cache,
                                  one_row_token)}
