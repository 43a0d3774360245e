"""Serving demo on the PyTorch port: (1) real-model continuous decode with
a paged cache, the prefill through K3 and each step through K2 on the card,
(2) CIAO vs baselines on the serving cost model under pool pressure
(``examples/serve_ciao.py`` without JAX).

    PYTHONPATH=src python examples/torch_serve_ciao.py              # on the card
    PYTHONPATH=src python examples/torch_serve_ciao.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (PoolConfig, ServeConfig, ServeEngine,
                                 synth_requests)

POLICIES = ("gto", "ccws", "statpcal", "ciao-p", "ciao-t", "ciao-c")


def real_model_decode(device=None, params=None, prompts=None):
    """Prefill 4 prompts of 10 tokens into a 32-slot cache and decode 10
    greedy steps. ``params`` default to ``init_params`` (f32) drawn from a
    generator seeded 0, ``prompts`` to tokens drawn from one seeded 1, both
    on ``device`` (the card unless ``"cpu"``). Returns (per-sequence
    tokens, the steps' logits (B, 10, V) on the CPU)."""
    print("== real-model batched decode (tiny gemma2-family) ==")
    dev = resolve_device(device)
    cfg = reduced_config("gemma2-2b")
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev, torch.float32)
    B = 4
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (B, 10), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(1))
    prompts = torch.as_tensor(prompts, device=dev)
    with torch.no_grad():
        logits, cache, pos = M.prefill(cfg, params, {"tokens": prompts},
                                       max_len=32)
        tok = logits.argmax(-1)[:, None]
        outs = [[] for _ in range(B)]
        steps = []
        for i in range(10):
            for b in range(B):
                outs[b].append(int(tok[b, 0]))
            logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
            steps.append(logits.float().cpu())
            tok = logits.argmax(-1)[:, None]
    for b in range(B):
        print(f"  seq{b}: {outs[b]}")
    return outs, torch.stack(steps, 1)


def ciao_policy_comparison():
    """The cost model under KV-pool pressure, one row a policy: returns
    {policy: ServeStats}."""
    print("\n== CIAO vs baselines under KV-pool pressure ==")
    reqs = synth_requests(256, groups=10, prefix_pages=24,
                          decode_tokens=128, heavy_frac=0.25,
                          heavy_decode=1000)
    print(f"{'policy':10s} {'tok/unit':>9s} {'preempt':>8s} "
          f"{'refetch':>8s} {'goodput':>8s}")
    table = {}
    for pol in POLICIES:
        cfg = ServeConfig(policy=pol, groups=10,
                          pool=PoolConfig(main_pages=640,
                                          reserve_pages=192))
        st = table[pol] = ServeEngine(cfg).run(list(reqs))
        print(f"{pol:10s} {st.tokens_per_unit:9.3f} {st.preemptions:8d} "
              f"{st.refetched_pages:8d} {st.goodput:8.1f}")
    return table


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    real_model_decode(ap.parse_args().device)
    ciao_policy_comparison()
