"""Quickstart on the PyTorch port: build a tiny LM, take train steps,
generate greedily (``examples/quickstart.py`` without JAX).

    PYTHONPATH=src python examples/torch_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train import train_step as TS
from repro_torch.train.data import SyntheticLM


def main(device=None, steps: int = 10, new_tokens: int = 12):
    """Train the reduced gemma2 ``steps`` steps on ``SyntheticLM`` batches
    of 4 x 64 tokens, then greedily extend an 8-token prompt by
    ``new_tokens``. Returns ``{"losses": [...], "generated": [...]}``."""
    dev = resolve_device(device)
    cfg = reduced_config("gemma2-2b")        # tiny same-family variant
    run = RunConfig(remat_policy="none", learning_rate=1e-3,
                    param_dtype="float32")
    shape = ShapeConfig(name="quick", seq_len=64, global_batch=4,
                        mode="train")

    print(f"arch={cfg.name}  params={cfg.param_count()/1e6:.2f}M  "
          f"pattern={cfg.pattern}  device={dev}")

    state = TS.init_train_state(
        cfg, run, torch.Generator(device=dev).manual_seed(0), dev)
    step = TS.make_train_step(cfg, run)
    data = SyntheticLM(cfg).batches(shape, dev)
    losses = []
    for i in range(steps):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f} "
              f"gnorm={float(metrics['grad_norm']):.3f}")

    # greedy generation off the trained weights
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    with torch.no_grad():
        logits, cache, pos = M.prefill(cfg, state["params"],
                                       {"tokens": prompt}, max_len=32)
        toks = []
        tok = logits.argmax(-1)[:, None]
        for i in range(new_tokens):
            toks.append(int(tok[0, 0]))
            logits, cache = M.decode_step(cfg, state["params"], tok,
                                          pos + 1 + i, cache)
            tok = logits.argmax(-1)[:, None]
    print("generated:", toks)
    return {"losses": losses, "generated": toks}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    main(args.device, args.steps)
