"""End-to-end training driver on the PyTorch port: checkpointed,
fault-tolerant, straggler-monitored training of a small LM on the synthetic
pipeline (``examples/train_tiny_lm.py`` without JAX).

Default: the reduced gemma2-family model, 200 steps of 8 x 128 tokens, on
the card unless ``--device cpu``. ``--m100`` switches to a ~100M-param
config; the driver is identical. A second run with the same ``--ckpt``
resumes from its latest checkpoint.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --device cpu --steps 20
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    """Run the driver; returns the trainer's ``run_loop`` output (the
    final state, the losses and the straggler events)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--m100", action="store_true",
                    help="~100M-param config")
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "tiny_lm_ckpt"),
                    help="checkpoint directory (default: build/tiny_lm_ckpt "
                         "in the checkout)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config("gemma2-2b")
    if args.m100:
        cfg = dataclasses.replace(
            cfg, name="gemma2-100m", d_model=512, num_layers=8,
            num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32768, local_window=1024)
        print(f"100M config: {cfg.param_count()/1e6:.1f}M params")

    run = RunConfig(remat_policy="none", learning_rate=3e-3,
                    warmup_steps=20, param_dtype="float32")
    shape = ShapeConfig(name="train", seq_len=args.seq,
                        global_batch=args.batch, mode="train")
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=args.ckpt, log_every=10)
    trainer = Trainer(cfg, run, shape, tcfg, device=args.device)
    out = trainer.run_loop()
    losses = out["losses"]
    if not losses:
        print(f"nothing to train: {args.ckpt} already holds step {args.steps}")
        return out
    print(f"\ntrained {len(losses)} steps on {trainer.device}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"straggler events: {out['straggler_events']}")
    for m in trainer.metrics_log[-3:]:
        print(m)
    return out


if __name__ == "__main__":
    main()
