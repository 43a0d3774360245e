#!/usr/bin/env python3
"""Phase 8b's training step with an older revision of ``repro_torch`` and the
current one, in turns on one card: peak device memory, the loss and step ms.

    python3 tools/train_peak_probe.py --parent DIR [--steps N]

DIR holds an older revision's ``src/repro_torch`` (for example
``git archive HEAD~1 src/repro_torch | tar -x -C build/parent_src``). Each
run is a process of its own (parent, current, current, parent), importing
``repro_torch`` from its revision: full-width gemma2-2b in bf16, chip_smoke.py
phase 8b's batch (2 x 4,096 tokens of ``SyntheticLM``), AdamW, remat "full",
loss and attention chunks of 1,024, N steps; it prints the peak of
``torch.cuda.max_memory_allocated()`` over the steps (the parameters, the
optimizer state and the batch included), then over one
``loss_and_grads`` beside that state (the loss's backward without the
optimizer's temporaries), the first step's loss and the median step ms
after the first. Every line carries the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(src: Path, steps: int) -> None:
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import SyntheticLM
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(src.resolve()), repro_torch.__file__
    cfg = get_config("gemma2-2b")
    run = RunConfig(remat_policy="full", loss_chunk=C.TRAIN_CHUNK, attn_chunk=C.TRAIN_CHUNK,
                    warmup_steps=2)
    data = SyntheticLM(cfg).batches(ShapeConfig("train_4k_batch_2", C.TRAIN_SEQ, C.TRAIN_BATCH,
                                                "train"), "cuda")
    batches = [next(data) for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_train_state(cfg, run, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = TS.make_train_step(cfg, run)
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, b)
        losses.append(m["loss"].item())
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the loss and its gradients alone, beside the state: the loss's backward
    # (its f32 chunks of B x TRAIN_CHUNK x V) without the optimizer's
    # temporaries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = TS.loss_and_grads(cfg, run, state["params"], batches[0])
    loss.item()
    del grads
    print(json.dumps({"peak_gb": peak, "loss_and_grads_peak_gb":
                      torch.cuda.max_memory_allocated() / 1e9, "loss": losses[0],
                      "step_ms": sorted(ms[1:])[len(ms[1:]) // 2]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.steps)
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    card = C.card_line()
    srcs = {"parent": args.parent / "src", "current": ROOT / "src"}
    for tag in ("parent", "current", "current", "parent"):
        proc = subprocess.run([sys.executable, __file__, "--parent", str(args.parent), "--steps",
                               str(args.steps), "--child", str(srcs[tag])],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{tag}: {proc.stderr[-3000:]}")
        C.log(f"phase 8b's step, {tag} ({srcs[tag]}): {proc.stdout.strip().splitlines()[-1]}; "
              f"{card}")


if __name__ == "__main__":
    main()
