"""Training loop with checkpoint/restart and straggler monitoring (the
reference's ``train/trainer.py``).

* checkpoint/restart: periodic (async) checkpoints with atomic publish;
  ``Trainer.run_loop`` resumes from the latest step, so a crashed process
  restarted loses at most ``checkpoint_every`` steps (tested by injected
  failures).
* straggler mitigation: per-step wall times feed an EWMA monitor; a step
  slower than ``threshold`` x the EWMA raises a straggler event through a
  pluggable callback. A step's time includes the device's work: reading
  its loss waits for it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import distribute_tree, tree_shardings
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS
from repro_torch.train.data import SyntheticLM


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    decay: float = 0.9
    ewma: float = 0.0
    events: List[int] = dataclasses.field(default_factory=list)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.events.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
            # don't poison the EWMA with the outlier
        else:
            self.ewma = self.decay * self.ewma + (1 - self.decay) * dt
        return is_straggler


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    log_every: int = 10
    async_checkpoint: bool = True


class Trainer:
    """Trains ``cfg`` on the card unless ``device="cpu"``. With ``env``
    (``parallel.sharding``, over a DeviceMesh) the state is placed by
    ``tree_shardings`` of ``state_logical_specs``, restored onto the mesh,
    and the step runs sharded."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                 tcfg: TrainerConfig, fail_at_step: Optional[int] = None, device=None,
                 env=None):
        self.cfg, self.run, self.shape, self.tcfg, self.env = cfg, run, shape, tcfg, env
        self.device = resolve_device(device)
        self.fail_at_step = fail_at_step     # fault injection for tests
        self.monitor = StragglerMonitor()
        self.metrics_log: List[Dict[str, float]] = []
        self.step_fn = TS.make_train_step(cfg, run, env)
        self.npod = env.axis_size("pod") if env is not None else 1
        self.state_struct = TS.train_state_struct(cfg, run, npod=self.npod)
        self.state_sh = (tree_shardings(env, TS.state_logical_specs(cfg, run), self.state_struct)
                         if env is not None else None)
        self.ckptr = (ckpt.AsyncCheckpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
                      if tcfg.checkpoint_dir and tcfg.async_checkpoint else None)

    def init_or_restore(self, generator: torch.Generator):
        d = self.tcfg.checkpoint_dir
        if d and ckpt.latest_step(d) is not None:
            return ckpt.restore(self.state_struct, d, device=self.device,
                                fingerprint=self.cfg.fingerprint(), shardings=self.state_sh)
        state = TS.init_train_state(self.cfg, self.run, generator, self.device, npod=self.npod)
        return (state if self.state_sh is None else distribute_tree(state, self.state_sh)), 0

    def _save(self, state, step: int) -> None:
        if self.ckptr is not None:
            self.ckptr.save(state, step, fingerprint=self.cfg.fingerprint())
        else:
            ckpt.save(state, self.tcfg.checkpoint_dir, step, fingerprint=self.cfg.fingerprint(),
                      keep=self.tcfg.keep_checkpoints)

    def run_loop(self, generator: Optional[torch.Generator] = None,
                 batches=None) -> Dict[str, Any]:
        """Train from the latest checkpoint (or a fresh state drawn from
        ``generator``, seeded with ``run.seed`` when None) to
        ``total_steps`` on ``batches`` (an iterator, or a list indexed by
        step; ``SyntheticLM`` when None, which starts again at its first
        batch after a restore, as the reference's does)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.run.seed)
        state, start = self.init_or_restore(generator)
        data = batches if batches is not None else SyntheticLM(self.cfg).batches(
            self.shape, self.device, env=self.env)
        losses = []
        for step in range(start, self.tcfg.total_steps):
            batch = next(data) if hasattr(data, "__next__") else data[step % len(data)]
            t0 = time.time()
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.fail_at_step = None
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.monitor.observe(step, dt)
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.metrics_log.append(
                    {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                     "lr": float(metrics["lr"]), "dt": dt})
            if self.tcfg.checkpoint_dir and (step + 1) % self.tcfg.checkpoint_every == 0:
                self._save(state, step + 1)
        if self.ckptr is not None:
            self.ckptr.wait()
        return {"state": state, "losses": losses,
                "straggler_events": list(self.monitor.events)}
