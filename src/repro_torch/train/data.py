"""The reference's synthetic data stream (``train/data.py``), batch for
batch: tokens from a mixture of a Zipf unigram and a bigram chain over a
reduced alphabet, seeded by (seed, host, step), and the frontends' stand-in
embeddings. Batches come out as torch tensors on a device: ``tokens`` and
``targets`` int32, ``src_embeds``/``patch_embeds`` rounded to bf16 as the
reference casts them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import distribute


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2
    markov_mix: float = 0.5      # fraction of tokens drawn from bigram chain
    pad_id: int = -1


class SyntheticLM:
    """Deterministic stream: x_t ~ mix(Zipf unigram, bigram(x_{t-1}))."""

    def __init__(self, cfg: ModelConfig, data: DataConfig = DataConfig()):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        v = cfg.vocab_size
        # small dense bigram table over a reduced alphabet, tiled over vocab
        base = min(v, 512)
        self._base = base
        self._bigram = rng.dirichlet(np.ones(base) * 0.1, size=base)
        self._unigram = np.arange(1, base + 1, dtype=np.float64) ** -data.zipf_a
        self._unigram /= self._unigram.sum()

    def sample_tokens(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        base = self._base
        out = np.empty((batch, seq), np.int64)
        prev = rng.integers(0, base, size=batch)
        for t in range(seq):
            from_bigram = rng.random(batch) < self.data.markov_mix
            big = np.array([rng.choice(base, p=self._bigram[p]) for p in
                            prev[from_bigram]]) if from_bigram.any() else []
            uni = rng.choice(base, p=self._unigram, size=int((~from_bigram).sum()))
            nxt = np.empty(batch, np.int64)
            nxt[from_bigram] = big
            nxt[~from_bigram] = uni
            out[:, t] = nxt
            prev = nxt
        return out % self.cfg.vocab_size

    def numpy_batches(self, shape: ShapeConfig, host_index: int = 0,
                      num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator of train batches as numpy arrays: tokens and
        the shifted targets (int64), the frontend embeddings (f32)."""
        cfg = self.cfg
        b = shape.global_batch // num_hosts
        step = 0
        while True:
            rng = np.random.default_rng((self.data.seed, host_index, step))
            if cfg.is_encoder_decoder:
                tgt = max(shape.seq_len // 4, 8)
                toks = self.sample_tokens(rng, b, tgt + 1)
                batch = {"src_embeds": rng.standard_normal(
                    (b, shape.seq_len, cfg.d_model)).astype(np.float32) * 0.02}
            elif cfg.frontend == "vision":
                text = shape.seq_len - cfg.frontend_len
                toks = self.sample_tokens(rng, b, text + 1)
                batch = {"patch_embeds": rng.standard_normal(
                    (b, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02}
            else:
                toks = self.sample_tokens(rng, b, shape.seq_len + 1)
                batch = {}
            batch.update(tokens=toks[:, :-1], targets=toks[:, 1:])
            yield batch
            step += 1

    def batches(self, shape: ShapeConfig, device=None, host_index: int = 0,
                num_hosts: int = 1, env=None) -> Iterator[Dict[str, torch.Tensor]]:
        """``numpy_batches`` on ``device`` (the card unless ``"cpu"``):
        tokens and targets int32, the embeddings bf16; on an ``env`` whose
        mesh has more than one device, DTensors split as ``("act_batch",
        ...)`` (each rank draws the whole batch and keeps its rows)."""
        dev = resolve_device(device)
        for batch in self.numpy_batches(shape, host_index, num_hosts):
            batch = as_tensors(batch, dev)
            if env is not None and env.size > 1:
                batch = {k: distribute(x, env.sharding("act_batch", *(None,) * (x.dim() - 1),
                                                       shape=tuple(x.shape)))
                         for k, x in batch.items()}
            yield batch


def as_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A ``numpy_batches`` batch on ``device``: int64 arrays as int32, the
    f32 embeddings rounded to bf16, as the reference casts them."""
    return {k: (torch.from_numpy(x.astype(np.int32)) if x.dtype == np.int64
                else torch.from_numpy(x).to(torch.bfloat16)).to(device)
            for k, x in batch.items()}
