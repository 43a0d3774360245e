"""The four input-shape suites of the reference (the same for every
arch): ``train_4k`` runs a train step; ``prefill_32k`` a prefill;
``decode_32k`` and ``long_500k`` one new token against a cache of
``seq_len``. ``long_500k`` needs sub-quadratic attention and is skipped for
archs without ``supports_long_context``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256, mode="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32, mode="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128, mode="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1, mode="decode")

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    """The shapes that apply to ``cfg``."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(cfg: ModelConfig) -> List[str]:
    return [] if cfg.supports_long_context else [LONG_500K.name]
