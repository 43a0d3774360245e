"""The yardstick's constants and arithmetic: the card's published peaks and
the least time a piece of work can take on it.

Copied from ``chip_smoke.py`` (``PEAK_BF16_OPS``, ``PEAK_BYTES``,
``flash_bound``, ``bound_ms``) so that no later change to the program moves
them. Plain Python: no torch, nothing of the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time in ms: the larger of the operations over the bf16
    peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask allows when the sq queries are the
    last sq of skv positions."""
    off = skv - sq
    return sq * off + sq * (sq + 1) // 2


def flash_bound(batch: int, sq: int, skv: int, hq: int, hkv: int, d: int, causal: bool = True,
                elem: int = BF16):
    """K3's (operations, bytes) for one call: 4·D operations a (query, key)
    pair the mask allows, q, k, v read once and the output written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    flops = 4 * d * batch * hq * pairs
    nbytes = elem * batch * d * (2 * sq * hq + 2 * skv * hkv)
    return flops, nbytes


def flash_bound_ms(shape) -> float:
    """``bound_ms`` of one K3 call recorded as (B, Sq, Skv, Hq, Hkv, D,
    causal)."""
    return bound_ms(*flash_bound(*shape))
