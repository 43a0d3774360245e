"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it.

    Raises ``RuntimeError`` when a CUDA device is wanted (explicitly or by
    default) and none is present, rather than quietly running on the CPU.
    The meta device (shapes and dtypes, no storage) passes as asked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
