"""Hand-written CUDA kernels of the port, one sub-package each."""
from __future__ import annotations

import torch


def forward_only(name: str, *tensors) -> None:
    """Raise when autograd would need a backward through a CUDA kernel.

    The attention kernels compute the forward pass only, as the reference's
    Pallas kernels do; their outputs carry no ``grad_fn``. A call with grad
    mode on and an input that requires grad would silently cut the graph,
    so it is refused; the plain torch versions are differentiable."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; call it under torch.no_grad() or with detached inputs")
