"""Serving entry points of the port."""
from repro_torch.serving.generate import generate  # noqa: F401
