"""PyTorch and CUDA port of the ``repro`` serving path, for one NVIDIA H100.

The layout mirrors ``src/repro``: ``configs``, ``kernels/<name>/`` (a CUDA
source, its ``ctypes`` wrapper, the dispatching ``ops.py`` and the plain
torch ``ref.py``), ``models`` and ``serving``. The package imports torch and
numpy only; entry points run on the card unless the caller passes
``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
