"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100: its serving path
and the CIAO cached gather path.

The layout mirrors ``src/repro``: ``configs``, ``kernels/<name>/`` (a CUDA
source, its ``ctypes`` wrapper, the dispatching ``ops.py`` and the plain
torch ``ref.py``), ``models`` and ``serving`` (gemma2-2b prefill and decode
through the attention kernels), and ``workloads`` (the gather workload's
index stream, which drives ``kernels/ciao_gather``). The package imports
torch and numpy only; entry points run on the card unless the caller passes
``device="cpu"`` or CPU tensors.
"""
from repro_torch.device import resolve_device  # noqa: F401
