"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100: its serving path,
the CIAO cached gather path and the CIAO simulator.

The layout mirrors ``src/repro``: ``configs``, ``kernels/<name>/`` (a CUDA
source, its ``ctypes`` wrapper, the dispatching ``ops.py`` and the plain
torch ``ref.py``), ``models`` and ``serving`` (gemma2-2b prefill and decode
through the attention kernels), ``core`` (the simulator: the scalar
``SMSimulator`` and the batched engine, whose numpy and C steppers run on
the host and whose ``torch`` stepper runs on the card) and ``workloads``
(the simulator's workloads and registry, and the gather workload's index
stream, which drives ``kernels/ciao_gather``). The package imports torch
and numpy only; entry points run on the card unless the caller passes
``device="cpu"`` or CPU tensors.
"""
from repro_torch.device import resolve_device  # noqa: F401
