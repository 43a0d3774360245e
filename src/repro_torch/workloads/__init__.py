"""Workload subsystem: the access-pattern IR, the synthetic benchmark
families, the traces walked out of the reference's Pallas kernels, and the
token compilation the simulator consumes. A copy of ``repro.workloads``
without its on-disk format (``io``) and curated trace set.

Entry points:

* :func:`make_workload` / :data:`WORKLOADS` / :data:`REGISTRY` — the
  registry.
* :mod:`repro_torch.workloads.ir` — primitives + :func:`compile_workload`.
* :mod:`repro_torch.workloads.tokens` — the trace -> token-stream contract
  the simulator consumes.
* :mod:`repro_torch.workloads.derived` — traces walked out of the
  reference's Pallas kernels (flashattn / decodeattn / gather), registered
  alongside the synthetic families; ``gather_index_stream`` also drives the
  port's CIAO gather kernel.
"""
from repro_torch.workloads.ir import (  # noqa: F401
    AluBurst, Explicit, HotLines, Interleave, MemBurst, Mix, PhaseSpec,
    ReuseWindow, SharedTable, SMEM_TOTAL, Stream, Workload, WorkloadSpec,
    compile_workload)
from repro_torch.workloads.tokens import (  # noqa: F401
    LINE, TOKEN_LINE_SHIFT, decode_trace, encode_trace, encode_workload,
    token_line)
from repro_torch.workloads.registry import (  # noqa: F401
    REGISTRY, WORKLOADS, WorkloadEntry, make_workload, register_workload,
    workload_names)
from repro_torch.workloads.synthetic import (  # noqa: F401
    ci_spec, ci_workload, lws_spec, lws_workload, sws_spec, sws_workload,
    two_phase_spec, two_phase_workload)
from repro_torch.workloads import derived as _derived  # noqa: F401  (registers)
from repro_torch.workloads.derived import (  # noqa: F401
    decodeattn_workload, flashattn_workload, gather_index_stream,
    gather_workload)
