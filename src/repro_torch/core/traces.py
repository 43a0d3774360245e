"""Back-compat shim: the workload subsystem lives in
:mod:`repro_torch.workloads` (declarative IR, synthetic families, Pallas
-kernel-derived traces, token contract, on-disk format).

Everything ``repro.core.traces`` re-exports is re-exported here, so imports
of the form ``from repro_torch.core.traces import make_workload, WORKLOADS,
Workload`` keep working. New code should import
:mod:`repro_torch.workloads` directly.
"""
from repro_torch.workloads import (  # noqa: F401
    LINE, SMEM_TOTAL, WORKLOADS, Workload, ci_workload, lws_workload,
    make_workload, register_workload, sws_workload, two_phase_workload)
