"""The CIAO simulator: the scalar ``SMSimulator`` (the oracle), the
multi-SM ``GPUSimulator``, the batched engine with its numpy, C and torch
steppers, the experiment runner and its run ledger. A copy of
``repro.core``."""
from repro_torch.core.vta import VictimTagArray  # noqa: F401
from repro_torch.core.interference import InterferenceDetector, DetectorConfig  # noqa: F401
from repro_torch.core.onchip import OnChipMemory, OnChipConfig  # noqa: F401
from repro_torch.core.memory import (  # noqa: F401
    BankedL2, DRAMModel, L2TagArray, MemoryHierarchy)
from repro_torch.core.policies import (  # noqa: F401
    GTOPolicy, CCWSPolicy, BestSWLPolicy, StatPCALPolicy,
    CIAOPolicy, make_policy, POLICY_NAMES)
from repro_torch.core.simulator import (  # noqa: F401
    SMSimulator, SimConfig, SimResult, run_policy_sweep)
from repro_torch.core.gpu import (  # noqa: F401
    CTA, CTAScheduler, GPUConfig, GPUResult, GPUSimulator, make_ctas,
    run_gpu_policy_sweep)
from repro_torch.core.batched import (  # noqa: F401
    BatchCell, BatchedSMEngine, DeadlineExceeded, run_batched,
    supports_config)
from repro_torch.core.faults import (  # noqa: F401
    FaultPlan, FaultSpec, InjectedFault)
from repro_torch.core.ledger import RunLedger, grid_hash  # noqa: F401
from repro_torch.core.runner import (  # noqa: F401
    ExperimentGrid, FailedCell, RunRecord, geomean, index_records,
    load_records, run_grid, save_records)
from repro_torch.workloads import (  # noqa: F401
    WORKLOADS, Workload, load_workload, make_workload, register_workload,
    save_workload)
