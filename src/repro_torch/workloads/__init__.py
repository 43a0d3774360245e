"""Workload generators of the port: the gather index stream that drives K1."""
from repro_torch.workloads.derived import gather_index_stream  # noqa: F401
