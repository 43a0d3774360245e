"""Launch tooling of the port (the reference's ``launch/``): meshes, the
per-rank op analysis (``op_analysis``, the counterpart of
``hlo_analysis``) and the dry run of every arch x shape over the
production meshes (``dryrun``)."""
from repro_torch.launch import dryrun, op_analysis

__all__ = ["dryrun", "op_analysis"]
