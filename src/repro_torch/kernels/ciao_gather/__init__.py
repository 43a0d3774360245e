from repro_torch.kernels.ciao_gather.ops import ciao_gather  # noqa: F401
