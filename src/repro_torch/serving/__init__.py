"""Serving entry points of the port: ``generate`` (the real-model path on
the card) and the continuous-batching cost model (``ServeEngine`` over the
paged pool, CIAO-scheduled), as ``repro.serving`` exports them."""
from repro_torch.serving.generate import generate  # noqa: F401
from repro_torch.serving.pages import PagePool, PoolConfig  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    Request, ServeConfig, ServeEngine, ServeStats, synth_requests)
