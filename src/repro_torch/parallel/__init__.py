"""Sharding of the port: logical-axis rules as DTensor placements, and the
int8 cross-pod gradient exchange (the reference's ``parallel/``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    DECODE_RULES,
    DEFAULT_RULES,
    LONG_DECODE_RULES,
    MeshShape,
    ShardEnv,
    local_env,
    make_env,
)
