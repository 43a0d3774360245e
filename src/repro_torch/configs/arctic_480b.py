"""arctic-480b [moe]: 128-expert top-2 MoE with a dense FFN residual.

35L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=4864 vocab=32000,
MoE 128e top-2 [hf:Snowflake/snowflake-arctic-base; hf]. Dense-MoE hybrid:
every block runs a small dense FFN residual in parallel with the routed
experts. ``moe_parallelism`` and ``optimizer`` are the reference's
sharding and training choices, carried for field-by-field parity; the port
runs every expert on one device. Pure full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=("global",),
    num_experts=128,
    num_experts_per_tok=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
    moe_parallelism="ep",
    mlp_activation="swiglu",
    tie_embeddings=False,
    embed_scale=False,
    rope_theta=10000.0,
    optimizer="adafactor",
    supports_long_context=False,
)
