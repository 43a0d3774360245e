"""granite-moe-3b-a800m [moe]: 40-expert top-8 fine-grained MoE.

32L d_model=1536 24H (GQA kv=8, head_dim=64) d_ff=512 (per expert)
vocab=49155, MoE 40e top-8 [ibm-granite/granite-3.0 family; hf]. (The
assignment line says "40e top-8"; the bracketed hf pointer mentions 32e -
we follow the explicit config: 40 experts.) ``moe_parallelism`` is the
reference's sharding choice, carried for field-by-field parity; the port
runs every expert on one device. Pure full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=("global",),
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    moe_dense_residual=False,
    moe_parallelism="tp",
    mlp_activation="swiglu",
    tie_embeddings=True,
    embed_scale=False,
    rope_theta=10000.0,
    supports_long_context=False,
)
