"""qwen3-4b [dense]: qk-norm + GQA.

36L d_model=2560 32H (GQA kv=8, head_dim=128) d_ff=9728 vocab=151936
[hf:Qwen/Qwen3-8B family; hf]. RMSNorm on q/k heads (qk_norm), SwiGLU,
tied embeddings, rope theta 1e6. Pure full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    pattern=("global",),
    use_qk_norm=True,
    mlp_activation="swiglu",
    tie_embeddings=True,
    embed_scale=False,
    rope_theta=1_000_000.0,
    supports_long_context=False,
)
