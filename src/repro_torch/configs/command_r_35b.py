"""command-r-35b [dense]: GQA, no-bias, parallel attn+FFN residual blocks.

40L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]. Parallel residual blocks
(attention and FFN read the same norm, summed into the residual), tied
embeddings, large rope theta. Pure full attention.
Largest KV-per-token of the assigned set -> serving interference showcase.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    pattern=("global",),
    parallel_block=True,
    mlp_activation="swiglu",
    tie_embeddings=True,
    embed_scale=False,
    rope_theta=8_000_000.0,
    supports_long_context=False,
)
