"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=24576 vocab=256000
[arXiv:2402.16819; unverified]. Non-gated squared-ReLU MLP, untied
embeddings, rotary embeddings. Pure full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    pattern=("global",),
    mlp_activation="squared_relu",
    tie_embeddings=False,
    embed_scale=False,
    rope_theta=10000.0,
    supports_long_context=False,
)
