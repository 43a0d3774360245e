"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]. Pattern (rglru, rglru, local) x12 + 2
remainder recurrent layers; sliding window 2048; gelu-gated MLP; tied
embeddings; final logit softcap 30. Hybrid (O(1) recurrent state + windowed
KV) -> long_500k decode runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rglru_width=4096,
    conv_width=4,
    final_logit_softcap=30.0,
    mlp_activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    supports_long_context=True,
)
