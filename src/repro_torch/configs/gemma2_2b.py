"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]. Sliding window 4096 on local layers; attn softcap 50,
final softcap 30; gelu-gated MLP; tied embeddings; query scale 1/sqrt(256).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256 ** -0.5,
    mlp_activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    supports_long_context=True,
)
