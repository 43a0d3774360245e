"""seamless-m4t-medium [audio]: encoder-decoder multimodal backbone.

12L (decoder) + 12L encoder, d_model=1024 16H (MHA kv=16, head_dim=64)
d_ff=4096 vocab=256206 [arXiv:2308.11596; hf]. The audio frontend
(w2v-BERT conformer) is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings fed to the text/unit encoder.
Decoder cross-attends to the encoder output; decode shapes run the decoder
step (self-attn KV cache + cross-attn KV over the 32k source). Full
attention everywhere -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=("global",),
    mlp_activation="gelu",
    attn_bias=True,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    frontend="audio",
    frontend_len=0,
    tie_embeddings=True,
    embed_scale=False,
    rope_theta=10000.0,
    supports_long_context=False,
)
