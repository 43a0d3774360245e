"""paligemma-3b [vlm]: SigLIP vision frontend (stub) + gemma backbone.

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216
[arXiv:2407.07726; hf]. The SigLIP tower is a STUB per the assignment:
``input_specs()`` provides precomputed, projected patch embeddings
(frontend_len=256 positions) which are prepended to the text embeddings;
attention is prefix-LM (full attention over the image prefix, causal over
text). Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    pattern=("global",),
    mlp_activation="geglu",
    frontend="vision",
    frontend_len=256,
    prefix_lm=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    supports_long_context=False,
)
