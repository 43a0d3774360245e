"""mamba2-2.7b [ssm]: attention-free SSD (state-space duality) stack.

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128 [arXiv:2405.21060;
unverified]. d_inner = 2*d_model = 5120, SSD head dim P=64 -> 80 heads,
depthwise conv width 4, chunked SSD with chunk=256 (dense block matmuls
within a chunk). No MLP blocks (pure Mamba-2 stack). Attention-free: its
decode state is O(1) in the sequence, no KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssd",),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    mlp_activation="gelu",
    tie_embeddings=True,
    embed_scale=False,
    norm_eps=1e-5,
    supports_long_context=True,
)
