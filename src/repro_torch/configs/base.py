"""Configuration dataclasses of the port.

The port's own copies of ``repro``'s ``ModelConfig``, ``ShapeConfig`` and
``RunConfig``: the same fields with the same defaults, so a configuration
compares equal field by field with the reference's, and
``ModelConfig.fingerprint`` (which a checkpoint's manifest records) gives
the reference's string. Hardware constants do not belong here; the card's
peak rates live with the script that measures against them
(``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Tuple

BLOCK_GLOBAL_ATTN = "global"  # full (causal/prefix) attention
BLOCK_LOCAL_ATTN = "local"    # sliding-window attention
BLOCK_RGLRU = "rglru"         # RG-LRU recurrent block (recurrentgemma)
BLOCK_SSD = "ssd"             # Mamba-2 state-space duality block
VALID_BLOCKS = (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN, BLOCK_RGLRU, BLOCK_SSD)

ATTN_BLOCKS = (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per architecture."""

    name: str
    family: str                      # dense | hybrid | moe | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Layer stack: a repeating pattern of block kinds; the remainder layers
    # (num_layers % len(pattern)) continue the pattern at the top.
    pattern: Tuple[str, ...] = (BLOCK_GLOBAL_ATTN,)
    local_window: int = 0            # sliding window for BLOCK_LOCAL_ATTN

    # Attention variants
    use_qk_norm: bool = False
    attn_logit_softcap: float = 0.0  # gemma2: tanh softcap on attn logits
    final_logit_softcap: float = 0.0 # gemma2: tanh softcap on lm logits
    query_scale: float = 0.0         # 0 -> 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    parallel_block: bool = False
    attn_bias: bool = False

    # MLP
    mlp_activation: str = "swiglu"   # swiglu | geglu | gelu | squared_relu

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False
    moe_parallelism: str = "ep"

    # SSM / recurrent
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    rglru_width: int = 0

    # Encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # Modality frontend
    frontend: str = ""
    frontend_len: int = 256
    prefix_lm: bool = False

    # Embeddings
    tie_embeddings: bool = True
    embed_scale: bool = True         # gemma-style sqrt(d_model) embed scaling
    norm_eps: float = 1e-6

    # Runtime knobs carried for field-by-field parity with the reference
    sharding_overrides: Tuple[Tuple[str, Any], ...] = ()
    optimizer: str = "adamw"
    supports_long_context: bool = False

    def __post_init__(self):
        for b in self.pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block kind {b!r} in pattern")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.num_experts and self.num_experts_per_tok <= 0:
            raise ValueError("MoE config needs num_experts_per_tok > 0")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return all(b not in ATTN_BLOCKS for b in self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def scan_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind of every layer, bottom to top: the pattern repeated,
        then the remainder blocks (layer ``r*len(pattern)+i`` is
        ``pattern[i]``)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def attn_param_count(self) -> int:
        """One attention's parameters: the q/k/v/o projections, the
        qk-norm scales and the q/k/v/o biases where the config has them."""
        d, dh, hq, hkv = self.d_model, self.head_dim, self.num_heads, self.num_kv_heads
        return (d * dh * (2 * hq + 2 * hkv) + (2 * dh if self.use_qk_norm else 0)
                + ((hq + 2 * hkv) * dh + d if self.attn_bias else 0))

    def block_param_count(self, kind: str) -> int:
        """Parameters of one block of ``kind`` as ``init_params`` draws it.

        Attention: ``attn_param_count``, two norms and the MLP or the MoE
        (router and experts, plus the dense residual MLP where the config
        has one); in an encoder-decoder also ``ln_cross`` and the cross
        attention. RG-LRU: ``ln1``, the two branch
        projections and the output, the conv's weight and bias, five gate
        vectors (w_r, b_r, w_i, b_i, lam), ``ln2`` and the MLP. SSD:
        ``ln1``, the fused input projection, the output, the conv over
        (x, B, C) with its bias, a_log, dt_bias and d_skip a head and the
        gated norm's scale."""
        d, ff = self.d_model, self.d_ff
        mats = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        if kind == BLOCK_RGLRU:
            rw = self.rglru_width or d
            return (3 * d * rw + (self.conv_width + 1) * rw + 5 * rw + 2 * d
                    + mats * d * ff)
        if kind == BLOCK_SSD:
            di, n, nh = self.d_inner, self.ssm_state_dim, self.ssm_num_heads
            return (d * (2 * di + 2 * n + nh) + di * d + (self.conv_width + 1) * (di + 2 * n)
                    + 3 * nh + di + d)
        block = self.attn_param_count() + 2 * d
        if self.is_encoder_decoder:
            block += self.attn_param_count() + d
        if self.num_experts:
            block += self.num_experts * (mats * d * (self.moe_d_ff or ff) + d)
            if self.moe_dense_residual:
                block += mats * d * ff
        else:
            block += mats * d * ff
        return block

    def encoder_param_count(self) -> int:
        """The encoder of an encoder-decoder: each layer's ``ln1``,
        attention, ``ln2`` and dense MLP, and its final norm (0 without
        one)."""
        if not self.is_encoder_decoder:
            return 0
        mats = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        layer = self.attn_param_count() + 2 * self.d_model + mats * self.d_model * self.d_ff
        return self.num_encoder_layers * layer + self.d_model

    def param_count(self) -> int:
        """Parameters of the port's model, as ``init_params`` draws them:
        the embedding (and an untied head), every decoder layer's block
        (``block_param_count``), the final norm and the encoder
        (``encoder_param_count``)."""
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return (self.vocab_size * self.d_model + head + self.d_model
                + sum(self.block_param_count(k) for k in self.layer_kinds())
                + self.encoder_param_count())

    def active_param_count(self) -> int:
        """Parameters a token touches (the reference's): an MoE layer's
        top-k experts only."""
        if not self.num_experts:
            return self.param_count()
        mats = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
        per_expert = self.d_model * (self.moe_d_ff or self.d_ff) * mats
        moe_layers = sum(k in ATTN_BLOCKS for k in self.layer_kinds())
        return self.param_count() - (self.num_experts - self.num_experts_per_tok) * per_expert * moe_layers

    def fingerprint(self) -> str:
        """The reference's: the first 12 hex digits of the SHA-1 of the
        fields as sorted JSON."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape. ``mode`` selects the step that runs it."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"

    def __post_init__(self):
        if self.mode not in ("train", "prefill", "decode"):
            raise ValueError(self.mode)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs for training and serving, with the reference's
    defaults. ``gradient_compression`` and ``decode_kv_seq_shard`` belong
    to sharding, which the port does not have yet: ``make_train_step``
    refuses ``"int8"``."""

    remat_policy: str = "full"       # full | dots | none
    grad_accum: int = 1
    loss_chunk: int = 0              # 0 = unchunked CE; >0 = seq-chunked remat CE
    attn_chunk: int = 0              # 0 = auto; kv-chunk for online-softmax attn
    gradient_compression: str = ""   # "" | "int8" (cross-pod, error feedback)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    max_grad_norm: float = 1.0
    seed: int = 0
    param_dtype: str = "bfloat16"
    decode_kv_seq_shard: bool = True  # shard KV cache seq dim over model axis
