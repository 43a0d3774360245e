"""A decoder of GQA attention and top-k MoE blocks (granite-moe): its
weights drawn from the seed, its model FLOPs and the MoE layer's bound,
all from the configuration file's widths.

The weights come in the program's parameter layout (``repro_torch.models.model``
documents it), drawn on the device in one call a kind of leaf, stacked over
the layers; each layer's leaf is a view of its stack.
"""
from __future__ import annotations

from portbench.yardstick import BF16, F32, bound_ms, causal_pairs


def widths(c):
    """The sizes the counts below use, by the configuration file's keys."""
    return dict(layers=c["num_hidden_layers"], d=c["hidden_size"], hq=c["num_attention_heads"],
                hkv=c["num_key_value_heads"], dh=c["head_dim"], experts=c["num_local_experts"],
                k=c["num_experts_per_tok"], ff=c["intermediate_size"], vocab=c["vocab_size"])


def port_fields(c):
    """The port's ``ModelConfig`` fields this file fixes, with their values."""
    w = widths(c)
    return {"num_layers": w["layers"], "d_model": w["d"], "num_heads": w["hq"],
            "num_kv_heads": w["hkv"], "head_dim": w["dh"], "num_experts": w["experts"],
            "num_experts_per_tok": w["k"], "moe_d_ff": w["ff"], "vocab_size": w["vocab"],
            "tie_embeddings": c["tie_word_embeddings"], "mlp_activation": "swiglu",
            "moe_dense_residual": False, "pattern": ("global",),
            "norm_eps": c["rms_norm_eps"], "rope_theta": float(c["rope_theta"]),
            "query_scale": 0.0 if c["attention_multiplier"] == w["dh"] ** -0.5
            else c["attention_multiplier"],
            "embed_scale": False, "final_logit_softcap": 0.0, "attn_logit_softcap": 0.0,
            "use_qk_norm": False, "attn_bias": False, "parallel_block": False}


def draw_params(c, gen, device):
    """Weights from ``gen`` in bf16 (the router and the norm gains in f32):
    normal with std 1/sqrt(fan_in), norm gains uniform in +-0.1."""
    import torch
    w = widths(c)
    n, d, hq, hkv, dh, e, ff = (w[k] for k in ("layers", "d", "hq", "hkv", "dh", "experts", "ff"))

    def normal(shape, fan_in, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(fan_in ** -0.5)

    def gain(shape):
        return torch.rand(shape, generator=gen, device=device).sub_(0.5).mul_(0.2)

    table = normal((w["vocab"], d), d)
    wq, wk, wv = normal((n, d, hq, dh), d), normal((n, d, hkv, dh), d), normal((n, d, hkv, dh), d)
    wo = normal((n, hq, dh, d), hq * dh)
    router = normal((n, d, e), d, torch.float32)
    w_in, w_gate = normal((n, e, d, ff), d), normal((n, e, d, ff), d)
    w_out = normal((n, e, ff, d), ff)
    ln1, ln2, final = gain((n, d)), gain((n, d)), gain((d,))
    layers = [{"ln1": {"scale": ln1[i]},
               "attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
               "ln2": {"scale": ln2[i]},
               "moe": {"router": router[i], "w_in": w_in[i], "w_gate": w_gate[i],
                       "w_out": w_out[i]}} for i in range(n)]
    return {"embed": {"table": table}, "layers": layers, "final_norm": {"scale": final}}


def active_params(c) -> int:
    """Parameters a token multiplies, outside the embedding: the attention's
    four projections, the router and k experts' three matrices a layer."""
    w = widths(c)
    layer = (w["d"] * (2 * w["hq"] + 2 * w["hkv"]) * w["dh"] + w["d"] * w["experts"]
             + w["k"] * 3 * w["d"] * w["ff"])
    return w["layers"] * layer


def request_flops(c, batch: int, prompt: int, new: int) -> float:
    """Model FLOPs of one request: the prefill of ``batch`` prompts of
    ``prompt`` tokens and ``new`` decode steps. 2 x active parameters a
    token, causal attention's QK and PV products (4 dh a head and allowed
    pair), and the tied head at the positions whose logits are computed
    (the prompt's last and each step's)."""
    w = widths(c)
    n_act, head = active_params(c), 2 * w["d"] * w["vocab"]
    attn = 4 * w["dh"] * w["hq"] * w["layers"] * batch
    flops = 2 * n_act * batch * prompt + attn * causal_pairs(prompt, prompt) + head * batch
    for i in range(new):
        flops += 2 * n_act * batch + attn * (prompt + i + 1) + head * batch
    return float(flops)


def moe_bound_ms(c, tokens: int) -> float:
    """The least time of one MoE layer over ``tokens`` tokens: the router's
    and k experts' products a token at the bf16 peak, or every expert's
    weights (bf16) and the router's (f32) read once with the tokens in and
    out (bf16) at the memory bandwidth."""
    w = widths(c)
    d, e, ff = w["d"], w["experts"], w["ff"]
    flops = tokens * (2 * d * e + w["k"] * 3 * 2 * d * ff)
    nbytes = BF16 * 3 * e * d * ff + F32 * d * e + 2 * BF16 * tokens * d
    return bound_ms(flops, nbytes)
