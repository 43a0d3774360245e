"""What the plain references share: RMSNorm, RoPE, and the products against
weights in float32 (TF32 off) or, for the control, with both operands
rounded to fp8 first.

Plain torch; imports nothing of the program.
"""
from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def exact_f32():
    """Keep float32 products in float32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(t, dim=None):
    """``t`` rounded to e4m3 and back to f32, scaled by its largest
    magnitude (over ``dim``, or the whole tensor) onto the format's range."""
    t = t.float()
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = FP8_MAX / amax.clamp_min(1e-12)
    return (t * scale).to(FP8).float() / scale


class Precision:
    """The products against weights: ``"f32"`` computes them in float32;
    ``"fp8"`` (the control) rounds the activations a row at a time and the
    weight a matrix at a time to e4m3 first, as fp8 serving does, then
    multiplies in float32."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, x, w):
        """x (..., k) times w (k, n) in f32."""
        if self.kind == "fp8":
            return to_fp8(x, -1) @ to_fp8(w)
        return x.float() @ w.float()


def rmsnorm(x, gain, eps: float):
    """x / rms(x) times (1 + gain), in f32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def rope(x, positions, theta: float):
    """Rotary embedding of x (..., S, H, D) at ``positions`` (S,), the two
    halves of D rotated together, in f32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, device=x.device, dtype=torch.float64) * 2.0 / d)
    ang = (positions.double()[:, None] * freq)[:, None, :]          # (S, 1, half)
    sin, cos = ang.sin().float(), ang.cos().float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
