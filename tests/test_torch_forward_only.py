"""The CUDA attention kernels have no backward: a call that autograd would
need to differentiate through them raises instead of cutting the graph."""
import types

import pytest
import torch

from repro_torch.kernels import forward_only
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.decode_attn import ops as DO
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_attn import ops as FO


def test_forward_only_refuses_inputs_that_require_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        forward_only("k", torch.zeros(2), x)
    with torch.no_grad():
        forward_only("k", x)
    forward_only("k", x.detach(), torch.zeros(2))


@pytest.mark.parametrize("which", ["flash", "decode"])
def test_cuda_dispatch_refuses_grad_before_launching(monkeypatch, which):
    def launched(*a, **k):
        raise AssertionError("the kernel was launched")
    monkeypatch.setattr(FK, "flash_attention_cuda", launched)
    monkeypatch.setattr(DK, "decode_attention_cuda", launched)
    cuda = types.SimpleNamespace(shape=(1, 4, 2, 64), device=torch.device("cuda"))
    w = torch.zeros((1, 4, 2, 64), requires_grad=True)
    call = (lambda q: FO.flash_attention(q, cuda, cuda)) if which == "flash" else \
        (lambda q: DO.decode_attention(q, cuda, cuda, cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        call(w * 2)
    with torch.no_grad(), pytest.raises(AssertionError, match="launched"):
        call(w * 2)
