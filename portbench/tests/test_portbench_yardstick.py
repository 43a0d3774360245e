"""The yardstick's arithmetic against hand-worked values, and the window's
rate when it closes inside a request."""
import importlib
import math
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, yardstick
from portbench.arch import moe_decoder
from portbench.tests import tiny

GRANITE = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 2, "num_local_experts": 4,
           "num_experts_per_tok": 2, "intermediate_size": 3, "vocab_size": 10}


def test_bound_is_the_longer_of_operations_and_bytes():
    assert yardstick.bound_ms(989e12, 0) == pytest.approx(1e3)
    assert yardstick.bound_ms(1.0, 3.35e12) == pytest.approx(1e3)


def test_causal_pairs_and_k3_bound():
    assert yardstick.causal_pairs(3, 3) == 6
    assert yardstick.causal_pairs(2, 4) == 7          # queries at 2 and 3 of 4 positions
    # 4 dh a (head, allowed pair): 4 * 8 * 2 heads * 10 pairs; bf16 q, k, v, out
    assert yardstick.flash_bound(1, 4, 4, 2, 1, 8, True) == (640, 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1))
    assert yardstick.flash_bound(1, 4, 4, 2, 1, 8, False)[0] == 4 * 8 * 2 * 16


def test_moe_decoder_counts():
    # a layer: attention 8 * (2*4 + 2*2) * 2 = 192, router 32, two experts 2*3*8*3 = 144
    assert moe_decoder.active_params(GRANITE) == 2 * (192 + 32 + 144)
    # prefill of 2 x 3: 2*736*6 + attention 4*2*4*2 layers*2 rows * 6 pairs + head 2*8*10*2;
    # the step: 2*736*2 + attention * 4 keys + head
    prefill = 2 * 736 * 6 + 128 * 6 + 320
    step = 2 * 736 * 2 + 128 * 4 + 320
    assert moe_decoder.request_flops(GRANITE, 2, 3, 1) == prefill + step == 13696
    # 5 tokens: 5 * (router 2*8*4 + 2 experts * 3 * 2*8*3) flops; bytes: experts
    # 2*3*4*8*3 (bf16), router 4*8*4 (f32), tokens in and out 2*2*5*8
    flops, nbytes = 5 * (64 + 288), 576 + 128 + 160
    assert moe_decoder.moe_bound_ms(GRANITE, 5) == pytest.approx(yardstick.bound_ms(flops, nbytes))


def test_rate_reader_takes_whole_requests_over_the_window():
    from portbench.metrics import tokens_per_s
    run = SimpleNamespace(window={"requests": 3, "seconds": 1.5},
                          mix={"batch": 8, "prompt_tokens": 4096, "max_new_tokens": 1})
    assert tokens_per_s.read(run) == pytest.approx(3 * 8 * 4097 / 1.5)


def test_window_closes_at_the_first_request_done_after_its_seconds(monkeypatch):
    """Requests of 0.2 s against a window of 0.5 s: the third ends past it,
    so the window holds three whole requests and the rate is theirs."""
    G = importlib.import_module("repro_torch.serving.generate")
    c = tiny.cell()
    vocab = c["config"]["vocab_size"]

    def slow(cfg, params, prompts, n, device=None, **kw):
        time.sleep(0.2)
        b = prompts.shape[0]
        return torch.zeros(b, n, dtype=torch.long), torch.zeros(b, n, vocab)

    monkeypatch.setattr(G, "generate", slow)
    result = harness.run(c, 11, 0.5, False, "cpu")
    assert result["attempted"] == 3
    rate = result["metrics"]["tokens_per_s"]["value"]
    assert rate == pytest.approx(16 * 41 / 0.2, rel=0.15)
    assert not math.isnan(rate)
