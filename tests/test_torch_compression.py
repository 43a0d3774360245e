"""The port's int8 gradient compression against the reference's
``parallel/compression.py``: ``quantize_int8`` and ``dequantize_int8`` bit
for bit on seeded f32 inputs (one scale a tensor and one a slice), the
reference's round-trip bound (``tests/test_sharding.py``) mirrored, and
``pod_mean_compressed`` at npod 2 and 4 over three steps of error
feedback against the reference's on a one-device ("pod", "data",
"model") mesh: the means and the carried errors bit for bit too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.parallel import compression as RC
from repro_torch.parallel import compression as C
from repro_torch.train.tree import tree_leaves


def _draws(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale
    # ties of the rounding: exact halves of the scale, and zeros
    x.reshape(-1)[:4] = [0.0, -0.0, 1.5, -2.5]
    return x


@pytest.mark.parametrize("shape,axes", [((128,), None), ((16, 33), None), ((4, 8, 5), (1, 2)),
                                        ((3, 64), (1,)), ((2, 7, 9), (1,))])
def test_quantize_and_dequantize_are_bit_equal(shape, axes):
    x = _draws(sum(shape), shape)
    q, s = C.quantize_int8(torch.from_numpy(x), axes)
    rq, rs = RC.quantize_int8(jnp.asarray(x), axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(RC.dequantize_int8(rq, rs)))


def test_round_half_to_even_as_the_reference():
    """Codes of exact halves: torch.round and jnp.round both go to even."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5], np.float32)
    q, _ = C.quantize_int8(torch.from_numpy(x))
    assert q.tolist() == np.asarray(RC.quantize_int8(jnp.asarray(x))[0]).tolist()
    assert q.tolist()[1:6] == [0, 2, 2, 0, -2]


def test_compression_roundtrip_quality():
    x = torch.from_numpy(_draws(0, (128,)))
    q, s = C.quantize_int8(x)
    err = (C.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.51 + 1e-6   # half-ULP of the scale


@pytest.mark.parametrize("npod", [2, 4])
def test_pod_mean_compressed_matches_the_reference(npod):
    shapes = {"w": (16, 24), "stack": (3, 8, 5), "vec": (32,)}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), ("pod", "data", "model"))
    err = {k: np.zeros((npod,) + s, np.float32) for k, s in shapes.items()}
    ref_err = jax.tree.map(jnp.asarray, err)
    err = {k: torch.from_numpy(v) for k, v in err.items()}
    for step in range(3):
        g = {k: _draws(100 * step + i, (npod,) + s, 0.1) for i, (k, s) in enumerate(shapes.items())}
        mean, err = C.pod_mean_compressed({k: torch.from_numpy(v) for k, v in g.items()}, err)
        ref_mean, ref_err = RC.pod_mean_compressed(jax.tree.map(jnp.asarray, g), ref_err, mesh)
        for k in shapes:
            np.testing.assert_array_equal(mean[k].numpy(), np.asarray(ref_mean[k]),
                                          err_msg=f"step {step} mean {k}")
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(ref_err[k]),
                                          err_msg=f"step {step} err {k}")
            assert mean[k].shape == shapes[k] and err[k].shape == (npod,) + shapes[k]


def test_init_error_feedback_stacks_zeros_a_pod():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(5)]}
    err = C.init_error_feedback(params, 2)
    assert [tuple(t.shape) for t in tree_leaves(err)] == [(2, 3, 4), (2, 5)]
    assert all(t.dtype == torch.float32 and not t.any() for t in tree_leaves(err))
