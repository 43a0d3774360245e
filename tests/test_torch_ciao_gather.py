"""The port's CIAO cached gather (K1) and its index stream against the
reference.

The reference's Pallas kernel raises on this tree's JAX (``pl.load`` is
gone), so the port is held against the reference's oracles ``gather_ref`` and
``cache_sim_ref``, which compute the same function. Inputs are drawn with
numpy from a seed and handed to both sides. Everything is compared exactly:
rows bit for bit, counts as integers. The CUDA kernel runs only on the card
(``chip_smoke.py``); here its dispatch and argument checks are tested.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ciao_gather.ref import cache_sim_ref as ref_cache_sim
from repro.kernels.ciao_gather.ref import gather_ref as ref_gather
from repro.workloads.derived import gather_index_stream as ref_index_stream
from repro_torch.kernels.ciao_gather import kernel as CK
from repro_torch.kernels.ciao_gather import ops as CO
from repro_torch.workloads import gather_index_stream

DTYPES = ["float32", "bfloat16"]


def _tables(n, d, dtype, seed=2):
    """One numpy f32 table as a jax array and a torch tensor of ``dtype``."""
    x = np.random.default_rng(seed).standard_normal((n, d), np.float32)
    return jnp.asarray(x, dtype=getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _held(table_j, table_t, idx, streams, iso, c_main, c_iso):
    """The port's ops.ciao_gather (plain path) equals the reference's
    oracles bit for bit; returns the port's stats."""
    out, stats = CO.ciao_gather(table_t, torch.from_numpy(idx), torch.from_numpy(streams),
                                torch.from_numpy(iso), c_main=c_main, c_iso=c_iso)
    ref_out = np.asarray(ref_gather(table_j, jnp.asarray(idx)).astype(jnp.float32))
    assert out.dtype == table_t.dtype and out.shape == (len(idx), table_t.shape[1])
    np.testing.assert_array_equal(out.float().numpy(), ref_out)
    ref_stats = ref_cache_sim(idx, streams, iso, c_main=c_main, c_iso=c_iso,
                              num_streams=len(iso))
    assert stats.dtype == torch.int32 and stats.shape == (len(iso), 2)
    np.testing.assert_array_equal(stats.numpy(), ref_stats)
    return stats.numpy()


def _kernel_test_inputs(n, t, seed=0):
    """The reference kernel test's trace: 4 streams, stream 3 isolated and
    hammering 8 rows, the others uniform over the table."""
    rng = np.random.default_rng(seed)
    streams = rng.integers(0, 4, t).astype(np.int32)
    idx = np.where(streams == 3, rng.integers(0, 8, t), rng.integers(0, n, t)).astype(np.int32)
    return idx, streams, np.array([0, 0, 0, 1], np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d,t,c_main,c_iso", [
    (500, 128, 384, 64, 16),
    (1000, 256, 640, 128, 32),
    (64, 128, 130, 16, 8),                  # tiny cache, T not a multiple of a tile
    (500, 128, 384, 64, 0),                 # no isolated slots: one shared slot
    (500, 96, 1, 64, 16),                   # one request
])
def test_ciao_gather_matches_reference(n, d, t, c_main, c_iso, dtype):
    table_j, table_t = _tables(n, d, dtype)
    idx, streams, iso = _kernel_test_inputs(n, t)
    _held(table_j, table_t, idx, streams, iso, c_main, c_iso)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ciao_gather_streams_without_requests(dtype):
    """Streams 1, 4 and 6 issue nothing: their rows of stats are zero, and
    the isolated stream 5 has the isolated slots to itself."""
    rng = np.random.default_rng(3)
    n, t = 300, 500
    table_j, table_t = _tables(n, 64, dtype)
    streams = rng.choice(np.array([0, 2, 3, 5], np.int32), t)
    idx = rng.integers(0, n, t).astype(np.int32)
    iso = np.array([0, 0, 1, 0, 0, 1, 0], np.int32)
    stats = _held(table_j, table_t, idx, streams, iso, 32, 8)
    assert not stats[[1, 4, 6]].any() and stats[[0, 2, 3, 5]].sum() == t


def test_ciao_gather_isolation_protects_main():
    """The reference's kernel-level CIAO property at its own sizes:
    isolating the stream that sweeps the table cuts the other streams'
    misses by more than 3x."""
    rng = np.random.default_rng(1)
    n, d, t = 256, 128, 2048
    table_j, table_t = jnp.ones((n, d), jnp.float32), torch.ones((n, d))
    streams = rng.integers(0, 4, t).astype(np.int32)
    priv = (streams[:, None] * 8 + rng.integers(0, 8, (t, 1))).ravel()
    sweep = rng.integers(0, n, t)
    idx = np.where(streams == 3, sweep, priv).astype(np.int32)

    def misses(iso_bit):
        iso = np.array([0, 0, 0, iso_bit], np.int32)
        return _held(table_j, table_t, idx, streams, iso, 32, 16)[:3, 1].sum()

    assert misses(1) < misses(0) / 3


@pytest.mark.parametrize("table_rows", [4096, 256000])
@pytest.mark.parametrize("scale", [1.0, 0.2])
@pytest.mark.parametrize("seed", [0, 5])
def test_gather_index_stream_equals_the_reference(seed, scale, table_rows):
    port = gather_index_stream(seed, scale, table_rows=table_rows)
    ref = ref_index_stream(seed, scale, table_rows=table_rows)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_gather_path_at_full_table_rows():
    """The slice as a whole: the port's trace of the chip path (seed 0,
    scale 1.0, gemma2-2b's 256000 rows) through ops.ciao_gather, with and
    without isolation, against the reference's trace through its oracles.
    The rows are 8 wide here; the card runs them 2304 wide."""
    indices, streams, iso = gather_index_stream(0, 1.0, table_rows=256000)
    r_indices, r_streams, r_iso = ref_index_stream(0, 1.0, table_rows=256000)
    assert len(indices) == 72000 and len(iso) == 48 and iso.sum() == 6
    table_j, table_t = _tables(256000, 8, "bfloat16", seed=4)
    idx = indices.astype(np.int32)
    np.testing.assert_array_equal(idx, r_indices.astype(np.int32))
    for bits in (iso, np.zeros_like(iso)):
        stats = _held(table_j, table_t, idx, streams, bits, 256, 64)
        assert stats.sum() == len(idx)


def test_plain_version_refuses_out_of_range_requests():
    table = torch.zeros((10, 4))
    iso = torch.zeros(2, dtype=torch.int32)
    ok = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="indices"):
        CO.ciao_gather(table, torch.tensor([0, 10, 1]), ok, iso)
    with pytest.raises(ValueError, match="indices"):
        CO.ciao_gather(table, torch.tensor([0, -1, 1]), ok, iso)
    with pytest.raises(ValueError, match="streams"):
        CO.ciao_gather(table, ok, torch.tensor([0, 2, 1]), iso)


def test_ops_send_cuda_tensors_to_the_kernel_only(monkeypatch):
    calls = []
    monkeypatch.setattr(CK, "ciao_gather_cuda",
                        lambda *a, **k: calls.append(k) or "kernel-out")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(CO, "ciao_gather_plain", refuse)
    monkeypatch.setattr(CO, "gather_ref", refuse)
    monkeypatch.setattr(CO, "cache_sim_ref", refuse)
    cuda = types.SimpleNamespace(device=torch.device("cuda"), to=lambda dtype: cuda)
    cpu = torch.zeros(4, dtype=torch.int32)
    assert CO.ciao_gather(cuda, cuda, cuda, cuda) == "kernel-out"
    # one CUDA argument among CPU ones goes to the kernel too (which refuses it)
    assert CO.ciao_gather(torch.zeros((4, 8)), cpu, cpu, cuda, c_main=16, c_iso=0) == "kernel-out"
    assert calls == [{"c_main": 256, "c_iso": 64}, {"c_main": 16, "c_iso": 0}]


def test_ops_refuse_other_devices():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        CO.ciao_gather(torch.empty((4, 8), device="meta"), meta, meta, meta)


def test_kernel_wrapper_refuses_cpu_tensors():
    idx = torch.zeros(4, dtype=torch.int32)
    before = CK.ciao_gather_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        CK.ciao_gather_cuda(torch.zeros((4, 8)), idx, idx, idx[:1], c_main=4, c_iso=1)
    assert CK.ciao_gather_cuda.launches == before
