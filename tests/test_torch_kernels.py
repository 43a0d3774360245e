"""The port's attention kernel modules against the reference's Pallas kernels.

On the CPU the port's ``ops`` take their plain torch versions; the
reference's kernels run in interpret mode. Inputs are drawn with numpy from a
seed and rounded to the test dtype identically on both sides. Tolerances
are the reference's kernel tests': f32 2e-5, bf16 3e-2 (one bf16 rounding
of outputs of magnitude up to ~4). The CUDA kernels themselves run only on
the card (``chip_smoke.py``); here their dispatch, argument checks and
error paths are tested.
"""
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as ref_decode
from repro.kernels.flash_attn.ops import flash_attention as ref_flash
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.decode_attn import ops as DO
from repro_torch.kernels.flash_attn import kernel as FK
from repro_torch.kernels.flash_attn import ops as FO
from repro_torch.models.attention import decode_lengths

DTYPES = [("float32", 2e-5), ("bfloat16", 3e-2)]


def _both(x, dtype):
    """One numpy f32 array as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (1, 128, 2, 2, 64, True, 0, 0.0),
    (2, 256, 4, 2, 64, True, 0, 0.0),       # GQA
    (1, 128, 8, 1, 32, True, 64, 50.0),     # MQA + local + softcap
    (2, 192, 4, 4, 128, True, 0, 0.0),      # not a multiple of the block
    (1, 128, 2, 2, 64, False, 0, 0.0),      # bidirectional
    (1, 128, 8, 4, 256, True, 64, 50.0),    # gemma2-2b's heads, local + softcap
])
def test_flash_attention_matches_reference(b, s, hq, hkv, d, causal, window,
                                           cap, dtype, atol):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((b, s, hq, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((b, s, hkv, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((b, s, hkv, d), np.float32), dtype)
    ref = ref_flash(qj, kj, vj, causal=causal, window=window, softcap=cap,
                    interpret=True)
    out = FO.flash_attention(qt, kt, vt, causal=causal, window=window, softcap=cap)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 256, 4, 2, 64),
    (3, 512, 4, 4, 128),
    (1, 300, 8, 2, 32),                     # not a multiple of the block
    (2, 300, 8, 4, 256),                    # gemma2-2b's heads
    (2, 300, 24, 8, 64),                    # granite-moe's heads (G 3)
    (1, 200, 48, 8, 128),                   # nemotron's (G 6)
    (1, 130, 56, 8, 128),                   # arctic's (G 7)
    (2, 300, 16, 1, 256),                   # recurrentgemma's MQA (G 16)
])
def test_decode_attention_matches_reference(b, s, hq, hkv, d, dtype, atol):
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((b, 1, hq, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((b, s, hkv, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((b, s, hkv, d), np.float32), dtype)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    ref = ref_decode(qj, kj, vj, jnp.asarray(lens), interpret=True)
    out = DO.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, atol)


@pytest.mark.parametrize("cache_dtype,atol", DTYPES)
def test_decode_attention_wrapped_ring_lengths(cache_dtype, atol):
    """Lengths from a local layer's ring: rows before, at and past the wrap
    of a 16-slot ring; f32 queries against an f32 or bf16 cache, softcap."""
    rng = np.random.default_rng(2)
    b, w, hq, hkv, d = 4, 16, 4, 2, 32
    pos = torch.tensor([3, 15, 16, 40])
    lens = decode_lengths(pos, w, ring=True)
    assert lens.tolist() == [4, 16, 16, 16]
    qj, qt = _both(rng.standard_normal((b, 1, hq, d), np.float32), "float32")
    kj, kt = _both(rng.standard_normal((b, w, hkv, d), np.float32), cache_dtype)
    vj, vt = _both(rng.standard_normal((b, w, hkv, d), np.float32), cache_dtype)
    ref = ref_decode(qj, kj, vj, jnp.asarray(lens.numpy()), softcap=50.0,
                     interpret=True)
    out = DO.decode_attention(qt, kt, vt, lens, softcap=50.0)
    _close(out, ref, atol)


def _fake_cuda(shape):
    return types.SimpleNamespace(shape=shape, device=torch.device("cuda"))


def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached the plain version")


def test_ops_send_cuda_tensors_to_the_kernels_only(monkeypatch):
    calls = []
    monkeypatch.setattr(FK, "flash_attention_cuda",
                        lambda *a, **k: calls.append(("flash", k)) or "flash-out")
    monkeypatch.setattr(DK, "decode_attention_cuda",
                        lambda *a, **k: calls.append(("decode", k)) or "decode-out")
    monkeypatch.setattr(FO, "flash_attention_plain", _refuse)
    monkeypatch.setattr(FO, "attention_ref", _refuse)
    monkeypatch.setattr(DO, "decode_attention_plain", _refuse)
    monkeypatch.setattr(DO, "decode_ref", _refuse)
    q = _fake_cuda((1, 4, 2, 64))
    assert FO.flash_attention(q, q, q, window=8, softcap=5.0) == "flash-out"
    assert DO.decode_attention(q, q, q, q) == "decode-out"
    assert calls[0] == ("flash", {"scale": 0.125, "causal": True, "window": 8,
                                  "prefix_len": 0, "softcap": 5.0})
    assert calls[1] == ("decode", {"scale": 0.125, "softcap": 0.0})
    # one CUDA argument among CPU ones goes to the kernel too (which refuses it)
    cpu = torch.zeros((1, 4, 2, 64))
    assert FO.flash_attention(cpu, q, cpu) == "flash-out"
    assert DO.decode_attention(cpu, cpu, cpu, q) == "decode-out"


def test_ops_refuse_other_devices():
    q = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError):
        FO.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        DO.decode_attention(q[:, :1], q, q, torch.ones(1, dtype=torch.int32, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 4, 2, 32))
    before = (FK.flash_attention_cuda.launches, DK.decode_attention_cuda.launches)
    with pytest.raises(ValueError):
        FK.flash_attention_cuda(q, q, q, scale=1.0)
    with pytest.raises(ValueError):
        DK.decode_attention_cuda(q[:, :1], q, q, torch.ones(1, dtype=torch.int32), scale=1.0)
    assert (FK.flash_attention_cuda.launches, DK.decode_attention_cuda.launches) == before


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise, with its output."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build(["decode_attn", "flash_attn"])
    assert not list(tmp_path.glob("*.so"))


def test_build_times_each_source_on_its_own(monkeypatch, tmp_path):
    """Sources build in parallel, and each reports its own nvcc seconds and
    output, not those of the slowest build before it."""
    delays = {"decode_attn": 0.6, "flash_attn": 0.05}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def fake_nvcc(src, out):
        name = src.parent.parent.name
        return ["sh", "-c", f"sleep {delays[name]}; echo built {name}; touch {out}"]

    monkeypatch.setattr(_build, "nvcc_command", fake_nvcc)
    built = _build.build(["decode_attn", "flash_attn"])
    assert built["flash_attn"].seconds < 0.4 <= built["decode_attn"].seconds
    assert built["flash_attn"].log.strip() == "built flash_attn"
    assert all(b.path.is_file() for b in built.values())
    assert _build.build(["flash_attn"])["flash_attn"].seconds == 0.0   # already built


def test_failed_launch_raises():
    lib = types.SimpleNamespace(k_error_string=lambda code: b"invalid argument")
    _build.check(lib, "k", 0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.check(lib, "k", 1)


@pytest.mark.parametrize("batch,hkv,s", [(4, 4, 4096), (4, 4, 4640), (1, 1, 7),
                                         (2, 2, 300), (64, 8, 2048)])
def test_decode_split_plan_covers_the_cache(batch, hkv, s):
    splits = DK.split_plan(batch, hkv, s, sm_count=132)
    ranges = [DK.split_range(s, s, splits, i) for i in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_build_digest_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edited shared header gives every kernel a new library name, so it
    is rebuilt; a file that is not a header changes nothing."""
    (tmp_path / "k" / "csrc").mkdir(parents=True)
    (tmp_path / "k" / "csrc" / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    first = _build._paths("k")[1]
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert _build._paths("k")[1] == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._paths("k")[1] != first


def test_every_included_header_is_on_the_include_path(monkeypatch):
    """Each quoted #include of a kernel source names a shared header that
    nvcc finds through its -I, and that the digest covers."""
    import re
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command(_build.source("decode_attn"), Path("out.so"))
    include = Path(cmd[cmd.index("-I") + 1])
    for name in ("ciao_gather", "decode_attn", "flash_attn"):
        for header in re.findall(r'#include "([^"]+)"', _build.source(name).read_text()):
            assert (include / header) in _build.headers(), (name, header)


@pytest.mark.parametrize("hq,hkv,d,ok", [
    (24, 8, 64, True), (48, 8, 128, True), (56, 8, 128, True), (64, 8, 128, True),
    (24, 8, 128, True), (12, 4, 64, True),
    (24, 8, 32, False), (24, 8, 256, False), (56, 8, 256, False),   # no G 3/6/7 there
    (40, 8, 128, False), (128, 8, 128, False), (128, 8, 256, "ring"),  # G 5, 16
    (16, 1, 256, "ring"), (16, 1, 128, False), (32, 2, 64, False),   # recurrentgemma's G 16
    (8, 3, 128, False), (8, 4, 96, False),
    (16, 1, 64, False), (128, 8, 64, False), (48, 8, 64, True), (56, 8, 64, True),  # G 16, 6, 7
    (24, 8, 128, True), (8, 8, 128, True), (16, 8, 64, True), (64, 8, 64, True),    # G 3, 1, 2, 8
    (40, 8, 64, False), (112, 8, 128, False),                                      # G 5, 14
])
def test_decode_wrapper_refuses_groups_the_kernel_lacks(hq, hkv, d, ok):
    """The wrapper's table of (G, D): G 1, 2, 4, 8 everywhere, 3, 6, 7 at D
    64 and 128 (on both kernels: the ring kernel takes bf16 q and cache
    there), 16 on the ring kernel at D 256 only; anything else raises before
    a launch."""
    for q_dtype, kv_dtype in DK.DTYPE_PAIRS:
        if ok is True or ok == "ring" and DK.uses_ring(q_dtype, kv_dtype, d):
            DK.check_supported(hq, hkv, d, q_dtype, kv_dtype)
        else:
            with pytest.raises(ValueError, match="group|head_dim"):
                DK.check_supported(hq, hkv, d, q_dtype, kv_dtype)
    with pytest.raises(ValueError, match="dtypes"):
        DK.check_supported(hq, hkv, d, torch.bfloat16, torch.float32)


def test_decode_group_table_matches_the_source():
    """``kernel.GROUPS``/``ODD_GROUPS``/``RING_GROUPS`` are the cases
    decode_attn.cu instantiates: the split kernel's ``launch_d`` switch (odd
    groups under ``kOddGroups``, whose head dims are ``ODD_GROUP_DIMS``),
    the ring kernel's ``launch_ring_d`` switch at each of ``RING_DIMS``
    (GROUPS, the odd groups under ``kOddGroups`` at D 64 and 128, and
    RING_GROUPS at ``RING_GROUP_DIMS`` only), and the dispatch that sends
    bf16 q and cache at ``RING_DIMS`` to the ring kernel and nowhere else."""
    import re
    src = _build.source("decode_attn").read_text()
    launch_d = src[src.index("cudaError_t launch_d("):src.index("cudaError_t launch_t(")]
    cases = [int(c) for c in re.findall(r"case (\d+):", launch_d)]
    odd = [int(c) for c in re.findall(r"case (\d+):\s*\n\s*if constexpr \(kOddGroups", launch_d)]
    assert sorted(set(cases) - set(odd)) == sorted(DK.GROUPS)
    assert sorted(odd) == sorted(DK.ODD_GROUPS)
    dims = re.search(r"kOddGroups = (.*);", src).group(1)
    assert sorted(int(x) for x in re.findall(r"D == (\d+)", dims)) == sorted(DK.ODD_GROUP_DIMS)
    ring = src[src.index("cudaError_t launch_ring_d("):src.index('extern "C"')]
    ring = ring[:ring.index("default:")]
    ring_cases = [int(c) for c in re.findall(r"case (\d+):", ring)]
    ring_odd = [int(c) for c in
                re.findall(r"case (\d+):\s*\n\s*if constexpr \(kOddGroups", ring)]
    ring_wide = re.findall(r"case (\d+):\s*\n\s*if constexpr \(D == (\d+)\)", ring)
    assert sorted(ring_cases) == sorted(DK.GROUPS + DK.ODD_GROUPS + DK.RING_GROUPS)
    assert sorted(ring_odd) == sorted(DK.ODD_GROUPS)
    assert sorted(int(g) for g, _ in ring_wide) == sorted(DK.RING_GROUPS)
    assert sorted({int(d) for _, d in ring_wide}) == sorted(DK.RING_GROUP_DIMS)
    assert not set(DK.RING_GROUPS) & set(cases)      # the split kernel has no G 16
    # the dispatch: bf16 q and cache at RING_DIMS to the ring kernel
    entry = src[src.index("if (q_dtype == 1 && kv_dtype == 1) {"):]
    entry = entry[:entry.index("default:")]
    assert sorted(int(d) for d in re.findall(r"case (\d+): return launch_ring_d<\1>", entry)) \
        == sorted(DK.RING_DIMS)
    # the split kernel keeps no bf16 instantiation at RING_DIMS
    launch_t = src[src.index("cudaError_t launch_t("):src.index("cudaError_t launch_ring_d(")]
    guarded = re.findall(r"case (\d+):\s*\n\s*if constexpr \(!kRingDtypes\)", launch_t)
    assert sorted(int(d) for d in guarded) == sorted(DK.RING_DIMS)
    assert "kRingDtypes = std::is_same_v<TQ, __nv_bfloat16>" in launch_t
