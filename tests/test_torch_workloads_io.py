"""The port's workload io, curated set and ``core.traces`` shim against the
reference: the versioned npz format reads and writes the same files in both
packages (a workload saved by either loads in the other with equal tokens
and header), the format, line-size and checksum guards, and the shipped
curated set. Mirrors ``tests/test_workloads.py``'s on-disk and curated
tests on the port's copies."""
import json

import numpy as np
import pytest

from repro.workloads import load_workload as ref_load
from repro.workloads import make_workload as ref_make
from repro.workloads import save_workload as ref_save
from repro.workloads.io import FORMAT_VERSION as REF_FORMAT_VERSION
from repro_torch.workloads import (FORMAT_VERSION, encode_workload,
                                   load_workload, make_workload,
                                   save_workload)

DEP_EVERY = 2


def _header(path):
    with np.load(path, allow_pickle=False) as npz:
        return json.loads(str(npz["header"]))


def _assert_same_traces(a, b):
    assert len(a.traces) == len(b.traces)
    for (k0, a0), (k1, a1) in zip(a.traces, b.traces):
        assert np.array_equal(k0, k1) and np.array_equal(a0, a1)
    assert (a.name, a.klass, a.smem_used_bytes, a.n_wrp, a.apki) == \
        (b.name, b.klass, b.smem_used_bytes, b.n_wrp, b.apki)
    assert encode_workload(a.traces, DEP_EVERY) == \
        encode_workload(b.traces, DEP_EVERY)


def test_traces_shim_reexports():
    from repro_torch.core import traces
    import repro_torch.workloads as w
    assert traces.make_workload is w.make_workload
    assert traces.WORKLOADS is w.WORKLOADS
    assert traces.Workload is w.Workload


def test_core_and_workloads_export_the_io():
    import repro_torch.core as core
    import repro_torch.workloads as w
    assert core.load_workload is w.load_workload is load_workload
    assert core.save_workload is w.save_workload is save_workload
    assert FORMAT_VERSION == REF_FORMAT_VERSION == 2


@pytest.mark.parametrize("name", ["syrk", "nw", "gather"])
def test_each_package_loads_the_others_files(tmp_path, name):
    """A workload saved by the port loads in the reference and the other
    way round, with equal traces, tokens and header; the two files hold
    the same arrays."""
    mine = make_workload(name, seed=3, scale=0.1)
    ref = ref_make(name, seed=3, scale=0.1)
    p_mine = save_workload(mine, tmp_path / "mine")
    p_ref = ref_save(ref, tmp_path / "ref")
    assert _header(p_mine) == _header(p_ref)
    _assert_same_traces(ref_load(p_mine), ref)
    _assert_same_traces(load_workload(p_ref), mine)
    with np.load(p_mine) as a, np.load(p_ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k])


def test_format_version_guard(tmp_path):
    bad = tmp_path / "bad.npz"
    header = json.dumps({"format": 99, "num_warps": 0, "line": 128})
    np.savez(bad, header=np.array(header))
    with pytest.raises(ValueError, match="unsupported workload format"):
        load_workload(bad)


def test_line_size_guard(tmp_path):
    bad = tmp_path / "bad.npz"
    header = json.dumps({"format": 1, "num_warps": 0, "line": 64})
    np.savez(bad, header=np.array(header))
    with pytest.raises(ValueError, match="line size"):
        load_workload(bad)


def test_content_checksum_round_trip(tmp_path):
    """v2 files carry a CRC-32 over the trace content, equal to the
    reference's; a clean save -> load round trip verifies it."""
    from repro.workloads.io import _traces_crc as ref_crc
    from repro_torch.workloads.io import _traces_crc
    wl = make_workload("syrk", seed=3, scale=0.1)
    path = save_workload(wl, tmp_path / "syrk")
    back = load_workload(path)
    for (k0, a0), (k1, a1) in zip(wl.traces, back.traces):
        assert np.array_equal(k0, k1) and np.array_equal(a0, a1)
    as_arrays = [(np.asarray(k, np.uint8), np.asarray(a, np.int64))
                 for k, a in wl.traces]
    assert _traces_crc(wl.traces) == _traces_crc(as_arrays) == ref_crc(wl.traces)
    assert _header(path)["crc"] == _traces_crc(wl.traces)


def test_content_checksum_detects_tampering(tmp_path):
    """Flipping one address in a saved file fails the checksum in both
    packages; a v1 file (no crc in the header) still loads."""
    wl = make_workload("syrk", seed=3, scale=0.1)
    path = save_workload(wl, tmp_path / "syrk")
    with np.load(path, allow_pickle=False) as npz:
        arrays = {k: npz[k] for k in npz.files}
    arrays["addrs_0"] = arrays["addrs_0"].copy()
    arrays["addrs_0"][0] ^= 128
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    for load in (load_workload, ref_load):
        with pytest.raises(ValueError, match="content checksum"):
            load(path)
    header = json.loads(str(arrays["header"]))
    del header["crc"]
    header["format"] = 1
    arrays["header"] = np.array(json.dumps(header))
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    assert load_workload(path).name == "syrk"


def test_curated_dir_is_the_shipped_set():
    """Three parents up from the port's module is the repo root, as from
    the reference's: both resolve to results/workloads/curated."""
    from repro.workloads import curated as ref_curated
    from repro_torch.workloads import curated
    assert curated.curated_dir() == ref_curated.curated_dir()
    assert curated.curated_dir().parts[-3:] == ("results", "workloads", "curated")
    assert (curated.curated_dir() / curated.MANIFEST).exists()


def test_curated_manifest_intact(monkeypatch):
    """The shipped curated trace set matches its checksum manifest and
    loads into the traces the port's generators produce."""
    from repro_torch.core.runner import workload_seed
    from repro_torch.workloads import curated
    assert curated.verify_manifest() == []
    files = curated.load_manifest()
    assert len(files) == 6
    name, scale = "syrk", curated.DEFAULT_SCALE
    seed = workload_seed(curated.DEFAULT_SEED, name)
    assert curated.load_curated(name, seed, scale) is None  # REPRO_NO_CURATED
    monkeypatch.delenv("REPRO_NO_CURATED")
    for fname in files:
        stem = fname[:-len(".npz")]
        wname, rest = stem.split("-s", 1)
        s, x = rest.split("-x", 1)
        wl = curated.load_curated(wname, int(s), float(x))
        _assert_same_traces(wl, make_workload(wname, seed=int(s), scale=float(x)))
    assert curated.load_curated("syrk", 1, 0.123) is None   # not shipped


def test_curated_checksum_mismatch_raises(tmp_path, monkeypatch):
    """A tampered curated file fails loudly, not feeding stale traces."""
    from repro_torch.workloads import curated
    monkeypatch.delenv("REPRO_NO_CURATED", raising=False)
    monkeypatch.setenv("REPRO_CURATED_DIR", str(tmp_path))
    fname = "kmn-s1-x0.1.npz"
    (tmp_path / fname).write_bytes(b"not an npz")
    (tmp_path / "MANIFEST.json").write_text(json.dumps(
        {"version": 1, "files": {fname: "0" * 64}}))
    with pytest.raises(ValueError, match="checksum"):
        curated.load_curated("kmn", 1, 0.1)
    assert curated.verify_manifest(tmp_path) == [
        f"checksum mismatch: {fname}"]


def test_curated_build_equals_the_reference(tmp_path):
    """``build`` writes the manifest the reference's writes for the same
    slice: equal files, equal checksums."""
    from repro.workloads import curated as ref_curated
    from repro_torch.workloads import curated
    mine = curated.build(("syrk",), 0.05, 0, root=tmp_path / "mine")
    ref = ref_curated.build(("syrk",), 0.05, 0, root=tmp_path / "ref")
    assert curated.load_manifest(mine) == ref_curated.load_manifest(ref)
    assert curated.verify_manifest(mine) == []


def test_workload_cache_shared_with_the_reference(tmp_path, monkeypatch):
    """The runner's on-disk cache: an entry the reference wrote is loaded
    by the port (and the other way round) with equal traces."""
    import repro.core.runner as ref_runner
    import repro_torch.core.runner as runner
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path))
    ref_runner._cached_workload.cache_clear()
    runner._cached_workload.cache_clear()
    ref_wl = ref_runner._cached_workload("kmn", 77, 0.05)
    (entry,) = tmp_path.glob("*.npz")
    assert entry.name == "kmn-s77-x0.05.npz"
    mine = runner._cached_workload("kmn", 77, 0.05)
    _assert_same_traces(mine, ref_wl)
    assert list(tmp_path.glob("*.npz")) == [entry]
    runner._cached_workload.cache_clear()
    ref_runner._cached_workload.cache_clear()
