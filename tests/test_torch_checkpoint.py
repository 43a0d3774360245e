"""The port's checkpoints and trainer: ``tests/test_checkpoint.py``'s and
``tests/test_train.py``'s trainer cases mirrored, plus what the port's
in-place state and bf16 tensors need: a bf16 round trip that is
bit-exact, an async save followed at once by an in-place update, and a
manifest whose fingerprint is the reference's."""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro_torch import configs as C
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.train import checkpoint as CK
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig
from repro_torch.train.tree import tree_leaves, tree_map


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=gen), "b": torch.zeros(8)},
            "opt": {"m": torch.ones(4, 8), "count": torch.zeros((), dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_exact(tmp_path):
    s = _state()
    CK.save(s, tmp_path, step=7, fingerprint="abc")
    restored, step = CK.restore(s, tmp_path, fingerprint="abc")
    assert step == 7
    _assert_equal(s, restored)


def test_fingerprint_mismatch(tmp_path):
    CK.save(_state(), tmp_path, step=1, fingerprint="abc")
    with pytest.raises(ValueError, match="fingerprint"):
        CK.restore(_state(), tmp_path, fingerprint="xyz")


def test_gc_keeps_latest(tmp_path):
    for step in (1, 2, 3, 4, 5):
        CK.save(_state(), tmp_path, step=step, keep=2)
    steps = sorted(int(p.name.split("_")[1]) for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [4, 5]
    assert CK.latest_step(tmp_path) == 5
    assert CK.latest_step(tmp_path / "none") is None


def test_no_partial_checkpoints_visible(tmp_path):
    CK.save(_state(), tmp_path, step=3)
    for p in pathlib.Path(tmp_path).glob("step_*"):
        assert (p / "manifest.json").exists()
        assert (p / "arrays.npz").exists()
    assert not list(pathlib.Path(tmp_path).glob(".tmp_*"))


def test_async_checkpointer(tmp_path):
    ck = CK.AsyncCheckpointer(tmp_path, keep=2)
    s = _state()
    ck.save(s, 1)
    ck.save(s, 2)      # implicitly waits for step 1
    ck.wait()
    assert CK.latest_step(tmp_path) == 2


def test_restore_onto_a_device_from_a_meta_struct(tmp_path):
    """The elastic path: restore onto an explicit device from a tree of
    shapes and dtypes only: the same bytes."""
    s = _state()
    CK.save(s, tmp_path, step=1)
    like = tree_map(lambda t: torch.empty_like(t, device="meta"), s)
    restored, _ = CK.restore(like, tmp_path, device="cpu")
    _assert_equal(s, restored)


def test_shape_mismatch_rejected(tmp_path):
    CK.save(_state(), tmp_path, step=1)
    bad = _state()
    bad["params"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.restore(bad, tmp_path)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CK.restore(_state(), tmp_path)


def test_bf16_roundtrip_is_bit_exact(tmp_path):
    """numpy has no bf16: the raw 16 bits go to disk, the manifest names
    the dtype, and every bit comes back (NaN payloads, -0, subnormals)."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    state = {"w": bits.view(torch.bfloat16).reshape(256, 256),
             "scale": torch.randn(5), "step": torch.tensor(3, dtype=torch.int32)}
    CK.save(state, tmp_path, step=3)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"w": "bfloat16", "scale": "float32", "step": "int32"}
    restored, _ = CK.restore(state, tmp_path)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), state["w"].view(torch.int16))
    assert torch.equal(restored["scale"], state["scale"])


def test_async_save_then_in_place_update_keeps_the_saved_values(tmp_path):
    """The port updates its state in place: the async save snapshots the
    state before it returns, so an update right after it does not reach
    the checkpoint."""
    s = _state()
    before = tree_map(torch.clone, s)
    ck = CK.AsyncCheckpointer(tmp_path)
    ck.save(s, 1)
    for t in tree_leaves(s):
        t.add_(1)                      # the next step, in place, at once
    ck.wait()
    restored, _ = CK.restore(s, tmp_path)
    _assert_equal(before, restored)


def test_train_state_roundtrip_and_fingerprint(tmp_path):
    """A bf16 train state (AdamW) saved under the config's fingerprint,
    which equals the reference's, and restored from its meta struct."""
    cfg, run = C.reduced_config("gemma2-2b"), RunConfig()
    assert cfg.fingerprint() == ref_reduced_config("gemma2-2b").fingerprint()
    state = TS.init_train_state(cfg, run, torch.Generator().manual_seed(0), "cpu")
    CK.save(state, tmp_path, 0, fingerprint=cfg.fingerprint())
    restored, step = CK.restore(TS.train_state_struct(cfg, run), tmp_path, device="cpu",
                                fingerprint=cfg.fingerprint())
    assert step == 0
    _assert_equal(state, restored)
    assert restored["params"]["embed"]["table"].dtype == torch.bfloat16


# ----------------------------------------------------------------- trainer
def test_trainer_loss_falls_and_resumes(tmp_path):
    cfg = C.reduced_config("qwen3-4b")
    run = RunConfig(remat_policy="none", learning_rate=3e-3, warmup_steps=10,
                    param_dtype="float32")
    shape = ShapeConfig(name="t", seq_len=64, global_batch=8, mode="train")
    tc = TrainerConfig(total_steps=50, checkpoint_every=15, checkpoint_dir=str(tmp_path),
                       log_every=10, async_checkpoint=False)
    t = Trainer(cfg, run, shape, tc, fail_at_step=20, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        t.run_loop()
    # restart resumes from step 15 and finishes
    t2 = Trainer(cfg, run, shape, tc, device="cpu")
    out = t2.run_loop()
    losses = out["losses"]
    assert len(losses) == 35                       # 50 - resumed step 15
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) + 0.5
    assert int(out["state"]["step"]) == 50
    assert CK.latest_step(tmp_path) == 45


def test_trainer_async_resume_continues_the_unbroken_run(tmp_path):
    """With async saves every 3 steps and a failure at step 4, the resumed
    run's steps 3..7 give the unbroken run's losses."""
    cfg = C.reduced_config("gemma2-2b")
    run = RunConfig(remat_policy="dots", learning_rate=3e-3, warmup_steps=2,
                    param_dtype="float32")
    shape = ShapeConfig(name="t", seq_len=32, global_batch=2, mode="train")
    unbroken = Trainer(cfg, run, shape, TrainerConfig(total_steps=8, log_every=1),
                       device="cpu").run_loop()["losses"]
    tc = TrainerConfig(total_steps=8, checkpoint_every=3, checkpoint_dir=str(tmp_path),
                       log_every=1)
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(cfg, run, shape, tc, fail_at_step=4, device="cpu").run_loop()
    resumed = Trainer(cfg, run, shape, tc, device="cpu")
    batches = list(_take(8, cfg, shape))
    out = resumed.run_loop(batches=batches)
    np.testing.assert_allclose(out["losses"], unbroken[3:], rtol=1e-6)


def _take(n, cfg, shape):
    from repro_torch.train.data import SyntheticLM
    it = SyntheticLM(cfg).batches(shape, "cpu")
    return [next(it) for _ in range(n)]


def test_straggler_monitor():
    hits = []
    mon = StragglerMonitor(threshold=3.0, on_straggler=lambda s, dt, e: hits.append(s))
    for i in range(10):
        mon.observe(i, 1.0)
    assert not mon.events
    mon.observe(10, 10.0)
    assert mon.events == [10] and hits == [10]
    # outlier must not poison the EWMA
    assert mon.ewma == pytest.approx(1.0, rel=0.01)


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(C.reduced_config("gemma2-2b"), RunConfig(),
                ShapeConfig(name="t", seq_len=8, global_batch=1, mode="train"), TrainerConfig())


def test_train_module_runs_on_the_cpu_and_resumes(tmp_path):
    """``python -m repro_torch.train --device cpu``: trains 50 steps,
    checkpoints at step 50 (every 50), and a second run with the same
    directory resumes there, with nothing left to train."""
    import os
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "repro_torch.train", "--device", "cpu", "--steps", "50",
           "--seq", "16", "--batch", "2", "--ckpt", str(tmp_path)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "trained 50 steps on cpu" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0 and "nothing to train" in again.stdout
