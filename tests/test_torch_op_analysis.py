"""The port's per-rank op analysis (``launch/op_analysis.py``) against the
reference's HLO analysis (``launch/hlo_analysis.py``).

The reference's contract (``tests/test_hlo_analysis.py``): a plain matmul
counts exactly 2·32·48·16 FLOPs and no collective bytes, a loop counts its
body each time. Per rank: a product of DTensors on a fake 8-rank mesh counts
one rank's local product, the same on its first and second call (the
sharding propagator's cached shape inference is not counted), and an
all-gather over K ranks counts its result's bytes times (K-1)/K. The fake
process group is process-global, so the mesh cases run in a subprocess.

Reduced gemma2-2b, mamba2-2.7b and seamless-m4t-medium, one train step,
one prefill and one decode step on one device (the meta device: shapes
only), count within 1% of the reference's ``analyze`` of the same cell
jitted and compiled as ``tests/test_system.py`` does, the train step under
remat "dots". gemma2 counts exactly the reference's FLOPs under remat
"none"; under remat "full" the reference counts one MLP output product a
repeat of the block pattern more in the recomputation, which the port's
per-layer checkpoint does not redo (``PERF.md`` §6).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.launch import hlo_analysis as H
from repro.models import model as RM
from repro.parallel.sharding import local_env
from repro.train import train_step as RTS
from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import op_analysis as OA
from repro_torch.models import model as M
from repro_torch.train import train_step as TS

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("train", 32), ("prefill", 32), ("decode", 64)]
ARCHS = ["gemma2-2b", "mamba2-2.7b", "seamless-m4t-medium"]


def test_plain_matmul_counts_exactly():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    res = OA.analyze(lambda: a @ b)
    assert res["flops"] == 2 * 32 * 48 * 16
    assert res["collective_total_effective"] == 0 and res["collective_num_ops"] == 0
    assert res["bytes"] == 4 * (32 * 48 + 48 * 16 + 32 * 16)


def test_a_loop_counts_each_trip():
    w, x = torch.randn(64, 64), torch.randn(8, 64)

    def loop(n):
        c = x
        for _ in range(n):
            c = torch.tanh(c @ w)
        return c

    assert OA.analyze(loop, 13)["flops"] == 13 * OA.analyze(loop, 1)["flops"] \
        == 13 * 2 * 8 * 64 * 64


def test_reference_keys_and_ring_factors():
    res = OA.analyze(lambda: torch.randn(4, 4) @ torch.randn(4, 4))
    assert set(res) == {"flops", "bytes", "bytes_hbm_model", "collective_bytes_effective",
                        "collective_bytes_raw", "collective_total_effective",
                        "collective_total_raw", "collective_num_ops"}
    assert set(OA.COLL_FACTORS) == set(H.COLL_FACTORS)
    for kind, f in OA.COLL_FACTORS.items():
        assert [f(k) for k in (2, 8, 16)] == [H.COLL_FACTORS[kind](k) for k in (2, 8, 16)]


_MESH_SCRIPT = textwrap.dedent("""
    import json, logging, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.op_analysis import analyze
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    def place(shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl, src_data_rank=None)
    a = place((64, 32), [Shard(0), Shard(0), Replicate()])
    b = place((32, 16), [Replicate(), Replicate(), Shard(1)])
    g = place((64, 32), [Replicate(), Replicate(), Shard(0)])
    out = {"first": analyze(lambda: a @ b), "second": analyze(lambda: a @ b),
           "gather": analyze(lambda: g.redistribute(mesh, [Replicate()] * 3))}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def mesh_counts():
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sharded_product_counts_one_ranks_local_product(mesh_counts):
    # rank 3's shards: a (64/4, 32) rows, b (32, 16/2) columns
    assert mesh_counts["first"]["flops"] == 2 * 16 * 32 * 8
    assert mesh_counts["first"] == mesh_counts["second"]
    assert mesh_counts["first"]["collective_num_ops"] == 0


def test_all_gather_counts_ring_bytes(mesh_counts):
    res = mesh_counts["gather"]
    raw = 64 * 32 * 4                           # the gathered (64, 32) f32
    assert res["collective_bytes_raw"] == {"all-gather": raw}
    assert res["collective_bytes_effective"] == {"all-gather": raw * (2 - 1) / 2}
    assert res["collective_num_ops"] == 1 and res["flops"] == 0


# ------------------------------------------------------ against the reference
def _ref_counts(name, mode, seq, remat):
    cfg, run, env = ref_reduced_config(name), RefRunConfig(remat_policy=remat), local_env()
    shape = RefShapeConfig(name="c", seq_len=seq, global_batch=2, mode=mode)
    specs = RM.input_specs(cfg, shape, run)
    if mode == "train":
        lowered = jax.jit(RTS.make_train_step(cfg, run, env)).lower(
            RTS.train_state_struct(cfg, run), specs)
    else:
        prefill_fn, decode_fn = RTS.make_serve_steps(cfg, run, env)
        params = RM.param_shapes(cfg, run)
        lowered = (jax.jit(prefill_fn).lower(params, specs) if mode == "prefill" else
                   jax.jit(decode_fn).lower(params, specs["token"], specs["pos"],
                                            specs["cache"]))
    return H.analyze(lowered.compile().as_text())


def _port_counts(name, mode, seq, remat):
    cfg, run = reduced_config(name), RunConfig(remat_policy=remat)
    batch = M.input_specs(cfg, ShapeConfig("c", seq, 2, mode))
    if mode == "train":
        return OA.analyze(TS.make_train_step(cfg, run), TS.train_state_struct(cfg, run), batch)
    prefill_fn, decode_fn = TS.make_serve_steps(cfg, run)
    params = M.param_shapes(cfg, run)
    with torch.no_grad():
        if mode == "prefill":
            return OA.analyze(prefill_fn, params, batch)
        return OA.analyze(decode_fn, params, batch["token"], batch["pos"], batch["cache"])


@pytest.mark.parametrize("mode,seq", CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize("name", ARCHS)
def test_flops_within_one_percent_of_the_reference(name, mode, seq):
    mine = _port_counts(name, mode, seq, "dots")["flops"]
    ref = _ref_counts(name, mode, seq, "dots")["flops"]
    assert ref > 0 and abs(mine / ref - 1) <= 0.01, (mine, ref)


@pytest.mark.parametrize("mode,seq", CELLS, ids=[c[0] for c in CELLS])
def test_gemma2_flops_equal_the_reference(mode, seq):
    assert _port_counts("gemma2-2b", mode, seq, "none")["flops"] == \
        _ref_counts("gemma2-2b", mode, seq, "none")["flops"]


def test_gemma2_full_remat_recomputes_by_layer():
    """Under remat "full" the reference recomputes each repeat of the block
    pattern (2 layers) and keeps the repeat's last output product, w_out's,
    though nothing reads it; the port recomputes each layer and torch's
    checkpoint stops once the saved tensors are back, before w_out. So the
    reference counts one w_out product a repeat more: 2 here."""
    cfg = reduced_config("gemma2-2b")
    repeats = cfg.num_layers // len(cfg.pattern)
    w_out = 2 * 2 * 32 * cfg.d_ff * cfg.d_model
    assert _port_counts("gemma2-2b", "train", 32, "full")["flops"] + repeats * w_out == \
        _ref_counts("gemma2-2b", "train", 32, "full")["flops"]
