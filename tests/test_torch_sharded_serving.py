"""The port's serving on a mesh, 8 gloo ranks on the CPU, against its
single-device CPU path (which ``tests/test_torch_zoo.py`` holds against
``repro``), and the dry run's counting on a real group against a fake one.

One spawn of 8 ranks (``torch.multiprocessing``, a ``file://`` rendezvous
under the test's tmp dir, a timeout, as ``tests/test_torch_parallel.py``)
runs every case; rank 0 saves the results:

* ``generate`` of reduced gemma2-2b, granite-moe-3b-a800m, mamba2-2.7b,
  recurrentgemma-9b, seamless-m4t-medium and paligemma-3b in f32 (the
  parameters placed by ``param_specs``, the decode rules, the prefill under
  ``phase_env``) on a (pod 2, data 2, model 2) and a (1, 2, 4) mesh. At
  (1, 2, 4) a 12-token prompt and 8 steps make a 20-slot cache of 5 slots
  a rank, so the first steps have shards with no valid slot, and a
  16-slot ring (gemma2's and recurrentgemma's local layers) wraps from the
  last shard onto the first. gemma2 also runs 6 steps there: 18 slots,
  which ``model`` 4 does not divide, so every rank holds the whole cache
  (``ShardEnv._fit``) and nothing is merged; and under ``long_decode`` on
  (2, 2, 2) with one row, its 24 slots over all 8 ranks. granite's MoE
  takes 2-token prompts: at most 8 tokens a device, under its capacity of
  at least 8 slots an expert, so neither one device nor a shard drops.
  Tokens must equal the single-device path's, logits within 1e-4.
* the dry run's ``count_cell`` (what ``run_cell`` counts) for reduced
  gemma2's prefill and decode cells on the real (2, 2, 2) group; the
  parent runs ``run_cell`` on a fake 8-rank group in a subprocess (a fake
  group is process-global) for reduced gemma2, mamba2 and seamless in
  every mode, beside the ranks; rank 0's FLOPs, collective bytes by kind
  and argument bytes must equal the fake group's, and each record has the
  reference's keys and argument bytes equal to its arguments' shard
  bytes.
"""
import json
import logging
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving.generate import generate

ROOT = Path(__file__).resolve().parents[1]
# the ranks take ~140 s alone on 8 cores; the timeout leaves room for the
# other test files' processes beside them
WORLD, NAMES, TIMEOUT_S = 8, ("pod", "data", "model"), 1000
ARCHS = ("gemma2-2b", "granite-moe-3b-a800m", "mamba2-2.7b", "recurrentgemma-9b",
         "seamless-m4t-medium", "paligemma-3b")
MESHES = ((2, 2, 2), (1, 2, 4))
# name -> (arch, mesh, rules, batch, prompt tokens, steps)
CASES = {f"{a} {'x'.join(map(str, m))}": (a, m, "decode", 4,
                                           2 if a == "granite-moe-3b-a800m" else 12,
                                           10 if a == "granite-moe-3b-a800m" else 8)
         for m in MESHES for a in ARCHS}
CASES["gemma2-2b 1x2x4 unsplit"] = ("gemma2-2b", (1, 2, 4), "decode", 4, 12, 6)
CASES["gemma2-2b 2x2x2 long_decode"] = ("gemma2-2b", (2, 2, 2), "long_decode", 1, 12, 12)
DRY_CELLS = (ShapeConfig("t", 32, 8, "train"), ShapeConfig("p", 32, 8, "prefill"),
             ShapeConfig("d", 64, 8, "decode"))


def _inputs(cfg, batch, prompt):
    """Seeded f32 parameters, prompts and frontend inputs."""
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen)
    frontend = {}
    if cfg.is_encoder_decoder:
        frontend["src_embeds"] = torch.randn(batch, 8, cfg.d_model, generator=gen)
    if cfg.frontend == "vision":
        frontend["patch_embeds"] = torch.randn(batch, cfg.frontend_len, cfg.d_model,
                                               generator=gen)
    return params, prompts, frontend


def _ranks(rank, store, out_dir):
    import torch.distributed as dist
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.parallel.sharding import distribute_tree, make_env, tree_shardings

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        res = {"seconds": {}}
        meshes = {m: make_device_mesh(m, NAMES, "cpu") for m in MESHES}
        for case, (arch, mesh, rules, batch, prompt, steps) in CASES.items():
            t0 = time.perf_counter()
            env = make_env(meshes[mesh], rules)
            cfg = reduced_config(arch)
            params, prompts, frontend = _inputs(cfg, batch, prompt)
            params = distribute_tree(params, tree_shardings(env, M.param_specs(cfg), params))
            with torch.no_grad():
                tokens, logits = generate(cfg, params, prompts, steps, frontend=frontend,
                                          device="cpu", kv_dtype=torch.float32, env=env)
            res[case] = (tokens.full_tensor(), logits.full_tensor())
            res["seconds"][case] = time.perf_counter() - t0
        cfg = reduced_config("gemma2-2b")
        for shape in DRY_CELLS[1:]:
            t0 = time.perf_counter()
            counted = D.count_cell(cfg, shape, meshes[(2, 2, 2)], RunConfig())
            res["dry", shape.mode] = {"analysis": counted["analysis"],
                                      "memory": counted["memory_analysis"]}
            res["seconds"]["dry " + shape.mode] = time.perf_counter() - t0
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fake_run():
    """The fake group's dry run, started before the ranks and run beside
    them (``fake_records`` reads it)."""
    proc = subprocess.Popen([sys.executable, "-c", _DRY_SCRIPT,
                             "gemma2-2b,mamba2-2.7b,seamless-m4t-medium"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, fake_run):
    out = tmp_path_factory.mktemp("ranks")
    ctx = torch.multiprocessing.start_processes(
        _ranks, args=(str(out / "store"), str(out)), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks took over {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    res = torch.load(out / "results.pt", weights_only=False)
    print("seconds by case:", res["seconds"])
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_generate_on_a_mesh_equals_one_device(ranks, case):
    arch, _, _, batch, prompt, steps = CASES[case]
    cfg = reduced_config(arch)
    params, prompts, frontend = _inputs(cfg, batch, prompt)
    with torch.no_grad():
        tokens, logits = generate(cfg, params, prompts, steps, frontend=frontend,
                                  device="cpu", kv_dtype=torch.float32)
    mesh_tokens, mesh_logits = ranks[case]
    assert torch.equal(mesh_tokens, tokens)
    assert (mesh_logits - logits).abs().max().item() <= 1e-4


def test_the_moe_case_drops_nothing():
    """granite's prompts leave at most 8 tokens a device, and an expert
    holds at least 8: no assignment is dropped on one device or a shard."""
    cfg = reduced_config("granite-moe-3b-a800m")
    _, _, _, batch, prompt, _ = CASES["granite-moe-3b-a800m 2x2x2"]
    for tokens in (batch * prompt, batch):
        assert tokens <= 8 <= MOE.capacity(cfg, tokens, 2.0)


_DRY_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import MeshShape, make_env, tree_shardings
    from repro_torch.train import train_step as TS
    from repro_torch.configs.base import RunConfig
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    cells = [ShapeConfig("t", 32, 8, "train"), ShapeConfig("p", 32, 8, "prefill"),
             ShapeConfig("d", 64, 8, "decode")]
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = reduced_config(arch)
        for shape in cells:
            rec = D.run_cell(arch, shape.name, "test", cfg=cfg, shape=shape, mesh_shape=mesh,
                             save=False, verbose=False)
            # the local shard bytes of every argument, from its global shape and
            # the mesh sizes its spec resolves to
            env = make_env(mesh, shape.mode)
            batch = M.input_specs(cfg, shape)
            if shape.mode == "train":
                run = RunConfig()
                args = (TS.train_state_struct(cfg, run, npod=2), batch)
                specs = (TS.state_logical_specs(cfg, run), TS.batch_logical_specs(cfg, "train"))
            else:
                args = (M.param_shapes(cfg), batch)
                specs = (M.param_specs(cfg), TS.batch_logical_specs(cfg, shape.mode))
            total = 0
            for spec, tree in zip(specs, args):
                sh = tree_shardings(env, spec, tree)
                flat_sh, flat_t = [], []
                def walk(s, t):
                    if hasattr(s, "spec"):
                        flat_sh.append(s); flat_t.append(t)
                    elif isinstance(s, dict):
                        for k in s: walk(s[k], t[k])
                    else:
                        for a, b in zip(s, t): walk(a, b)
                walk(sh, tree)
                for s, t in zip(flat_sh, flat_t):
                    n = t.numel()
                    for axes in s.spec:
                        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
                            n //= mesh.shape[a]
                    total += n * t.element_size()
            rec["shard_bytes"] = total
            out[arch + " " + shape.mode] = rec
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_records(fake_run):
    stdout, stderr = fake_run.communicate(timeout=600)
    assert fake_run.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


RECORD_KEYS = {"arch", "shape", "mesh", "tag", "num_devices", "mode", "params_total",
               "params_active", "flops_per_device", "bytes_per_device",
               "bytes_hbm_model_per_device", "collectives", "memory_analysis", "lower_s",
               "run_config"}


@pytest.mark.parametrize("mode", [s.mode for s in DRY_CELLS])
@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-2.7b", "seamless-m4t-medium"])
def test_dry_run_record(fake_records, arch, mode):
    rec = fake_records[f"{arch} {mode}"]
    assert RECORD_KEYS <= set(rec)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == rec["shard_bytes"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["num_devices"] == 8


@pytest.mark.parametrize("mode", [s.mode for s in DRY_CELLS[1:]])
def test_fake_group_counts_what_the_ranks_run(ranks, fake_records, mode):
    real = ranks["dry", mode]
    fake = fake_records[f"gemma2-2b {mode}"]
    assert real["analysis"]["flops"] == fake["flops_per_device"]
    assert real["analysis"]["collective_bytes_effective"] == \
        fake["collectives"]["collective_bytes_effective"]
    assert real["memory"]["argument_size_in_bytes"] == \
        fake["memory_analysis"]["argument_size_in_bytes"]
