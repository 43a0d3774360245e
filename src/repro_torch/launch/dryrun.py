"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, counted.

The counterpart of the reference's ``launch/dryrun.py``. The reference
lowers and compiles each cell for 512 placeholder devices and reads XLA's
memory and cost analyses and the HLO. Here one process stands for one rank
of the production mesh:

  1. a fake process group (``torch.testing._internal.distributed.fake_pg``:
     collectives that move nothing) of 256 or 512 ranks, and a DeviceMesh of
     ``make_production_mesh``'s shape ((16, 16) or (2, 16, 16));
  2. the state and inputs on the meta device (shapes and dtypes, no
     storage) from ``param_shapes``/``train_state_struct``/``input_specs``,
     placed by ``tree_shardings`` of ``state_logical_specs``,
     ``batch_logical_specs``, ``param_specs`` and ``cache_specs`` (decode
     cells past 100,000 tokens under the ``long_decode`` rules), so each
     tensor is rank 0's shard;
  3. one train step, prefill or decode step run eagerly under
     ``op_analysis.OpCounter`` (rank 0's FLOPs, bytes and collectives) and
     ``op_analysis.MemoryTracker`` (its peak device memory);
  4. a record with the reference's keys written to
     ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``, with a
     ``reference`` block (the reference's compiled figures and the port's
     share of each) for a cell that ``reference_cells.json`` holds.

The numbers are arithmetic on shapes, not measurements: nothing runs on a
device. ``lower_s`` is the host seconds of the traced step (the reference's
lowering); ``cost_analysis_raw`` and ``compile_s`` (XLA's cost analysis and
its compile) have no counterpart and are left out. The peak is printed
beside one H100's 80 GB.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import pathlib
import subprocess
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import ALL_SHAPES, shapes_for
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import MemoryTracker, OpCounter
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.parallel.sharding import distribute_tree, make_env, tree_shardings
from repro_torch.train import train_step as TS
from repro_torch.train.tree import tree_leaves

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
# the reference's figures for some cells (and the port's beside them), from
# tools/dryrun_vs_ref.py: the card's machine has no JAX to compile them
REFERENCE_CELLS = pathlib.Path(__file__).resolve().with_name("reference_cells.json")
H100_BYTES = 80e9          # one NVIDIA H100 SXM's device memory
LONG_DECODE_TOKENS = 100_000


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree`` (DTensors by
    their local tensor), each storage once."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if isinstance(t, DTensor) else t
        key = (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0) for
    the duration: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig,
               rule_overrides=()):
    """Build the cell's step on ``mesh`` (a DeviceMesh) with its state and
    inputs on the meta device, placed by the cell's rules. Returns (a thunk
    that runs the step once and returns its outputs, the env, the step's
    arguments)."""
    mode = shape.mode
    rules_mode = ("long_decode" if mode == "decode" and shape.seq_len > LONG_DECODE_TOKENS
                  else mode)
    env = make_env(mesh, rules_mode, tuple(cfg.sharding_overrides) + tuple(rule_overrides))
    batch = M.input_specs(cfg, shape)
    if mode == "train":
        npod = env.axis_size("pod")
        state = TS.train_state_struct(cfg, run, npod=npod)
        state = distribute_tree(state, tree_shardings(env, TS.state_logical_specs(cfg, run), state))
        batch = distribute_tree(batch, tree_shardings(
            env, TS.batch_logical_specs(cfg, "train"), batch))
        step = TS.make_train_step(cfg, run, env)
        return (lambda: step(state, batch)), env, (state, batch)
    params = M.param_shapes(cfg, run)
    params = distribute_tree(params, tree_shardings(env, M.param_specs(cfg), params))
    prefill_fn, decode_fn = TS.make_serve_steps(cfg, run, env)
    batch = distribute_tree(batch, tree_shardings(env, TS.batch_logical_specs(cfg, mode), batch))
    if mode == "prefill":
        return (lambda: prefill_fn(params, batch)), env, (params, batch)
    return ((lambda: decode_fn(params, batch["token"], batch["pos"], batch["cache"])), env,
            (params, batch))


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, run: RunConfig,
               rule_overrides=()) -> Dict[str, Any]:
    """One step of the cell on ``mesh`` under the op counter and the memory
    tracker: this rank's counts (``op_analysis`` keys), ``memory_analysis``
    and the step's host seconds."""
    step, _, args = lower_cell(cfg, shape, mesh, run, rule_overrides)
    L.rope_freq.cache_clear()      # each cell counts its own RoPE frequencies
    tracker = MemoryTracker()
    tracker.track(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
    t0 = time.perf_counter()
    with torch.no_grad() if shape.mode != "train" else contextlib.nullcontext():
        with tracker, OpCounter() as counter:
            out = step()
    lower_s = time.perf_counter() - t0
    mem = memory_analysis(args, out, tracker.peak)
    return {"analysis": counter.summary(), "memory_analysis": mem, "lower_s": lower_s}


def memory_analysis(args, out, peak: int) -> Dict[str, int]:
    """XLA's memory-analysis keys for a step's arguments and outputs (this
    rank's shards) and the tracker's ``peak``."""
    arg_bytes, out_bytes = local_bytes(args), local_bytes(out)
    alias = arg_bytes + out_bytes - local_bytes((args, out))
    return {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias, "temp_size_in_bytes": max(peak - arg_bytes, 0),
            "peak_bytes": peak, "total_hbm_bytes": max(peak, arg_bytes + out_bytes - alias)}


def reference_block(arch: str, shape_name: str, mesh_kind: str,
                    result: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The reference's figures for the cell from ``reference_cells.json``
    (None where the file does not hold it), and this record's share of
    each: FLOPs, bytes, the effective collective bytes by kind and in all,
    the peak against XLA's total_hbm_bytes."""
    if not REFERENCE_CELLS.exists():
        return None
    ref = json.loads(REFERENCE_CELLS.read_text())["cells"].get(
        f"{arch}__{shape_name}__{mesh_kind}")
    if ref is None:
        return None
    ref = ref["reference"]
    coll = result["collectives"]

    def share(mine, theirs):
        return mine / theirs if theirs else None

    ratios = {"flops": share(result["flops_per_device"], ref["flops_per_device"]),
              "bytes": share(result["bytes_per_device"], ref["bytes_per_device"]),
              "collective_total_effective": share(coll["collective_total_effective"],
                                                  ref["collective_total_effective"]),
              "peak_to_total_hbm": share(result["memory_analysis"]["peak_bytes"],
                                         ref["memory_analysis"]["total_hbm_bytes"])}
    for kind in set(coll["collective_bytes_effective"]) | set(ref["collective_bytes_effective"]):
        ratios[f"collective {kind}"] = share(coll["collective_bytes_effective"].get(kind, 0.0),
                                             ref["collective_bytes_effective"].get(kind, 0.0))
    return {**ref, "port_over_reference": ratios}


def card_name() -> str:
    """The card's name, from ``nvidia-smi`` where there is one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "NVIDIA H100"
    return (out.stdout.strip().splitlines() or ["NVIDIA H100"])[0]


def run_cell(arch: str, shape_name: str, mesh_kind: str, run: Optional[RunConfig] = None,
             tag: str = "", save: bool = True, verbose: bool = True, rule_overrides=(), *,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeConfig] = None,
             mesh_shape=None) -> Dict[str, Any]:
    """The cell's record, counted as rank 0 of a fake group of the mesh's
    size. ``cfg``, ``shape`` and ``mesh_shape`` (a MeshShape) replace the
    arch's config, the named shape and the production mesh (reduced cells
    in tests)."""
    # a production cell: the reference's figures apply
    production = (cfg is None and shape is None and mesh_shape is None and not tag
                  and not rule_overrides and (run is None or run == RunConfig()))
    cfg = cfg or get_config(arch)
    shape = shape or ALL_SHAPES[shape_name]
    run = run or RunConfig()
    mshape = mesh_shape or make_production_mesh(multi_pod=mesh_kind == "multi")
    world = 1
    for n in mshape.shape_tuple:
        world *= n
    # DTensor warns of each redistribution it runs as several collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    with fake_group(world):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", mshape.shape_tuple, mesh_dim_names=mshape.axis_names)
        counted = count_cell(cfg, shape, mesh, run, rule_overrides)
    res = counted["analysis"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "num_devices": world, "mesh_shape": list(mshape.shape_tuple),
        "mode": shape.mode,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "flops_per_device": res["flops"],
        "bytes_per_device": res["bytes"],
        "bytes_hbm_model_per_device": res["bytes_hbm_model"],
        "collectives": res,
        "memory_analysis": counted["memory_analysis"],
        "lower_s": round(counted["lower_s"], 2),
        "run_config": dataclasses.asdict(run),
    }
    reference = reference_block(arch, shape_name, mesh_kind, result) if production else None
    if reference is not None:
        result["reference"] = reference
    if verbose:
        peak = counted["memory_analysis"]["peak_bytes"]
        print(f"== {arch} x {shape_name} x {mesh_kind}" + (f" [{tag}]" if tag else ""))
        print(f"   step {result['lower_s']:.1f}s | "
              f"flops/dev {res['flops']:.3e} | bytes/dev {res['bytes']:.3e} | "
              f"coll_eff {res['collective_total_effective']:.3e}B "
              f"({res['collective_num_ops']} ops) {res['collective_bytes_effective']}")
        print(f"   memory/dev: peak {peak / 1e9:.2f} GB of one {card_name()}'s "
              f"{H100_BYTES / 1e9:.0f} GB ({peak / H100_BYTES:.1%}); "
              f"{counted['memory_analysis']}")
        if reference is not None:
            mem = reference["memory_analysis"]
            print(f"   reference (XLA's compiled program, {REFERENCE_CELLS.name}): flops/dev "
                  f"{reference['flops_per_device']:.3e} | coll_eff "
                  f"{reference['collective_total_effective']:.3e}B "
                  f"{reference['collective_bytes_effective']} | total_hbm "
                  f"{mem['total_hbm_bytes'] / 1e9:.2f} GB")
            print("   port / reference: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(reference["port_over_reference"].items())
                if v is not None))
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
        (ARTIFACTS / f"{name}.json").write_text(json.dumps(result, indent=1))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(ALL_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--tag", default="", help="variant tag for artifacts")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--compression", default=None)
    ap.add_argument("--rule", action="append", default=[],
                    help="logical=axis[:axis2] sharding-rule override, "
                         "e.g. --rule act_seq=model --rule p_embed=")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    rule_overrides = []
    for r in args.rule:
        k, _, v = r.partition("=")
        axes = tuple(a for a in v.split(":") if a) or None
        if axes and len(axes) == 1:
            axes = axes[0]
        rule_overrides.append((k, axes))

    overrides = {}
    if args.remat is not None:
        overrides["remat_policy"] = args.remat
    if args.loss_chunk is not None:
        overrides["loss_chunk"] = args.loss_chunk
    if args.compression is not None:
        overrides["gradient_compression"] = args.compression
    run = dataclasses.replace(RunConfig(), **overrides)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for sh in shapes_for(get_config(arch)):
                cells.append((arch, sh.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        cells.append((args.arch, args.shape))

    failures = []
    for arch, sh in cells:
        for mk in meshes:
            name = f"{arch}__{sh}__{mk}" + (f"__{args.tag}" if args.tag else "")
            if args.skip_existing and (ARTIFACTS / f"{name}.json").exists():
                print(f"-- skip {name} (exists)")
                continue
            try:
                run_cell(arch, sh, mk, run=run, tag=args.tag,
                         rule_overrides=tuple(rule_overrides))
            except Exception as e:  # record and continue
                failures.append((name, repr(e)[:500]))
                print(f"!! FAIL {name}: {e}")
    if failures:
        print(f"\n{len(failures)} failures:")
        for n, e in failures:
            print(" ", n, e)
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
