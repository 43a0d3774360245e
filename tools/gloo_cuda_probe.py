#!/usr/bin/env python3
"""Which collectives can several ranks on one CUDA card run?

    python3 tools/gloo_cuda_probe.py [--ranks 8] [--timeout 60]

NCCL refuses two ranks on one GPU, so a multi-rank run on a one-card
machine needs gloo carrying CUDA tensors. This spawns ``--ranks`` processes
on card 0 over gloo (a ``file://`` rendezvous under ``build/``) and tries,
on CUDA tensors: ``all_reduce``, ``broadcast``, ``all_gather_into_tensor``
(f32 and int8), ``reduce_scatter_tensor``, ``all_to_all_single``, then
on a (2, 2, 2) mesh's ``pod`` group the c10d all-gather and the functional
collectives DTensor calls (all-gather, all-reduce), and the
DTensor redistributions a sharded train step makes on a (2, 2, 2) mesh
(Shard -> Replicate, Partial -> Replicate, Partial -> Shard). Then, in
this process, a one-rank NCCL group and a (1, 1, 1) DTensor product. Each
operation's outcome (ok, or its error's first line) is printed as one JSON
object; a failed collective raises on every rank alike, and the process
group's timeout bounds a wait. Rank 0 writes the outcomes as it goes, so
when a rank dies (a crash inside a collective) the operation that killed
it is the first one without an outcome, printed as "crashed".
"""
from __future__ import annotations

import argparse
import datetime
import functools
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _attempt(out, name, fn, progress=None):
    out[name] = "crashed"
    if progress:
        Path(progress).write_text(json.dumps(out))
    try:
        fn()
        out[name] = "ok"
    except Exception as e:  # noqa: BLE001 - the probe records every failure
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    if progress:
        Path(progress).write_text(json.dumps(out))


def _rank(rank, world, store, result, timeout):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    out = {}
    progress = result if rank == 0 else None
    attempt = functools.partial(_attempt, progress=progress)
    x = torch.full((world * 4,), float(rank + 1), device="cuda")
    attempt(out, "all_reduce", lambda: dist.all_reduce(x.clone()))
    attempt(out, "broadcast", lambda: dist.broadcast(x.clone(), 0))
    attempt(out, "all_gather_into_tensor f32",
             lambda: dist.all_gather_into_tensor(torch.empty(world * x.numel(), device="cuda"), x))
    q = x.to(torch.int8)
    attempt(out, "all_gather_into_tensor int8",
             lambda: dist.all_gather_into_tensor(
                 torch.empty(world * q.numel(), dtype=torch.int8, device="cuda"), q))
    attempt(out, "reduce_scatter_tensor",
             lambda: dist.reduce_scatter_tensor(torch.empty(4, device="cuda"), x))
    attempt(out, "all_to_all_single",
             lambda: dist.all_to_all_single(torch.empty_like(x), x))
    if world == 8:
        import torch.distributed._functional_collectives as funcol
        mesh = init_device_mesh("cuda", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        pod = mesh.get_group("pod")
        attempt(out, "all_gather_into_tensor on the pod group",
                lambda: dist.all_gather_into_tensor(torch.empty(2 * x.numel(), device="cuda"), x,
                                                    group=pod))
        attempt(out, "functional all_gather_tensor on the world group",
                lambda: funcol.all_gather_tensor(x, 0, dist.group.WORLD).wait())
        attempt(out, "functional all_gather_tensor on the pod group",
                lambda: funcol.all_gather_tensor(x, 0, pod).wait())
        attempt(out, "functional all_reduce on the pod group",
                lambda: funcol.all_reduce(x, "sum", pod).wait())
        t = torch.arange(64.0, device="cuda").reshape(8, 8)
        d = distribute_tensor(t, mesh, [Shard(0), Shard(0), Shard(1)], src_data_rank=None)
        attempt(out, "redistribute Shard -> Replicate",
                 lambda: d.redistribute(mesh, [Replicate()] * 3).to_local())
        p = distribute_tensor(t, mesh, [Replicate()] * 3, src_data_rank=None).redistribute(
            mesh, [Replicate(), Replicate(), Replicate()])
        from torch.distributed.tensor import DTensor
        part = DTensor.from_local(p.to_local(), mesh, [Replicate(), Replicate(), Partial()])
        attempt(out, "redistribute Partial -> Replicate",
                 lambda: part.redistribute(mesh, [Replicate()] * 3).to_local())
        attempt(out, "redistribute Partial -> Shard",
                 lambda: part.redistribute(mesh, [Replicate(), Replicate(), Shard(0)]).to_local())
    dist.destroy_process_group()


def nccl_one_rank(store):
    """A one-rank NCCL group on card 0 and a DTensor product on a (1, 1, 1)
    mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out = {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        a = torch.randn(64, 32, device="cuda")
        b = torch.randn(32, 16, device="cuda")
        da = distribute_tensor(a, mesh, [Shard(0), Shard(0), Replicate()], src_data_rank=None)
        db = distribute_tensor(b, mesh, [Replicate(), Shard(0), Shard(1)], src_data_rank=None)
        _attempt(out, "nccl 1-rank DTensor matmul",
                 lambda: torch.testing.assert_close((da @ db).full_tensor(), a @ b))
    finally:
        dist.destroy_process_group()
    return out


def main():
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--timeout", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"torch": torch.__version__, "ranks": args.ranks}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        out["nccl"] = nccl_one_rank(os.path.join(tmp, "nccl_store"))
        result = Path(tmp) / "result.json"
        try:
            mp.spawn(_rank, args=(args.ranks, os.path.join(tmp, "store"), str(result),
                                  args.timeout), nprocs=args.ranks, join=True)
        finally:
            out["gloo_cuda"] = json.loads(result.read_text()) if result.exists() else None
            print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
