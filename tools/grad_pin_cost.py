#!/usr/bin/env python3
"""What pinning the SSD output's gradient costs the dry run: ``run_cell``'s
seconds for reduced mamba2-2.7b's train cell on a fake (pod 2, data 2,
model 2) group, with ``ssd_forward``'s output constraint constraining its
gradient (the port's) and without it, in alternating runs, each in a fresh
process. Host time on the CPU, not a device metric. Run from the root of a
checkout:

  PYTHONPATH=src python tools/grad_pin_cost.py --runs 2
"""
import argparse
import json
import subprocess
import sys
import time

_ONE = """
import json, logging, sys, time
logging.getLogger("torch.distributed").setLevel(logging.ERROR)
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.parallel.sharding import MeshShape
if sys.argv[1] == "unpinned":
    from repro_torch.models import ssd
    from repro_torch.parallel import sharding as SH
    ssd.constrain = lambda env, x, *logical, grad=False: SH.constrain(env, x, *logical)
t0 = time.perf_counter()
rec = D.run_cell("mamba2-2.7b", "t", "pin", cfg=reduced_config("mamba2-2.7b"),
                 shape=ShapeConfig("t", 32, 8, "train"),
                 mesh_shape=MeshShape((2, 2, 2), ("pod", "data", "model")),
                 save=False, verbose=False)
print(json.dumps({"seconds": time.perf_counter() - t0, "flops": rec["flops_per_device"],
                  "collective_bytes": rec["collectives"]["collective_total_effective"]}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2, help="runs of each variant, alternating")
    args = ap.parse_args()
    for i in range(args.runs):
        for variant in (("pinned", "unpinned") if i % 2 == 0 else ("unpinned", "pinned")):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", _ONE, variant], capture_output=True,
                                 text=True, check=True).stdout
            rec = json.loads(out.strip().splitlines()[-1])
            print(json.dumps({"variant": variant, **rec,
                              "process_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
