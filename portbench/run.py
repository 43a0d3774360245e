"""The port's benchmark: one run of one cell, from the root of a checkout.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (and as many as the cell asks for); without one it prints
no result and exits non-zero. Prints as its last line of standard output
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``; with ``--trace 1`` also ``breakdown``; last, ``check``: each
number compared with its limit), and the same numbers as the last lines of
standard error. ``harness.py`` says what a run does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "portbench"
os.environ.update(CUDA_CACHE_PATH=str(CACHE / "cuda"), TRITON_CACHE_DIR=str(CACHE / "triton"),
                  TORCH_EXTENSIONS_DIR=str(CACHE / "torch_extensions"),
                  TORCHINDUCTOR_CACHE_DIR=str(CACHE / "inductor"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    harness.log(f"portbench: torch imported {time.perf_counter() - T_START:.3f} s after start")
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has {torch.cuda.device_count()}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: the run loaded {found}; the port may not load JAX or its package")
        return 3
    for name, c in result["check"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
