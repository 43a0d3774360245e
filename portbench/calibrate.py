"""The readings that a cell's limits are set from: the program's numbers
over many seeds, the control's (the reference computed with fp8 products,
put in the program's place) over a few, and a planted fault's, at the
cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <k>] [--fault <name>] [--out <file>]

For each seed: the weights drawn from it, one warm-up request, then as
many requests as the cell's check samples (``limits/<cell>.json``
``requests``), all of them judged as a run judges its sample; for the first
``k`` seeds the control's numbers beside them. ``--fault``: one of
``faults.py``'s, planted for the whole process. Prints one JSON line a
seed. Benchmark runs never run this.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch
    from portbench import check, harness, traffic
    if not torch.cuda.is_available():
        harness.log("portbench: calibrate needs a CUDA card")
        return 2
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    cell = harness.load_cell(args.workload)
    config, mix = cell["config"], cell["mix"]
    cfg = harness.port_config(config)
    arch = harness.arch_of(config)
    G = importlib.import_module("repro_torch.serving.generate")
    lines = []
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(traffic.request_seed(seed, "weights"))
        params = arch.draw_params(config, gen, "cuda")
        served = []
        for index in ["warm-up"] + list(range(cell["limits"]["requests"])):
            prompts = traffic.prompts(mix, config["vocab_size"], seed, index, "cuda")
            tokens, logits = G.generate(cfg, params, prompts, mix["max_new_tokens"])
            if index != "warm-up":
                served.append((index, tokens, logits))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        control = n < args.control
        numbers, picked, rows = check.judge(config, mix, params, served, seed, cell["limits"],
                                            "cuda", control)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault, "requests": picked,
                "program": {k: v for k, (v, _) in numbers.items()},
                "control": check.summarise(rows["control"]) if control else None,
                "rows": rows, "serve_s": t1 - t0, "check_s": time.perf_counter() - t1}
        lines.append(line)
        print(json.dumps(line), flush=True)
        del params, served
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
