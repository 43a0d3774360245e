#!/usr/bin/env python3
"""Time the torch stepper of the batched engine on the card, in its two
modes (a replayed CUDA graph and the eager chunked loop), beside the C
stepper, on the golden single-SM cells at given scales and widths.

    python3 tools/stepper_probe.py --scale 0.02 --eager
    python3 tools/stepper_probe.py --scale 0.05 --widths 7,112,896,3584 --repeats 3
    python3 tools/stepper_probe.py --scale 0.02 --widths 7,896,3584,14336 --top 30

Every torch run is held equal, record for record, to the C stepper's. With
``--repeats N`` the C and the graph runs alternate N times and every run is
printed. Prints one JSON line per run, one with a chunk of the graph under
the profiler per width, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run_graph(batch):
    """The engine's own entry point: the torch stepper on the card, over a
    CUDA graph."""
    import torch
    from repro_torch.core.batched import BatchedSMEngine
    eng = BatchedSMEngine(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    return res, dict(eng.perf), time.perf_counter() - t0


def run_eager(batch):
    """The same stepper's chunked loop run eagerly on the card, without a
    graph, its final state finalized as the engine does."""
    import torch
    from repro_torch.core import torch_backend as tb
    from repro_torch.core.batched import BatchedSMEngine
    eng = BatchedSMEngine(batch)
    st, cst = tb._arrays_of(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = tb.run_loop(tb._static_of(eng), st, cst, torch.device("cuda"), graph=False)
    stepper_s = time.perf_counter() - t0
    tb._write_back(eng, out)
    for b in range(eng.B):
        eng._finalize(b)
    perf = {"stepper_s": stepper_s, "capture_s": 0.0, "graph": 0.0,
            "iterations": float(out["n_iter"][0])}
    return eng.results, perf, time.perf_counter() - t0


def main() -> None:
    import torch
    import chip_smoke as smoke
    from repro_torch.core import torch_backend
    from repro_torch.core.batched import BatchedSMEngine
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, action="append", default=[])
    ap.add_argument("--widths", default="7")
    ap.add_argument("--eager", action="store_true", help="also time the eager loop")
    ap.add_argument("--repeats", type=int, default=1,
                    help="C and graph runs in turns at each width")
    ap.add_argument("--top", type=int, default=3, help="kernels listed under the profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stepper_probe: no CUDA device")
    card = smoke.card_line()
    print(card, flush=True)
    cells = smoke.golden_sm_cells()
    for scale in args.scale or [0.02]:
        base = smoke.golden_batch(cells, scale)
        for width in (int(w) for w in args.widths.split(",")):
            batch = base * (width // len(base))
            runs = [run_graph] * args.repeats + ([run_eager] if args.eager else [])
            for i, fn in enumerate(runs):
                if fn is run_graph or i == 0:
                    eng = BatchedSMEngine(batch, backend="c")
                    ref = [dataclasses.asdict(r) for r in eng.run()]
                    c_s = eng.perf["stepper_s"]
                res, perf, wall = fn(batch)
                same = [dataclasses.asdict(r) for r in res] == ref
                print(json.dumps({"scale": scale, "width": len(batch), "run": i,
                                  "equal_to_c": same, "wall_s": wall, "c_s": c_s,
                                  "ms_per_iteration": 1e3 * (perf["stepper_s"] - perf["capture_s"])
                                  / perf["iterations"], **perf, "card": card}), flush=True)
                if not same:
                    raise SystemExit("stepper_probe: torch records differ from the C stepper's")
                if fn is run_graph:
                    graph_perf = perf
            if args.repeats:
                ms = 1e3 * (graph_perf["stepper_s"] - graph_perf["capture_s"]) \
                    / graph_perf["iterations"]
                print(json.dumps({"width": len(batch), "idle": smoke.chunk_idle_share(
                    torch_backend.GRAPHS.last, ms, args.top)}), flush=True)


if __name__ == "__main__":
    main()
