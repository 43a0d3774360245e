#!/usr/bin/env python3
"""Check the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
 1. the card's name and power limit; build the CUDA kernels from the
    sources in this checkout (one nvcc each, in parallel) and print nvcc's
    -Xptxas -v report;
 2. each kernel against its plain torch version on the card, at the kernel
    tests' grids and at the serving path's shapes, in f32 and bf16 (K3 and
    K2 also at the edges of their bf16 kernels' tiling and splits); the
    CIAO gather (K1) exactly, at the reference's test shapes, with no
    isolated slots, at rows the 16-byte copy does not divide, at traces of
    one repeated index, of misses only and of runs longer than a warp's
    batch, with requests out of range, and at the isolation case, where
    isolating the sweeping stream must cut the others' misses by more than
    3x; K3 and K2 also at the heads of the zoo's decoder archs (G 3 at D 64,
    G 4, 6, 7 and 8 at D 128), K2 at random and ragged lengths, and K2's
    bf16 tensor-core consumer at G 16 and 8 (recurrentgemma's MQA and
    paligemma's 8 query heads on one KV head, D 256) at random and ragged
    lengths, at length S, at S shorter than a tile, with a zero length and
    at a long row, with and without a softcap and with
    ``return_lse``; K3 with a prefix-LM prefix (1, 100, 200, 300, = Sq and > Sq
    at a ragged Sq) at paligemma's heads (G 8, D 256) and at D 32, and
    non-causal at seamless's (G 1, D 64) with Sq != Skv, both ragged; K2 at
    seamless's heads with every length = S; and both at the shapes of
    phases 4b, 4c, 4d and 4e: K3 at each arch's prefill (recurrentgemma's
    with its 2,048-token window, paligemma's with its 256-patch prefix,
    seamless's encoder and its self and cross prefill), K2 at its last
    decode step (recurrentgemma's wrapped 2,048-slot ring, seamless's self
    and cross steps), with f32 queries against a bf16 cache too where the
    split kernel takes the group; K2's ring kernel at D 64 and 128 (bf16)
    at every group it takes there and at its edges (a length-0 row, length
    1, lengths one below and one above a stage, ragged lengths, S no
    multiple of a stage and shorter than one, one split and many), with and
    without a softcap, and there, at the zoo's heads and at the zoo and
    frontend paths' steps, also with ``return_lse`` (the f32 output within
    TOL["bfloat16"], the lse within phase 10a's limit);
 3. the reduced configs of gemma2-2b, granite-moe-3b-a800m, arctic-480b,
    qwen3-4b, nemotron-4-15b, command-r-35b, mamba2-2.7b, recurrentgemma-9b,
    seamless-m4t-medium and paligemma-3b (their frontend inputs drawn from
    the seeded generator): the port's CPU plain path against its CUDA
    kernel path, logits and greedy tokens, with an f32 and a bf16 cache,
    and the launch counts (``attention_calls``: K3 and K2 once an attention
    layer, none for mamba2; seamless K3 3 a layer, K2 2 a layer a step);
 4. full-width gemma2-2b in bf16 with random weights from a seeded
    generator: 4 requests of 4608-token prompts (longer than the 4096-token
    local window), 32 greedy decode steps through ``generate``; the launch
    counts show the path went through the kernels, the logits are finite,
    the greedy tokens follow them and a rerun gives the same tokens;
 4b. granite-moe-3b-a800m (MoE, 40 experts top-8), whole, with phase 4's
    workload and checks, and the MoE's device time by kind (sort, gathers,
    expert products, routing) at the decode step's and the prefill's tokens;
 4c. qwen3-4b, nemotron-4-15b and command-r-35b at full depth (command-r cut
    to 20 layers only if its reckoned peak passes 70 GB) and arctic-480b at
    1 of its 35 layers (a layer is 13.6 B parameters): 2 x 1024-token
    prompts, 8 greedy steps, phase 4's checks;
 4d. mamba2-2.7b (64 SSD layers) and recurrentgemma-9b (26 RG-LRU and 12
    local MQA layers) whole, with phase 4's workload and checks (K3 and K2
    launches 0 and 12 a prefill, 0 and 12 a step), the peak memory beside
    the reckoned one, and one recurrent block's device time at the
    prefill's tokens and at a decode step, split into GEMMs and plain torch;
 4e. seamless-m4t-medium (12 encoder and 12 decoder layers, cross-attention,
    biases) over 4 sources of 4,096 frame embeddings with 64-token decoder
    prompts, and paligemma-3b (18 layers, the prefix-LM mask) over 4 x (256
    patch embeddings + 768 text tokens), whole, 32 greedy steps each, with
    phase 4's checks (K3 36 and K2 24 a step for seamless, 18 and 18 for
    paligemma) and the peak memory beside the reckoned one;
 5. the CIAO gather path at full width: the gather workload's index stream
    (72,000 requests of 48 streams, 6 of them isolated) against a bf16 table
    of gemma2-2b's vocab x d_model, through ``ciao_gather`` with the trace's
    isolation bits and with none; rows byte-equal and counts equal to the
    plain version, and the launch count shows the path went through K1;
 6. kernel times at the main paths' shapes (CUDA events around back-to-back
    calls) beside their bounds, the plain versions and one PyTorch library
    call of the same function, with the device time of K1's and K2's
    launches under the profiler, K2's time over a CUDA graph of 100 calls
    and every K3 row's over one of 20 (``device_ms``: without the host's
    launch cost; each K3 row also names its launch, ``kernel.launch_plan``'s
    mode); K2 also at the
    last decode step of granite-moe, qwen3, nemotron, command-r, arctic and
    recurrentgemma (the ring kernel at G 16), K3 also at recurrentgemma's
    prefill; K3 at seamless's encoder and cross prefill and paligemma's
    prefill (a prefix mask_mod for flex_attention), K2 at seamless's cross
    step and paligemma's last step; each K2 row with the CUDA path its 5
    profiled calls took (``k2_path``: "ring mma", "ring" or "split"),
    profiled in one fresh process after the timing, which must be the ring
    kernel wherever ``kernel.uses_ring`` routes there, with its tensor-core
    consumer (``decode_ring_mma_kernel``) wherever ``kernel.uses_mma`` does;
 7. the simulator path: the port's C stepper builds; the 7 single-SM golden
    cells through ``run_batched(cells)`` (the torch stepper, on the card by
    default) equal the golden records field by field; the fig8 grid (12
    apps x 7 policies, scale 0.5), the 1,024-cell knob sweep and the golden
    mix at scale 0.05 replicated to 3,584 cells give torch records equal to
    the C stepper's; each batch is timed once on each stepper, with the
    iterations, the CUDA graph's capture and peak memory, the sweep's chunk
    under the profiler (device idle share), and the batch width from which
    torch wins, if any (``tools/stepper_probe.py`` times other widths and
    repeats).
 8. training, which launches none of the kernels (the reference trains
    through jnp, not through its Pallas kernels): 8a, the reduced configs of
    all ten archs at f32 (TF32 off), the loss, the gradients and one
    ``make_train_step`` step (AdamW; arctic's Adafactor) on the card against
    the same step on the CPU from the same seeded parameters on the same
    ``SyntheticLM`` batch, no K1, K2 or K3 launch during it, a save ->
    restore -> step on the card whose loss equals the unbroken run's, a
    bf16 step (remat "dots", a chunked loss) near the CPU's, and for gemma2
    also ``grad_accum`` 2 against 1 and remat "dots" and "full" against
    "none"; 8b, full-width gemma2-2b in bf16, 2 x 4096 tokens a step
    (TRAIN_4K's sequence; its global batch of 256 cut to 2 for one card),
    AdamW, remat "full", loss and attention chunks of 1024, warmup 2, 8
    steps: finite losses and grad norms, parameters that move, the mean of
    the last three losses below the first; step ms (median of steps 2-8),
    tokens/s, the share of 989 TFLOP/s that 6 N tokens a step gives, one
    step's device idle share and kernels under the profiler, the forward +
    backward alone, one layer's chunked attention, and the peak memory
    beside the reckoned one;
 9. sharded training: 9a, 8b's workload through the DTensor path (the
    state placed by ``tree_shardings`` of ``state_logical_specs``, the
    batches by ``batch_logical_specs``) on a (1, 1, 1) ("pod", "data",
    "model") mesh of a one-rank NCCL group: each step's loss within 8a's
    bf16 tolerance of 8b's, no kernel launch, step ms, tokens/s, idle share
    and peak memory beside 8b's (the gap is DTensor's host cost);
10. serving on a mesh and the dry run: 10a, K2 with ``return_lse`` at
    gemma2's, granite's and recurrentgemma's last decode steps and at S
    shorter than a tile, ragged lengths with a zero row: the lse within
    2e-5 |lse| + 1e-5 of the plain version's, the f32 output within 2e-5,
    and rounded to q's dtype bit-equal to the call without the lse; 10b,
    each of those caches cut into 2 and 16 slices along S, K2 on each slice
    at its local lengths and ``merge_stacked`` (the arithmetic the ranks
    run) against K2 on the whole cache within TOL["bfloat16"], with empty
    slices, and one slice's K2 and the merge timed beside the whole, the
    slice's plain version and flex_attention with the lse beside it; 10c,
    phase 4's weights and prompts through ``generate`` on a (1, 1, 1) mesh
    of a one-rank NCCL group under the decode rules: tokens equal to phase
    4's, logits within phase 3's bf16 tolerance, K3 26 and K2 832
    launches, prefill ms, decode ms a step and the idle share beside phase
    4's; 10d, the dry run's six gemma2-2b cells (train_4k, prefill_32k
    and decode_32k on the (16, 16) and (2, 16, 16) meshes) and the zoo's
    twelve (granite-moe, mamba2, recurrentgemma, seamless on (16, 16);
    ``launch/dryrun.run_cell``: a fake group of 256/512 ranks, the meta
    device) on this machine's torch, every figure (per-rank FLOPs, bytes,
    collective bytes by kind, the memory analysis) within 1% of the port's
    record in ``launch/reference_cells.json`` (written on a CPU build of torch), with
    the port's share of the reference's compiled figures and the seconds;
    it needs no card, so it runs in a process of its own from phase 8 on,
    beside phases 8-10c, and phase 10 waits for it.
11. the runner, the run ledger, the runs CLI and the examples: 11a,
    benchmarks/run.py's fig8 grid (12 apps x 7 policies at scale 0.5, seed
    0, best-swl and statpcal swept over their limits) through
    ``run_grid(engine="torch", strict=True)`` on the card, its records
    equal field for field to ``run_grid(engine="batched")`` on the C rung
    run on the host, ``save_records`` -> ``load_records`` equal, and a 2-SM
    grid of kmn and syrk x (gto, ciao-p, ciao-c) at scale 0.25 whose chunks
    the torch rung sends to C (``host_chunks``), equal to the batched
    run's; the seconds, ``last_batched_perf()``, the iterations and the
    capture seconds; 11b, the --quick grid (syrk and kmn x gto, ciao-p,
    ciao-c at scale 0.2; a token budget that gives each app a chunk) under
    a ledger in build/phase11/runs: a run whose first dispatch the fault
    plan holds past its deadline returns truncated FailedCells for the
    second chunk, ``resume`` gives records equal to an uninterrupted run,
    ``python -m repro_torch.runs list`` and ``show`` exit 0 and report the
    run complete, and ``runs create`` + two ``runs work`` processes drain a
    fresh run together on the card with records equal to the serial run's;
    11c, examples/torch_serve_ciao.py's decode on the card (K3 once an
    attention layer at the prefill, K2 once a layer a step; tokens equal
    to the CPU plain path's on the same seeded weights) and its policy
    table (equal to the CPU run's), examples/torch_quickstart.py (40
    steps; its greedy generation launches K3 once a layer and K2 once a
    layer a step) and examples/torch_train_tiny_lm.py --steps 20 with
    falling losses, training launching no kernel.

Phase 2 also shows that the attention kernels refuse CUDA inputs that
require grad (they have no backward). Before the card line come one JSON
object {"stepper": ...} of phase 7's numbers, one {"train": ...} of phase
8's and 9's, one {"sharded_serving": ...} of phase 10's and one
{"runner": ...} of phase 11's numbers and seconds; the line before the
last is
one JSON object of per-kernel numbers; the last line is
{"ok": true, "device": {...}}. Without a card, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet, dense: the bounds in the kernels line.
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# A kernel holds its plain version element-wise:
#     |out - ref| <= atol + rtol * |ref| + ptol * (|p| @ |v|),
# as (atol, rtol, ptol) by output dtype and kernel. f32: the kernel tests'
# 2e-5; both sides compute in f32. bf16: both sides accumulate in f32 and
# round the output to bf16 once, so they may differ by one bf16 ulp, at most
# 2^-7 |ref|; atol covers f32 sums taken in another order near zero. K3's
# tensor-core PV product takes p rounded to bf16, which moves the output by
# at most 2^-9 (|p| @ |v|) with p normalised; ptol is twice that.
TOL = {"float32": {"flash_attn": (2e-5, 0.0, 0.0), "decode_attn": (2e-5, 0.0, 0.0)},
       "bfloat16": {"flash_attn": (1e-4, 2 ** -7, 2 ** -8),
                    "decode_attn": (1e-4, 2 ** -7, 0.0)}}
# K2's log-sum-exp (f32 on both sides): within LSE_RTOL |lse| + LSE_ATOL of
# the plain version's (phases 2 and 10a)
LSE_RTOL, LSE_ATOL = 2e-5, 1e-5
TOL["lse"] = {"decode_attn": (LSE_ATOL, LSE_RTOL, 0.0)}
SEQ, BATCH, STEPS, WINDOW = 4608, 4, 32, 4096


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` by CUDA events over ``iters`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times: the host's cost of a launch drops out,
    which ``cuda_ms`` includes wherever it exceeds a short kernel's own time."""
    import torch
    fn()                                  # build, load and allocate outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ phase 1
def build_kernels():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["decode_attn", "flash_attn", "ciao_gather"])
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{b.name} {b.seconds:.1f} s' for b in built.values())})")
    for b in built.values():
        log(f"  ptxas -v, {b.name} (registers and spills per instantiation; full log "
            f"{b.path.with_suffix('.log').relative_to(ROOT)}):")
        for name, items in ptxas_report(b.log).items():
            log(f"    {items}  {name}")


def ptxas_report(text: str):
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"}
    from nvcc's -Xptxas -v output, with readable kernel names."""
    report, fn = {}, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            report.setdefault(fn, []).append(line.strip().split(" stack frame, ")[-1])
        elif "Used" in line and "registers" in line:
            report.setdefault(fn, []).insert(0, line.split("Used")[1].split(",")[0].strip())
    names = demangle(list(report))
    return {names[fn]: ", ".join(items) for fn, items in report.items()}


def demangle(symbols):
    """Readable kernel names via c++filt, left mangled where it is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(symbols), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {s: s for s in symbols}
    return {s: o.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for s, o in zip(symbols, out)}


# ------------------------------------------------------------------ phase 2
# (b, sq, skv, hq, hkv, d, causal, window, softcap): the kernel tests' grid;
# gemma2-2b's heads (G = 2, D = 256) with a window and at a ragged length;
# then the edges of the bf16 kernel's tiling (128 query rows a block, 64
# keys a tile) at D = 256: one query row, 63, 129 (past one block), a window
# of 100 (not a multiple of the tile), a window at least as long as Sq,
# non-causal with Skv != Sq and both ragged; and D = 32 (the 64-byte
# swizzle) with a softcap at ragged lengths
FLASH_GRID = [
    (1, 128, 128, 2, 2, 64, True, 0, 0.0), (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 128, 8, 1, 32, True, 64, 50.0), (2, 192, 192, 4, 4, 128, True, 0, 0.0),
    (1, 128, 128, 2, 2, 64, False, 0, 0.0),
    (1, 256, 256, 8, 4, 256, True, 64, 50.0), (2, 200, 200, 8, 4, 256, True, 0, 50.0),
    (2, 1, 1, 8, 4, 256, True, 0, 50.0), (1, 63, 63, 8, 4, 256, True, 0, 50.0),
    (2, 129, 129, 8, 4, 256, True, 0, 50.0), (1, 300, 300, 8, 4, 256, True, 100, 50.0),
    (1, 200, 200, 8, 4, 256, True, 256, 50.0), (2, 100, 177, 8, 4, 256, False, 0, 50.0),
    (2, 150, 150, 4, 2, 32, True, 0, 30.0)]
# the heads of the zoo's decoder archs, (Hq, Hkv, D): granite-moe (G 3, D
# 64), qwen3 (G 4), nemotron (G 6), arctic (G 7) and command-r (G 8) at D 128
ZOO_HEADS = [(24, 8, 64), (32, 8, 128), (48, 8, 128), (56, 8, 128), (64, 8, 128)]
# K3 at those heads, causal at a ragged length, no softcap (none of them has one)
FLASH_GRID += [(1, 300, 300, hq, hkv, d, True, 0, 0.0) for hq, hkv, d in ZOO_HEADS]
# seamless-m4t-medium's heads (16 of 64, G 1): K3 non-causal (the encoder,
# and cross-attention) with Sq != Skv, both ragged
FLASH_GRID += [(2, 77, 301, 16, 16, 64, False, 0, 0.0), (1, 300, 190, 16, 16, 64, False, 0, 0.0)]
# the edges of the D 64 and D 128 plans (kernel.PLANS: 128-key tiles, the
# exponent folded into one FMA; D 64: blocks of 192 query rows in three
# consumer warpgroups, two at Sq <= 128) at granite's heads (G 3, D 64) and
# qwen3's (G 4, D 128), and at seamless's (G 1, D 64): Sq and Skv no
# multiple of the tile or the block, Sq 1, Skv shorter than one tile
# (causal and not), Sq 129 and 193 (just past a short block and a block of
# three), a causal block whose first tile (taken last-to-first) is wholly
# masked for its first warpgroup (D 64 at Sq 300 and 384: the last tile of
# the block at 192 starts at 256), a window, a softcap, and non-causal Sq
# != Skv
FLASH_GRID += [case for hq, hkv, d in ((24, 8, 64), (32, 8, 128)) for case in (
    (2, 200, 200, hq, hkv, d, True, 0, 0.0), (1, 385, 385, hq, hkv, d, True, 0, 0.0),
    (2, 1, 1, hq, hkv, d, True, 0, 0.0), (2, 50, 50, hq, hkv, d, True, 0, 0.0),
    (2, 90, 50, hq, hkv, d, False, 0, 0.0), (1, 384, 384, hq, hkv, d, True, 0, 0.0),
    (1, 300, 300, hq, hkv, d, True, 100, 0.0), (1, 333, 333, hq, hkv, d, True, 0, 30.0),
    (1, 300, 300, hq, hkv, d, True, 100, 50.0), (2, 129, 700, hq, hkv, d, False, 0, 0.0))]
FLASH_GRID += [(2, 1, 257, 16, 16, 64, False, 0, 0.0), (1, 193, 127, 16, 16, 64, False, 0, 0.0)]
# K3's split launch (kernel.launch_plan): seamless's cross prefill (Sq 64
# against 4,096 keys, both warpgroups on alternate key tiles), its edges
# (Sq 63 against a ragged 4,001, Sq 1), a softcap at a ragged Sq 33
# against 700 keys, 192 items (more than SMs); and seamless's self prefill
# (Sq 64 causal on 64 keys: one tile, warpgroup 1 with none)
FLASH_GRID += [(4, 64, 4096, 16, 16, 64, False, 0, 0.0), (4, 63, 4001, 16, 16, 64, False, 0, 0.0),
               (4, 1, 4096, 16, 16, 64, False, 0, 0.0), (2, 33, 700, 16, 16, 64, False, 0, 30.0),
               (12, 50, 1000, 16, 16, 64, False, 0, 0.0), (4, 64, 64, 16, 16, 64, True, 0, 0.0)]
# (b, sq, hq, hkv, d, prefix): K3 causal with a prefix-LM prefix at a ragged
# Sq, at paligemma-3b's heads (8 q on 1 kv head of 256), at D 32 (the
# 64-byte swizzle) and at the D 64 and D 128 plans (granite's and qwen3's
# heads): prefixes that are no multiple of the tile or of the block, one
# that ends the sequence (P = Sq) and one past it
FLASH_PREFIX_GRID = [(2, 333, hq, hkv, d, p)
                     for hq, hkv, d in ((8, 1, 256), (4, 2, 32), (24, 8, 64), (32, 8, 128))
                     for p in (1, 100, 200, 300, 333, 400)]
# paligemma's heads at 4 x 1,000 tokens (256 items), prefixes of 256 and 300
FLASH_PREFIX_GRID += [(4, 1000, 8, 1, 256, 256), (4, 1000, 8, 1, 256, 300)]
# (b, s, hq, hkv, d, lengths or None for random ones): the kernel tests'
# grid, then the edges of the bf16 ring kernel (D = 256, 32-key tiles, one
# split per SM's share): length 1 (all but one split empty), length S,
# lengths that are not a multiple of the tile, S shorter than one tile, a
# row whose splits mostly have no valid keys, a lengths == 0 row (uniform
# over S), and G = 1 and G = 8
DECODE_GRID = [(2, 256, 4, 2, 64, None), (3, 512, 4, 4, 128, None), (1, 300, 8, 2, 32, None),
               (2, 700, 8, 4, 256, None), (2, 300, 8, 4, 256, [1, 1]),
               (2, 300, 8, 4, 256, [300, 300]), (2, 1000, 8, 4, 256, [999, 517]),
               (2, 20, 8, 4, 256, [20, 7]), (2, 700, 8, 4, 256, [3, 700]),
               (2, 300, 8, 4, 256, [0, 150]), (1, 500, 8, 8, 256, None),
               (1, 500, 8, 1, 256, None)]
# K2 at the zoo's heads on the split kernel: random lengths, and ragged ones
# (a full row and one that ends inside a split)
DECODE_GRID += [case for hq, hkv, d in ZOO_HEADS
                for case in ((2, 700, hq, hkv, d, None), (2, 700, hq, hkv, d, [700, 517]))]
# K2 at seamless-m4t-medium's heads (the split kernel, G 1, D 64) with every
# length = S, as its cross-attention step reads the whole encoder cache
SEAMLESS_HEADS = (16, 16, 64)
DECODE_GRID += [(2, 700, *SEAMLESS_HEADS, [700, 700]), (3, 333, *SEAMLESS_HEADS, [333] * 3)]
# the bf16 ring kernel's tensor-core consumer at G 16 (recurrentgemma's 16
# query heads on one KV head of 256), bf16 only (the split kernel takes no
# G 16), with and without a softcap and with the lse: recurrentgemma's last
# decode step (B 4, its 2,048-slot ring wrapped, every slot valid) at
# random lengths, ragged ones (a row that ends inside a split, one of a few
# keys, one of one key), at length S, at S shorter than one 32-key tile,
# with a lengths == 0 row, and one long row (16 splits of 25-26 tiles)
RING16_GRID = [(4, 2048, 16, 1, 256, None), (4, 2048, 16, 1, 256, [2048, 1500, 37, 1]),
               (4, 2048, 16, 1, 256, [2048] * 4), (4, 20, 16, 1, 256, [20, 7, 1, 13]),
               (2, 300, 16, 1, 256, [0, 300]), (1, 20000, 16, 1, 256, [13001])]
# the same grid at G 8 (paligemma's 8 query heads on one KV head of 256):
# with G 16, the shapes of the ring kernel's tensor-core consumer
RING8_GRID = [(b, s, 8, hkv, d, lengths) for b, s, _, hkv, d, lengths in RING16_GRID]
SCALE = 256 ** -0.5


def ring_edge_grid():
    """(b, s, hq, hkv, d, lengths or None for random ones) of the ring
    kernel at D 64 and 128 (bf16 q and cache; stages of 8192 / D = 128 and
    64 keys): every group it takes there (G 1, 2, 3, 4, 6, 7, 8) at random
    lengths, then its edges at granite-moe's heads (G 3, D 64) and
    nemotron's (G 6, D 128): a length-0 row (uniform over S), length 1 (all
    but one split empty), lengths one below and one above a stage, ragged
    lengths with S no multiple of a stage, S shorter than a stage (one
    split a pair), one split a pair at a longer S (136 (row, kv head) pairs
    on 132 SMs) and many splits (63, of one pair)."""
    out = []
    for d, (hq, hkv) in ((64, (24, 8)), (128, (48, 8))):
        stage = 8192 // d
        out += [(2, 700, 2 * g, 2, d, None) for g in (1, 2, 3, 4, 6, 7, 8)]
        out += [(2, 700, hq, hkv, d, [0, 300]), (2, 700, hq, hkv, d, [1, 1]),
                (2, 700, hq, hkv, d, [stage - 1, stage + 1]),
                (3, 333, hq, hkv, d, [333, 200, 17]), (2, 20, hq, hkv, d, [20, 7]),
                (17, 300, hq, hkv, d, None), (1, 4000, hq // hkv, 1, d, [3999])]
    return out


def hold_ring_lse(hold, case, q, ck, cv, lens, args):
    """K2 with ``return_lse`` on bf16 inputs, through ``hold``: the f32
    output within TOL["bfloat16"] of the plain version's unrounded one, the
    lse within TOL["lse"] (phase 10a's limit)."""
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    out, lse = DK.decode_attention_cuda(q, ck, cv, lens, return_lse=True, **args)
    plain_lse = DO.decode_attention_plain(q, ck, cv, lens, return_lse=True, **args)[1]
    hold("decode_attn", f"{case} with lse: out", out,
         lambda w: DO.decode_attention_plain(q, ck, w, lens, return_lse=True, **args)[0], cv,
         tol="bfloat16")
    hold("decode_attn", f"{case} with lse: lse", lse, lambda w: plain_lse, cv, tol="lse")


def main_path_inputs(dtype, gen):
    """Attention inputs at the serving path's shapes: prefill of BATCH x SEQ
    tokens, and the last decode step (position SEQ+STEPS-1) against a local
    ring of WINDOW slots and a global cache of SEQ+STEPS slots."""
    import torch
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    prefill = (rnd(BATCH, SEQ, 8, 256), rnd(BATCH, SEQ, 4, 256), rnd(BATCH, SEQ, 4, 256))
    last = SEQ + STEPS - 1
    decode = {}
    for kind, slots in (("local", WINDOW), ("global", SEQ + STEPS)):
        lengths = torch.full((BATCH,), min(last + 1, slots), dtype=torch.int32, device=dev)
        decode[kind] = (rnd(BATCH, 1, 8, 256), rnd(BATCH, slots, 4, 256),
                        rnd(BATCH, slots, 4, 256), lengths)
    return prefill, decode


def zoo_paths():
    """(arch, batch, prompt, steps, Hq, Hkv, D, scale, window) of the zoo's
    serving paths that attend: granite-moe and recurrentgemma with phase 4's
    workload (4b, 4d), the others with 4c's. ``window`` is the local
    layers' (recurrentgemma's 2,048: its layers are all local), else 0.
    mamba2 has no attention, so no path here."""
    from repro_torch.configs import get_config
    out = []
    for name, (b, sq, steps) in ((GRANITE, (BATCH, SEQ, STEPS)),
                                 *((a, (ZOO_BATCH, ZOO_SEQ, ZOO_STEPS)) for a in ZOO_ARCHS),
                                 (RECURRENTGEMMA, (BATCH, SEQ, STEPS))):
        cfg = get_config(name)
        out.append((name, b, sq, steps, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    cfg.query_scale or cfg.head_dim ** -0.5, cfg.local_window))
    return out


def hold_zoo_paths(dtype, gen, hold, only):
    """Phase 2 at the zoo paths' own shapes, as ``main_path_inputs`` gives
    gemma2-2b's: K3 at each prefill (causal, the path's window, no
    softcap), K2 at each last decode step (every slot of the cache or of the
    wrapped ring valid), and K2 with f32 queries against a bf16 cache where
    the split kernel takes the group (not recurrentgemma's G 16, which only
    the bf16 ring kernel takes)."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for name, b, sq, steps, hq, hkv, d, scale, window in zoo_paths():
        if "flash_attn" in only:
            q, k, v = rnd(b, sq, hq, d), rnd(b, sq, hkv, d), rnd(b, sq, hkv, d)
            args = dict(scale=scale, causal=True, window=window, softcap=0.0)
            # the plain version a batch row at a time: granite's (24, 4608,
            # 4608) f32 scores are 2 GB a row
            hold("flash_attn", f"{dtype} main {name} prefill {(b, sq, hq, hkv, d)}",
                 FK.flash_attention_cuda(q, k, v, **args),
                 lambda w: torch.cat([FO.flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                                               w[i:i + 1], **args)
                                      for i in range(b)]), v)
            del q, k, v
        if "decode_attn" not in only:
            continue
        if hq // hkv in DK.RING_GROUPS and dtype != torch.bfloat16:
            continue
        s = min(sq + steps, window or sq + steps)
        dq, ck, cv = rnd(b, 1, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        args = dict(scale=scale, softcap=0.0)
        case = f"{dtype} main {name} last decode step {(b, s, hq, hkv, d)}"
        hold("decode_attn", case, DK.decode_attention_cuda(dq, ck, cv, lens, **args),
             lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
        if DK.uses_ring(dtype, dtype, d) and d != 256:     # D 256's lse: phase 10a
            hold_ring_lse(hold, case, dq, ck, cv, lens, args)
        if dtype == torch.float32:     # f32 queries against a bf16 cache
            ck, cv = ck.to(torch.bfloat16), cv.to(torch.bfloat16)
            hold("decode_attn", f"{dtype} q, bf16 cache, main {name} last decode step",
                 DK.decode_attention_cuda(dq, ck, cv, lens, **args),
                 lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
        del dq, ck, cv
    torch.cuda.empty_cache()


def frontend_calls():
    """The attention calls of phase 4e's paths, as (arch, call, kernel,
    shape, scale): K3's shape (b, sq, skv, hq, hkv, d, causal, prefix), K2's
    (b, s, hq, hkv, d) at the last decode step, every slot valid.
    seamless: the encoder over SRC_LEN frames (non-causal), the decoder's
    self-attention over its DEC_PROMPT-token prompt, its cross-attention
    over the encoder output (non-causal, Sq << Skv), and a step's self and
    cross attention; paligemma: the prefill over its patches and text (the
    prefix-LM mask) and the last step."""
    from repro_torch.configs import get_config
    out = []
    for name in FRONTEND_ARCHS:
        cfg = get_config(name)
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        scale = cfg.query_scale or cfg.head_dim ** -0.5
        if cfg.is_encoder_decoder:
            calls = [("encoder", "flash_attn", (BATCH, SRC_LEN, SRC_LEN, *heads, False, 0)),
                     ("self prefill", "flash_attn",
                      (BATCH, DEC_PROMPT, DEC_PROMPT, *heads, True, 0)),
                     ("cross prefill", "flash_attn",
                      (BATCH, DEC_PROMPT, SRC_LEN, *heads, False, 0)),
                     ("self step", "decode_attn", (BATCH, DEC_PROMPT + STEPS, *heads)),
                     ("cross step", "decode_attn", (BATCH, SRC_LEN, *heads))]
        else:
            s = cfg.frontend_len + TEXT_LEN
            calls = [("prefill", "flash_attn", (BATCH, s, s, *heads, True, cfg.frontend_len)),
                     ("last step", "decode_attn", (BATCH, s + STEPS, *heads))]
        out += [(name, call, kernel, shape, scale) for call, kernel, shape in calls]
    return out


def frontend_inputs(kernel, shape, scale, dtype, gen):
    """Random inputs of one of ``frontend_calls``: (q, k, v, K3's keyword
    arguments) or (q, cache_k, cache_v, lengths, K2's)."""
    import torch

    def rnd(*dims):
        return torch.randn(dims, generator=gen, device="cuda").to(dtype)

    if kernel == "flash_attn":
        b, sq, skv, hq, hkv, d, causal, prefix = shape
        return (rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d),
                dict(scale=scale, causal=causal, prefix_len=prefix, softcap=0.0))
    b, s, hq, hkv, d = shape
    return (rnd(b, 1, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d),
            torch.full((b,), s, dtype=torch.int32, device="cuda"), dict(scale=scale, softcap=0.0))


def hold_frontend_paths(dtype, gen, hold, only):
    """Phase 2 at phase 4e's shapes (``frontend_calls``): K3's plain version
    a batch row at a time (seamless's encoder scores are 1 GB a row in
    f32), and K2 with f32 queries against a bf16 cache too."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    for name, call, kernel, shape, scale in frontend_calls():
        if kernel not in only:
            continue
        label = f"{dtype} main {name} {call} {shape}"
        if kernel == "flash_attn":
            q, k, v, args = frontend_inputs(kernel, shape, scale, dtype, gen)
            hold("flash_attn", label, FK.flash_attention_cuda(q, k, v, **args),
                 lambda w: torch.cat([FO.flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                                               w[i:i + 1], **args)
                                      for i in range(q.shape[0])]), v)
            del q, k, v
            continue
        dq, ck, cv, lens, args = frontend_inputs(kernel, shape, scale, dtype, gen)
        hold("decode_attn", label, DK.decode_attention_cuda(dq, ck, cv, lens, **args),
             lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
        if DK.uses_ring(dtype, dtype, shape[4]) and shape[4] != 256:
            hold_ring_lse(hold, label, dq, ck, cv, lens, args)
        if dtype == torch.float32:     # f32 queries against a bf16 cache
            ck, cv = ck.to(torch.bfloat16), cv.to(torch.bfloat16)
            hold("decode_attn", f"{dtype} q, bf16 cache, main {name} {call}",
                 DK.decode_attention_cuda(dq, ck, cv, lens, **args),
                 lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
        del dq, ck, cv
    torch.cuda.empty_cache()


KERNELS = ("flash_attn", "decode_attn", "ciao_gather")


def check_kernels(only=KERNELS):
    """Phase 2 for the kernels in ``only``: returns (errs, failed), the
    largest |err| of each case and the cases that disagree."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"flash_attn": {}, "decode_attn": {}, "ciao_gather": {}}
    failed = []

    def hold(name, case, out, plain, v, tol=None):
        """``plain(v)`` is the plain version on the values ``v``;
        ``plain(v.abs())`` gives |p| @ |v| for the tolerance's p term.
        ``tol`` names the tolerance's dtype when it is not the output's (an
        f32 output computed from bf16 inputs)."""
        atol, rtol, ptol = TOL[tol or str(out.dtype).split(".")[1]][name]
        ref = plain(v).float()
        limit = atol + rtol * ref.abs()
        if ptol:
            limit = limit + ptol * plain(v.abs()).float()
        err = (out.float() - ref).abs()
        worst, ratio = err.max().item(), (err / limit).max().item()
        log(f"  {name:11s} {case}: max|err| {worst:.3g}, max|ref| {ref.abs().max().item():.3g}, "
            f"max |err|/limit {ratio:.3g} (limit {atol:g} + {rtol:g}|ref| + {ptol:g}|p||v|)")
        if not (math.isfinite(worst) and ratio <= 1.0):
            failed.append(f"{name} {case}")
        errs[name][case] = worst

    log("[2] kernels against their plain versions on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_GRID if "flash_attn" in only else ():
            b, sq, skv, hq, hkv, d, causal, window, cap = case
            q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, skv, hkv, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, skv, hkv, d, generator=gen, device="cuda").to(dtype)
            args = dict(scale=d ** -0.5, causal=causal, window=window, softcap=cap)
            hold("flash_attn", f"{dtype} grid {case}",
                 FK.flash_attention_cuda(q, k, v, **args),
                 lambda w: FO.flash_attention_plain(q, k, w, **args), v)
        for case in FLASH_PREFIX_GRID if "flash_attn" in only else ():
            b, sq, hq, hkv, d, prefix = case
            q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, sq, hkv, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            args = dict(scale=d ** -0.5, causal=True, prefix_len=prefix)
            hold("flash_attn", f"{dtype} prefix {case}",
                 FK.flash_attention_cuda(q, k, v, **args),
                 lambda w: FO.flash_attention_plain(q, k, w, **args), v)
        kv_dtypes = (torch.float32, torch.bfloat16) if dtype == torch.float32 else (dtype,)
        for (b, s, hq, hkv, d, lengths) in DECODE_GRID if "decode_attn" in only else ():
            for kv_dtype in kv_dtypes:
                q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(dtype)
                ck = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(kv_dtype)
                cv = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(kv_dtype)
                lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                                     dtype=torch.int32) if lengths is None else \
                    torch.tensor(lengths, dtype=torch.int32, device="cuda")
                # the zoo's archs have no attention softcap; the others run gemma2's
                cap = 0.0 if (hq, hkv, d) in ZOO_HEADS + [SEAMLESS_HEADS] else 50.0
                args = dict(scale=d ** -0.5, softcap=cap)
                case = f"{dtype}/{kv_dtype} grid {(b, s, hq, hkv, d, lengths)}"
                hold("decode_attn", case, DK.decode_attention_cuda(q, ck, cv, lens, **args),
                     lambda w: DO.decode_attention_plain(q, ck, w, lens, **args), cv)
                if DK.uses_ring(dtype, kv_dtype, d) and d != 256:
                    hold_ring_lse(hold, case, q, ck, cv, lens, args)
        for (b, s, hq, hkv, d, lengths) in (RING16_GRID + RING8_GRID if "decode_attn" in only
                                            and dtype == torch.bfloat16 else ()):
            for cap in (0.0, 50.0):
                q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(dtype)
                ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
                          for _ in range(2))
                lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                                     dtype=torch.int32) if lengths is None else \
                    torch.tensor(lengths, dtype=torch.int32, device="cuda")
                args = dict(scale=d ** -0.5, softcap=cap)
                case = f"{dtype} ring G {hq // hkv} softcap {cap:g} {(b, s, hq, hkv, d, lengths)}"
                hold("decode_attn", case, DK.decode_attention_cuda(q, ck, cv, lens, **args),
                     lambda w: DO.decode_attention_plain(q, ck, w, lens, **args), cv)
                hold_ring_lse(hold, case, q, ck, cv, lens, args)
        for (b, s, hq, hkv, d, lengths) in (ring_edge_grid() if "decode_attn" in only
                                            and dtype == torch.bfloat16 else ()):
            for cap in (0.0, 50.0):
                q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(dtype)
                ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
                          for _ in range(2))
                lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                                     dtype=torch.int32) if lengths is None else \
                    torch.tensor(lengths, dtype=torch.int32, device="cuda")
                args = dict(scale=d ** -0.5, softcap=cap)
                case = f"{dtype} ring D {d} softcap {cap:g} {(b, s, hq, hkv, d, lengths)}"
                hold("decode_attn", case, DK.decode_attention_cuda(q, ck, cv, lens, **args),
                     lambda w: DO.decode_attention_plain(q, ck, w, lens, **args), cv)
                hold_ring_lse(hold, case, q, ck, cv, lens, args)
        (q, k, v), decode = main_path_inputs(dtype, gen)
        for kind, window in (("local", WINDOW), ("global", 0)):
            args = dict(scale=SCALE, causal=True, window=window, softcap=50.0)
            if "flash_attn" in only:
                hold("flash_attn", f"{dtype} main {kind}",
                     FK.flash_attention_cuda(q, k, v, **args),
                     lambda w: FO.flash_attention_plain(q, k, w, **args), v)
            if "decode_attn" not in only:
                continue
            dq, ck, cv, lens = decode[kind]
            args = dict(scale=SCALE, softcap=50.0)
            hold("decode_attn", f"{dtype} main {kind}",
                 DK.decode_attention_cuda(dq, ck, cv, lens, **args),
                 lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
            if dtype == torch.float32:     # f32 queries against a bf16 cache
                ck, cv = ck.to(torch.bfloat16), cv.to(torch.bfloat16)
                hold("decode_attn", f"{dtype} q, bf16 cache, main {kind}",
                     DK.decode_attention_cuda(dq, ck, cv, lens, **args),
                     lambda w: DO.decode_attention_plain(dq, ck, w, lens, **args), cv)
        del q, k, v, decode
        torch.cuda.empty_cache()
        hold_zoo_paths(dtype, gen, hold, only)
        hold_frontend_paths(dtype, gen, hold, only)
    if "ciao_gather" in only:
        check_gather(gen, errs["ciao_gather"], failed)
    return errs, failed


# (n, d, t, c_main, c_iso, dtypes): the reference's kernel tests, then no
# isolated slots, then rows of 260, 194 and 392 bytes (4-, 2- and 8-byte
# copy units)
GATHER_GRID = [(500, 128, 384, 64, 16, "both"), (1000, 256, 640, 128, 32, "both"),
               (64, 128, 130, 16, 8, "both"), (500, 128, 384, 64, 0, "both"),
               (300, 130, 500, 16, 8, "bfloat16"), (300, 97, 500, 16, 8, "bfloat16"),
               (300, 98, 500, 16, 8, "float32")]


def byte_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(-1).view(torch.uint8), b.contiguous().view(-1).view(torch.uint8))


def hold_gather(case, table, idx, streams, iso, c_main, c_iso, errs, failed, want=None):
    """K1 against its plain version on the same inputs: rows byte-equal,
    counts equal. ``want`` overrides the plain version's (out, stats)."""
    from repro_torch.kernels.ciao_gather import kernel as CK, ops as CO
    out, stats = CK.ciao_gather_cuda(table, idx, streams, iso, c_main=c_main, c_iso=c_iso)
    ref_out, ref_stats = want or CO.ciao_gather_plain(table, idx, streams, iso,
                                                       c_main=c_main, c_iso=c_iso)
    same_rows = byte_equal(out, ref_out)
    same_stats = stats.shape == ref_stats.shape and bool((stats.cpu() == ref_stats.cpu()).all())
    err = max_err(out, ref_out)
    log(f"  ciao_gather {case}: rows byte-equal {same_rows} (max|err| {err:.3g}), "
        f"stats equal {same_stats} ({int(stats[:, 1].sum())} misses)")
    if not (same_rows and same_stats):
        failed.append(f"ciao_gather {case}")
    errs[case] = err
    return stats


def check_gather(gen, errs, failed):
    import numpy as np
    import torch
    from repro_torch.kernels.ciao_gather import ops as CO

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda() for a in arrays]

    for (n, d, t, c_main, c_iso, which) in GATHER_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            if which not in ("both", str(dtype).split(".")[1]):
                continue
            rng = np.random.default_rng(0)     # the reference kernel test's trace
            streams = rng.integers(0, 4, t)
            idx = np.where(streams == 3, rng.integers(0, 8, t), rng.integers(0, n, t))
            table = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            hold_gather(f"{dtype} grid {(n, d, t, c_main, c_iso)}", table,
                        *on_card(idx, streams, [0, 0, 0, 1]), c_main, c_iso, errs, failed)
    # traces at the edges of the runs: one repeated index (one run a slot,
    # every request after the first a hit), every request a miss (distinct
    # indices), and runs of 75 requests (longer than a gather warp's batch
    # of 2 records and than a warp)
    rng = np.random.default_rng(2)
    t = 3000
    streams = rng.integers(0, 4, t)
    traces = {"one repeated index": np.full(t, 5),
              "every request a miss": rng.permutation(4000)[:t],
              "runs of 75 requests": np.repeat(rng.integers(0, 4000, t // 75), 75)}
    for name, idx in traces.items():
        for dtype, d in ((torch.bfloat16, 256), (torch.float32, 97)):
            table = torch.randn(4000, d, generator=gen, device="cuda").to(dtype)
            hold_gather(f"{dtype} {name} (4000, {d})", table,
                        *on_card(idx, streams, [0, 0, 0, 1]), 64, 16, errs, failed)
    # a view one row into the table: its base is 2-byte aligned at D = 129
    table = torch.randn(301, 129, generator=gen, device="cuda").to(torch.bfloat16)[1:]
    rng = np.random.default_rng(1)
    streams, idx = rng.integers(0, 4, 500), rng.integers(0, 300, 500)
    hold_gather("bfloat16 unaligned view (300, 129)", table,
                *on_card(idx, streams, [0, 1, 0, 1]), 16, 8, errs, failed)
    # requests out of range: zero rows, counted nowhere; the rest as the
    # plain version has them without those requests
    bad = np.zeros(500, bool)
    bad[[3, 50, 51, 499]] = True
    idx_bad, streams_bad = idx.copy(), streams.copy()
    idx_bad[[3, 499]], streams_bad[[50, 51]] = [-1, 300], [4, -2]
    i_ok, s_ok, iso = on_card(idx[~bad], streams[~bad], [0, 1, 0, 1])
    ref_rows, ref_stats = CO.ciao_gather_plain(table, i_ok, s_ok, iso, c_main=16, c_iso=8)
    want = torch.zeros((500, 129), dtype=table.dtype, device="cuda")
    want[torch.from_numpy(~bad).cuda()] = ref_rows
    hold_gather("bfloat16 requests out of range", table, *on_card(idx_bad, streams_bad),
                iso, 16, 8, errs, failed, want=(want, ref_stats))
    # the reference's isolation test: streams 0-2 loop over 8 private rows
    # each, stream 3 sweeps the table
    rng = np.random.default_rng(1)
    n, d, t = 256, 128, 2048
    streams = rng.integers(0, 4, t)
    priv = (streams[:, None] * 8 + rng.integers(0, 8, (t, 1))).ravel()
    idx = np.where(streams == 3, rng.integers(0, n, t), priv)
    table = torch.ones(n, d, device="cuda")
    misses = {}
    for bit in (0, 1):
        stats = hold_gather(f"float32 isolation case, stream 3 isolated {bool(bit)}", table,
                            *on_card(idx, streams, [0, 0, 0, bit]), 32, 16, errs, failed)
        misses[bit] = int(stats[:3, 1].sum())
    log(f"  ciao_gather isolation case: streams 0-2 miss {misses[0]} times, "
        f"{misses[1]} with stream 3 isolated (want fewer than {misses[0] / 3:.1f})")
    if not misses[1] < misses[0] / 3:
        failed.append("ciao_gather isolation does not protect the main partition")


def check_forward_only():
    """The attention kernels have no backward: on the card, a call whose
    input requires grad under grad mode raises; under no_grad it runs."""
    import torch
    from repro_torch.kernels.decode_attn import ops as DO
    from repro_torch.kernels.flash_attn import ops as FO
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=gen, device="cuda") for _ in range(3))
    lens = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    calls = {"flash_attention": lambda x: FO.flash_attention(x, k, v),
             "decode_attention": lambda x: DO.decode_attention(x[:, :1], k, v, lens)}
    for name, call in calls.items():
        w = q.clone().requires_grad_(True)
        try:
            call(w)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name} on CUDA inputs that require grad did not raise")
        with torch.no_grad():
            call(w)
    sync()
    log("[2] flash_attention and decode_attention refuse CUDA inputs that require grad "
        "(no backward) and run under no_grad")


# ------------------------------------------------------------------ phase 3
def attention_calls(cfg):
    """(K3 launches a prefill, K2 launches a decode step): one each an
    attention layer (all of a transformer's, 12 of recurrentgemma-9b's 38,
    none of mamba2's), two in an encoder-decoder's decoder layer (self and
    cross attention) and one an encoder layer."""
    from repro_torch.configs.base import ATTN_BLOCKS
    layers = sum(kind in ATTN_BLOCKS for kind in cfg.layer_kinds())
    per_layer = 2 if cfg.is_encoder_decoder else 1
    return per_layer * layers + cfg.num_encoder_layers, per_layer * layers


def frontend_batch(cfg, batch, src_len, dtype, gen, device):
    """The frontend's inputs of ``batch`` requests, drawn from ``gen``:
    ``src_embeds`` (batch, src_len, d) for an encoder-decoder,
    ``patch_embeds`` (batch, frontend_len, d) for a vision frontend, else
    nothing."""
    import torch

    def rnd(n):
        return torch.randn(batch, n, cfg.d_model, generator=gen, device=device).to(dtype)

    if cfg.is_encoder_decoder:
        return {"src_embeds": rnd(src_len)}
    if cfg.frontend == "vision":
        return {"patch_embeds": rnd(cfg.frontend_len)}
    return {}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def check_reduced():
    """Phase 3: each arch's reduced config, the CPU plain path against the
    CUDA kernel path, logits and greedy tokens, and the launch counts."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.models.model import init_params
    from repro_torch.serving import generate
    steps = 10
    for name in ("gemma2-2b", GRANITE) + ZOO_ARCHS + RECURRENT_ARCHS + FRONTEND_ARCHS:
        log(f"[3] reduced {name} f32: CPU plain path against the CUDA kernel path")
        cfg = reduced_config(name)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (3, 24), generator=gen)
        # seamless: 3 sources of 20 frames; paligemma: its 8 reduced patches
        frontend = frontend_batch(cfg, 3, 20, torch.float32, gen, "cpu")
        for kv_dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            cpu_tok, cpu_logits = generate(cfg, params, prompts, steps, frontend=frontend,
                                           device="cpu", kv_dtype=kv_dtype)
            flash_attention_cuda.launches = decode_attention_cuda.launches = 0
            tok, logits = generate(cfg, to_device(params, "cuda"), prompts, steps,
                                   frontend=frontend, kv_dtype=kv_dtype)
            counts = (flash_attention_cuda.launches, decode_attention_cuda.launches)
            err = max_err(logits.cpu(), cpu_logits)
            gap = cpu_logits.topk(2, dim=-1).values
            clear = torch.cat([torch.ones_like(gap[:, :1, 0], dtype=torch.bool),
                               (gap[:, :-1, 0] - gap[:, :-1, 1]) > tol], dim=1)
            same = bool((tok.cpu() == cpu_tok)[clear].all())
            log(f"  kv {kv_dtype}: max|logit err| {err:.3g} (tol {tol:g}), greedy tokens "
                f"equal where the top-2 gap exceeds it: {same}, launches flash {counts[0]} "
                f"decode {counts[1]}")
            if err > tol or not same:
                fail(f"reduced {name} CUDA path disagrees with the CPU path (kv {kv_dtype})")
            per_prefill, per_step = attention_calls(cfg)
            if counts != (per_prefill, per_step * steps):
                fail(f"reduced {name} launch counts {counts}, want "
                     f"{(per_prefill, per_step * steps)}")


# ------------------------------------------------------------------ phase 4
def device_profile(fn, top: int = 8):
    """One ``fn()`` under torch.profiler: wall ms, device busy ms (None when
    the profiler saw no device time) and the kernels with the most device
    time, as [name, ms, calls]. The profiler may miss the first launches of
    its window, so a per-launch time is total ms / calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy or None,
            "top": [[e.key[:90], e.device_time_total / 1e3, e.count] for e in kernels[:top]]}


def serve(card, cfg, batch, seq, steps, label, profile=True, src_len=0, keep=None):
    """Serve ``cfg`` (bf16, random weights from a seeded generator) through
    ``generate``: ``batch`` prompts of ``seq`` tokens (after the patch
    embeddings of a vision frontend; an encoder-decoder's with sources of
    ``src_len`` frame embeddings; both drawn from the generator) and
    ``steps`` greedy steps. Fails unless the launch counts show the kernels
    ran (``attention_calls``: none for mamba2), the logits are finite, the
    greedy
    tokens follow them and a second run of prefill and decode gives the
    same tokens. Returns (the run's numbers, with prefill and a decode step
    under the profiler when ``profile``; the parameters). ``keep`` (a dict)
    receives the run's greedy tokens and logits, on the host."""
    import torch
    from repro_torch.configs.base import ATTN_BLOCKS
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.models import model as M
    from repro_torch.serving import generate
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device="cuda")
    frontend = frontend_batch(cfg, batch, src_len, torch.bfloat16, gen, "cuda")
    sync()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # warm-up: cuBLAS, allocator
    generate(cfg, params, prompts[:, :min(seq, 256)], 2, frontend=frontend)
    sync()

    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = decode_attention_cuda.launches = 0
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, steps, frontend=frontend)
    sync()
    total_s = time.perf_counter() - t0
    launches = {"flash_attn": flash_attention_cuda.launches,
                "decode_attn": decode_attention_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill, per_step = attention_calls(cfg)
    want = {"flash_attn": per_prefill, "decode_attn": per_step * steps}
    log(f"  generate: {total_s * 1e3:.1f} ms, launches {launches} (want {want}: "
        f"{sum(k in ATTN_BLOCKS for k in cfg.layer_kinds())} of {cfg.num_layers} layers "
        f"attend, {cfg.num_encoder_layers} encoder layers), "
        f"peak memory {peak_gb:.2f} GB (while drawing the weights {init_peak_gb:.2f} GB), "
        f"init {init_s:.1f} s")
    if launches != want:
        fail(f"{label}: launch counts {launches}, want {want}")
    if tokens.shape != (batch, steps) or logits.shape != (batch, steps, cfg.vocab_size):
        fail(f"{label}: shapes tokens {tuple(tokens.shape)} logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{label}: non-finite logits")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"{label}: token out of range")
    if not torch.equal(logits[:, :-1].argmax(-1), tokens[:, 1:]):
        fail(f"{label}: greedy tokens do not follow the logits")
    if keep is not None:
        keep.update(tokens=tokens.cpu(), logits=logits.cpu())

    # the two phases apart: prefill alone, then the decode steps
    inputs = {"tokens": prompts, **frontend}

    def run_prefill():
        return M.prefill(cfg, params, inputs, max_len=M.prompt_len(inputs) + steps)

    sync()
    t0 = time.perf_counter()
    logits0, cache, pos = run_prefill()
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits0.argmax(-1)[:, None]
    fed = []
    t0 = time.perf_counter()
    for i in range(steps):
        fed.append(tok)
        step_logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
        tok = step_logits.argmax(-1)[:, None]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    # the reference's own check (test_greedy_generation_deterministic): a
    # rerun gives the same greedy sequence
    if not torch.equal(torch.cat(fed, dim=1), tokens):
        fail(f"{label}: a second run of prefill and decode gave other greedy tokens")
    result = {
        "layers": cfg.num_layers, "batch": batch, "prompt": seq, "steps": steps,
        "frontend": {k: list(v.shape) for k, v in frontend.items()},
        "params_b": cfg.param_count() / 1e9,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_tokens_per_s": batch * 1e3 / decode_ms, "generate_ms": total_s * 1e3,
        "peak_mem_gb": peak_gb, "init_peak_mem_gb": init_peak_gb, "init_s": init_s,
        "launches": launches, "card": card}
    idle = ""
    if profile:
        # Device busy time from the profiler; the idle share puts it against
        # the untraced wall time, since tracing slows the host side.
        pf = device_profile(run_prefill)
        dec = device_profile(     # the last step again, at its own slot
            lambda: M.decode_step(cfg, params, tok, pos + steps, cache))
        for prof, wall in ((pf, prefill_ms), (dec, decode_ms)):
            prof["idle_share"] = (1 - prof["device_busy_ms"] / wall
                                  if prof["device_busy_ms"] else None)
        result.update(prefill_profile=pf, decode_step_profile=dec)
        idle = (f", device idle share prefill {pf['idle_share']} decode "
                f"{dec['idle_share']}")
    log(f"  prefill {prefill_ms:.1f} ms, decode {decode_ms:.3f} ms/step, "
        f"{result['decode_tokens_per_s']:.1f} tokens/s{idle}; on {card}")
    for what in ("prefill", "decode_step"):
        prof = result.get(f"{what}_profile")
        if prof:
            log(f"  {what.replace('_', ' ')}: device busy {prof['device_busy_ms']} ms "
                f"(profiled wall {prof['wall_ms']:.1f} ms); top kernels:")
            for name, ms, calls in prof["top"]:
                log(f"    {ms:9.3f} ms {calls:5d}x  {name}")
    return result, params


def serve_full_width(card: str, keep=None):
    """Phase 4: gemma2-2b at full width, BATCH x SEQ prompts, STEPS steps;
    ``keep`` receives its tokens, logits and numbers (phase 10c's
    yardstick)."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-2b")
    log(f"[4] gemma2-2b bf16 at full width ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params): "
        f"{BATCH} x {SEQ}-token prompts, {STEPS} greedy steps")
    result = serve(card, cfg, BATCH, SEQ, STEPS, "gemma2-2b", keep=keep)[0]
    if keep is not None:
        keep["result"] = result
    log(json.dumps({"main_path": result}))
    torch.cuda.empty_cache()
    return result["launches"]


# The MoE's kernels by kind, from their names under the profiler: the
# dispatch plan (sort, scan), gathers and scatters (the dispatch and the
# combine's reorder), the expert products, routing (top-k, softmax) and the
# rest (activation, masks, casts, the combine's sum).
MOE_KINDS = (("sort/scan", ("sort", "Sort", "scan", "Scan", "cummax")),
             ("gather/scatter", ("index", "Index", "gather", "scatter", "Scatter")),
             ("bmm", ("gemm", "Gemm", "nvjet", "xmma", "cutlass", "sm90_")),
             ("route", ("topk", "TopK", "bitonic", "softmax", "Softmax")))


def moe_breakdown(cfg, moe_params, tokens):
    """One ``moe_apply`` of ``tokens`` random bf16 tokens under the
    profiler: device ms by kind (MOE_KINDS) and the kernels."""
    import torch
    from repro_torch.models.moe import moe_apply
    gen = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(1, tokens, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    moe_apply(cfg, moe_params, h)          # warm-up
    prof = device_profile(lambda: moe_apply(cfg, moe_params, h), top=64)
    kinds = {k: 0.0 for k, _ in MOE_KINDS} | {"other": 0.0}
    for name, ms, _ in prof["top"]:
        kind = next((k for k, keys in MOE_KINDS if any(w in name for w in keys)), "other")
        kinds[kind] += ms
    return {"tokens": tokens, "wall_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"], "by_kind_ms": kinds,
            "top": prof["top"][:10]}


def serve_granite(card: str):
    """Phase 4b: granite-moe-3b-a800m at full width, whole (32 layers),
    phase 4's workload; with the MoE's device time by kind at the decode
    step's and the prefill's token counts."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(GRANITE)
    log(f"[4b] granite-moe-3b-a800m bf16 at full width ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.2f} B params): {BATCH} x {SEQ}-token prompts, "
        f"{STEPS} greedy steps")
    result, params = serve(card, cfg, BATCH, SEQ, STEPS, GRANITE)
    moe = {"decode": moe_breakdown(cfg, params["layers"][0]["moe"], BATCH),
           "prefill": moe_breakdown(cfg, params["layers"][0]["moe"], BATCH * SEQ)}
    for what, m in moe.items():
        step = result[f"{what}_step_profile" if what == "decode" else "prefill_profile"]
        share = (cfg.num_layers * m["device_busy_ms"] / step["device_busy_ms"]
                 if m["device_busy_ms"] and step["device_busy_ms"] else None)
        m["share_of_device_busy"] = share
        log(f"  MoE of one layer at {what}'s {m['tokens']} tokens: device {m['device_busy_ms']} "
            f"ms (x {cfg.num_layers} layers = {share} of the {what}'s device time), by kind "
            + ", ".join(f"{k} {v:.4f}" for k, v in m["by_kind_ms"].items()))
    result["moe"] = moe
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 4b took {result['phase_s']:.1f} s")
    log(json.dumps({"granite": result}))
    del params
    torch.cuda.empty_cache()
    return result["launches"]


# Phase 4c: the other four archs at full width, batch 2, 1024-token prompts,
# 8 greedy steps. arctic-480b keeps 1 of its 35 layers (13.6 B parameters a
# layer: two would hold 55 GB of weights); command-r-35b keeps its 40 unless
# the reckoned peak exceeds PEAK_BUDGET_GB, and then 20.
ZOO_BATCH, ZOO_SEQ, ZOO_STEPS = 2, 1024, 8
GRANITE = "granite-moe-3b-a800m"
ZOO_ARCHS = ("qwen3-4b", "nemotron-4-15b", "command-r-35b", "arctic-480b")
DEPTH_CUTS = {"arctic-480b": 1, "command-r-35b": 20}
PEAK_BUDGET_GB = 70.0


def reckoned_peak_gb(cfg, batch, prompt, steps, src_len=0):
    """What serving ``cfg`` to ``batch`` prompts of ``prompt`` tokens (a
    vision frontend's patches included; an encoder-decoder's sources of
    ``src_len`` frames) and ``steps`` decode steps should hold at most: the
    bf16 weights, the largest f32 temporary of drawing them (``nd_init``'s
    slices), the cache (a bf16 K/V a global layer, with the cross-attention's
    K/V of ``src_len`` slots in an encoder-decoder, a ring of the window a
    local one, the f32 state and conv window an RG-LRU or SSD layer), and
    the larger of four prefill activations of the widest MLP (over the
    prompt or the sources, whichever is longer) and the SSD's intra-chunk
    f32 temporaries (``ssd_forward``: three of (B, S/q, q, q, nh) alive at
    once)."""
    from repro_torch.configs.base import (BLOCK_GLOBAL_ATTN, BLOCK_LOCAL_ATTN, BLOCK_RGLRU,
                                          BLOCK_SSD)
    from repro_torch.models.layers import DRAW_BYTES
    from repro_torch.models.ssd import chunk_len
    d, rw = cfg.d_model, cfg.rglru_width or cfg.d_model
    widest = max(cfg.d_ff, d, cfg.num_experts_per_tok * (cfg.moe_d_ff or 0))
    draw = min(DRAW_BYTES, 4 * max(cfg.vocab_size * d, cfg.num_experts * d * (cfg.moe_d_ff or 0),
                                   d * cfg.d_ff))
    conv, seq = cfg.conv_width - 1, prompt + steps
    per_layer = {
        BLOCK_GLOBAL_ATTN: 2 * batch * (seq + src_len) * cfg.num_kv_heads * cfg.head_dim * 2,
        BLOCK_LOCAL_ATTN: 2 * batch * min(cfg.local_window or seq, seq) * cfg.num_kv_heads
        * cfg.head_dim * 2,
        BLOCK_RGLRU: 4 * batch * rw * (1 + conv),
        BLOCK_SSD: 4 * batch * (cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_dim
                            + conv * (cfg.d_inner + 2 * cfg.ssm_state_dim))}
    cache = sum(per_layer[kind] for kind in cfg.layer_kinds())
    act = 4 * batch * max(prompt, src_len) * widest * 2
    if BLOCK_SSD in cfg.pattern:
        act = max(act, 3 * 4 * batch * prompt * chunk_len(cfg, prompt) * cfg.ssm_num_heads)
    return (2 * cfg.param_count() + draw + cache + act) / 1e9


def serve_zoo(card: str):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    out = {}
    for name in ZOO_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(name)
        reckoned = reckoned_peak_gb(cfg, ZOO_BATCH, ZOO_SEQ, ZOO_STEPS)
        cut = None
        if name in DEPTH_CUTS and (name == "arctic-480b" or reckoned > PEAK_BUDGET_GB):
            cut = DEPTH_CUTS[name]
            cfg = dataclasses.replace(cfg, num_layers=cut)
        log(f"[4c] {name} bf16 at full width ({cfg.num_layers} layers"
            + (f", cut from {get_config(name).num_layers}: {get_config(name).param_count() / 1e9:.1f}"
               f" B params reckoned at {reckoned:.1f} GB of device memory" if cut else "")
            + f"; d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
            f"{cfg.param_count() / 1e9:.2f} B params, peak reckoned "
            f"{reckoned_peak_gb(cfg, ZOO_BATCH, ZOO_SEQ, ZOO_STEPS):.1f} GB): {ZOO_BATCH} x "
            f"{ZOO_SEQ}-token prompts, {ZOO_STEPS} greedy steps")
        result = serve(card, cfg, ZOO_BATCH, ZOO_SEQ, ZOO_STEPS, name, profile=False)[0]
        result["depth_cut_from"] = get_config(name).num_layers if cut else None
        result["phase_s"] = time.perf_counter() - t_phase
        log(f"  {name} took {result['phase_s']:.1f} s")
        out[name] = result
        torch.cuda.empty_cache()
    log(json.dumps({"zoo": out}))
    return out


# Phase 4e: the encoder-decoder and the vision prefix-LM, whole. seamless:
# BATCH sources of SRC_LEN frame embeddings, a DEC_PROMPT-token decoder
# prompt; paligemma: BATCH x (its 256 patch embeddings + TEXT_LEN text
# tokens); STEPS greedy steps.
SEAMLESS, PALIGEMMA = "seamless-m4t-medium", "paligemma-3b"
FRONTEND_ARCHS = (SEAMLESS, PALIGEMMA)
SRC_LEN, DEC_PROMPT, TEXT_LEN = 4096, 64, 768

# Phase 4d: the two archs with recurrent blocks, whole, at phase 4's workload.
RECURRENTGEMMA = "recurrentgemma-9b"
RECURRENT_ARCHS = ("mamba2-2.7b", RECURRENTGEMMA)
GEMM_NAMES = MOE_KINDS[2][1]


def recurrent_breakdown(cfg, kind, block, batch, seq):
    """One RG-LRU or SSD block (its mixer alone: no norm, no FFN) under the
    profiler on random bf16 input, at the prefill's (batch, seq) tokens and
    at one decode step from the prefill's state: device ms, and how much of
    it the dense products (GEMM kernels) take; the rest is the plain-torch
    conv, gates, scan and the SSD's intra-chunk work."""
    import torch
    from repro_torch.models import rglru, ssd
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    forward, step = ((ssd.ssd_forward, ssd.ssd_step) if kind == "ssd"
                     else (rglru.rglru_forward, rglru.rglru_step))
    _, state = forward(cfg, block, x, return_state=True)
    out = {}
    for what, fn in (("prefill", lambda: forward(cfg, block, x, return_state=True)),
                     ("decode", lambda: step(cfg, block, x[:, -1:], state))):
        fn()
        prof = device_profile(fn, top=400)
        gemm = sum(ms for name, ms, _ in prof["top"] if any(w in name for w in GEMM_NAMES))
        busy = prof["device_busy_ms"]
        out[what] = {"tokens": batch * (seq if what == "prefill" else 1),
                     "device_busy_ms": busy, "gemm_ms": gemm,
                     "plain_ms": None if busy is None else busy - gemm, "top": prof["top"][:8]}
    del x, state
    return out


def serve_recurrent(card: str):
    """Phase 4d: mamba2-2.7b (64 SSD layers, no attention) and
    recurrentgemma-9b (26 RG-LRU and 12 local MQA layers, the 4608-token
    prompt wrapping its 2,048-slot ring) whole, at phase 4's workload and
    checks, with the reckoned peak beside the measured one and the
    recurrent blocks' share of the prefill's and a decode step's device
    time."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for name in RECURRENT_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(name)
        kinds = cfg.layer_kinds()
        reckoned = reckoned_peak_gb(cfg, BATCH, SEQ, STEPS)
        log(f"[4d] {name} bf16 at full width ({cfg.num_layers} layers: "
            + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
            + f"; d {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B "
            f"params, peak reckoned {reckoned:.1f} GB): {BATCH} x {SEQ}-token prompts, "
            f"{STEPS} greedy steps")
        result, params = serve(card, cfg, BATCH, SEQ, STEPS, name)
        kind = "ssd" if "ssd" in kinds else "rglru"
        block = params["layers"][kinds.index(kind)][kind]
        rec = recurrent_breakdown(cfg, kind, block, BATCH, SEQ)
        for what, key in (("prefill", "prefill_profile"), ("decode", "decode_step_profile")):
            total, r = result[key]["device_busy_ms"], rec[what]
            for part in ("device_busy_ms", "plain_ms"):
                r[f"{part.split('_')[0]}_share"] = (kinds.count(kind) * r[part] / total
                                                    if total and r[part] is not None else None)
            log(f"  one {kind} block at {what}'s {r['tokens']} tokens: device "
                f"{r['device_busy_ms']} ms, of which GEMM {r['gemm_ms']:.4f} ms and plain torch "
                f"{r['plain_ms']} ms; x {kinds.count(kind)} layers = {r['device_share']} of "
                f"the {what}'s device time, the plain part {r['plain_share']}")
        result.update(recurrent_block=rec, reckoned_peak_gb=reckoned,
                      phase_s=time.perf_counter() - t_phase)
        log(f"  peak memory {result['peak_mem_gb']:.2f} GB against {reckoned:.2f} GB reckoned; "
            f"{name} took {result['phase_s']:.1f} s")
        out[name] = result
        del params, block
        torch.cuda.empty_cache()
    log(json.dumps({"recurrent": out}))
    return out


def serve_frontends(card: str):
    """Phase 4e: seamless-m4t-medium (12 encoder and 12 decoder layers,
    cross-attention, attention biases) over BATCH sources of SRC_LEN frame
    embeddings with DEC_PROMPT-token decoder prompts, and paligemma-3b (18
    layers, the prefix-LM mask over 256 patch embeddings) over BATCH x (256
    patches + TEXT_LEN text tokens), whole, STEPS greedy steps each, with
    phase 4's checks and the peak memory beside the reckoned one."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for name in FRONTEND_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(name)
        if cfg.is_encoder_decoder:
            seq, src_len, prompt = DEC_PROMPT, SRC_LEN, DEC_PROMPT
            work = (f"{BATCH} sources of {SRC_LEN} frame embeddings, {DEC_PROMPT}-token "
                    f"decoder prompts")
        else:
            seq, src_len, prompt = TEXT_LEN, 0, cfg.frontend_len + TEXT_LEN
            work = f"{BATCH} x ({cfg.frontend_len} patch embeddings + {TEXT_LEN} text tokens)"
        reckoned = reckoned_peak_gb(cfg, BATCH, prompt, STEPS, src_len)
        log(f"[4e] {name} bf16 at full width ({cfg.num_layers} layers"
            + (f" + {cfg.num_encoder_layers} encoder layers" if cfg.is_encoder_decoder else "")
            + f"; d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
            f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params, peak reckoned "
            f"{reckoned:.1f} GB): {work}, {STEPS} greedy steps")
        result, params = serve(card, cfg, BATCH, seq, STEPS, name, src_len=src_len)
        result.update(reckoned_peak_gb=reckoned, phase_s=time.perf_counter() - t_phase)
        log(f"  peak memory {result['peak_mem_gb']:.2f} GB against {reckoned:.2f} GB reckoned; "
            f"{name} took {result['phase_s']:.1f} s")
        out[name] = result
        del params
        torch.cuda.empty_cache()
    log(json.dumps({"frontends": out}))
    return out


# ------------------------------------------------------------------ phase 5
def gather_full_width(errs):
    """The CIAO gather path at full width; returns its launch count and its
    inputs, (table, indices, streams, {label: iso_map})."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ciao_gather import kernel as CK, ops as CO
    from repro_torch.workloads import gather_index_stream
    cfg = get_config("gemma2-2b")
    rows, d = cfg.vocab_size, cfg.d_model
    indices, streams, iso = gather_index_stream(0, 1.0, table_rows=rows)
    log(f"[5] CIAO gather path: {len(indices)} requests of {len(iso)} streams "
        f"({int(iso.sum())} isolated), {len(np.unique(indices))} distinct rows of a bf16 "
        f"{rows} x {d} table (gemma2-2b's vocab x d_model), c_main 256, c_iso 64")
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn(rows, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    idx, st = (torch.from_numpy(a.astype(np.int32)).cuda() for a in (indices, streams))
    isos = {"isolated": torch.from_numpy(iso).cuda(),
            "not isolated": torch.zeros_like(torch.from_numpy(iso)).cuda()}
    sync()
    CK.ciao_gather_cuda.launches = 0
    t0 = time.perf_counter()
    runs = {label: CO.ciao_gather(table, idx, st, bits) for label, bits in isos.items()}
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = CK.ciao_gather_cuda.launches
    log(f"  two ciao_gather calls: {wall_ms:.2f} ms, launches {launches} (want {len(runs)})")
    if launches != len(runs):
        fail(f"ciao_gather launch count {launches}, want {len(runs)}")
    regular = torch.from_numpy(iso == 0).cuda()
    for label, (out, stats) in runs.items():
        ref_out, ref_stats = CO.ciao_gather_plain(table, idx, st, isos[label])
        same_rows = byte_equal(out, ref_out)
        same_stats = stats.shape == ref_stats.shape and bool((stats == ref_stats).all())
        errs["ciao_gather"][f"bfloat16 main {label}"] = max_err(out, ref_out)
        log(f"  {label}: rows byte-equal to table[indices] {same_rows}, stats equal to the "
            f"plain cache_sim_ref {same_stats}; misses regular streams "
            f"{int(stats[regular, 1].sum())}, irregular {int(stats[~regular, 1].sum())}, "
            f"hits {int(stats[:, 0].sum())}")
        if not (same_rows and same_stats):
            fail(f"the CIAO gather path ({label}) disagrees with the plain version")
        if tuple(out.shape) != (len(indices), d) or int(stats.sum()) != len(indices):
            fail(f"the CIAO gather path ({label}) gave out {tuple(out.shape)}, "
                 f"{int(stats.sum())} counted requests")
    del runs
    return launches, (table, idx, st, isos)


# ------------------------------------------------------------------ phase 6
def flash_bound(q, k, v, window, causal=True, prefix=0):
    """K3's (operations, bytes): 4 D operations a (query, key) pair the mask
    allows (every pair when not causal; causal: keys up to the query's
    position, inside the window, or before the prefix), q, k, v read once
    and out written once."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if not causal:
        pairs = sq * skv
    else:
        pairs = sum(min(i + 1, window) if window else min(max(i + 1, prefix), skv)
                    for i in range(sq))
    ops = 4 * d * b * hq * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))   # q, k, v in; out
    return ops, nbytes


def decode_bound(q, ck, lengths):
    b, _, hq, d = q.shape
    hkv = ck.shape[2]
    n = int(lengths.sum())
    ops = 4 * d * hq * n
    nbytes = 2 * n * hkv * d * ck.element_size() + 2 * q.numel() * q.element_size() \
        + lengths.numel() * 4
    return ops, nbytes


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_BF16_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_flash(q, k, v, window, lengths=None, scale=SCALE, cap=50.0, causal=True,
                  prefix=0, lse=False):
    """One PyTorch call computing the same function: flex_attention with the
    softcap (when ``cap``) as score_mod and the mask as a block mask (K3's:
    causal with the window or the prefix, or none; K2's: ``lengths``),
    compiled (with ``lse``, returning the log-sum-exp too). Timed as a
    yardstick only; the port never calls it. Each new
    shape or mask compiles anew; past dynamo's recompile limit (8) a call
    would run flex_attention unfused, which materialises the scores, so
    the limit is raised to cover every shape the script times."""
    import torch
    import torch._dynamo
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    torch._dynamo.config.recompile_limit = max(torch._dynamo.config.recompile_limit, 64)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    b, hq, sq, _ = qt.shape
    skv = kt.shape[2]
    if lengths is None and not causal:
        def mask(bi, h, qi, ki):
            return ki >= 0
    elif lengths is None:
        def mask(bi, h, qi, ki):
            ok = ki <= qi
            if prefix:
                ok = ok | (ki < prefix)
            return ok & (qi - ki < window) if window else ok
    else:
        def mask(bi, h, qi, ki):
            return ki < lengths[bi]

    def softcap(score, bi, h, qi, ki):
        return torch.tanh(score / cap) * cap

    block = create_block_mask(mask, b, None, sq, skv, device="cuda")
    fn = torch.compile(flex_attention)
    extra = {"return_lse": True} if lse else {}
    return lambda: fn(qt, kt, vt, score_mod=softcap if cap else None, block_mask=block,
                      scale=scale, enable_gqa=True, **extra), lambda out: out.transpose(1, 2)


def gather_bound(table, idx, streams, iso):
    """Bytes K1 must move: out written, each distinct row read once, the
    requests, the isolation bits and the counts."""
    import torch
    row = table.shape[1] * table.element_size()
    distinct = torch.unique(idx).numel()
    return 0, (idx.numel() + distinct) * row + 4 * (idx.numel() + streams.numel()) \
        + 4 * iso.numel() + 8 * iso.numel()


def time_gather(table, idx, st, isos):
    """K1 at the gather path's inputs: kernel, plain version and
    ``torch.index_select`` (which computes out only) per call, and the
    kernel's launches (pre-pass and gather) by device time."""
    import torch
    from repro_torch.kernels.ciao_gather import kernel as CK, ops as CO
    rows = {}
    for label, iso in isos.items():
        def call():
            return CK.ciao_gather_cuda(table, idx, st, iso, c_main=256, c_iso=64)

        ms = cuda_ms(call, 20, warmup=2)
        prof = device_profile(lambda: [call() for _ in range(5)])
        plain = cuda_ms(lambda: CO.ciao_gather_plain(table, idx, st, iso), 1)
        lib = cuda_ms(lambda: torch.index_select(table, 0, idx), 20, warmup=2)
        b_ms, by = bound_ms(*gather_bound(table, idx, st, iso))
        rows[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                       "bound_by": by, "profile_5_calls": prof}
        log(f"  ciao_gather {label}: kernel {ms:.4f} ms, plain {plain:.2f} ms, "
            f"index_select (out only) {lib:.4f} ms, bound {b_ms:.4f} ms ({by}); 5 calls "
            f"under the profiler, device ms a launch:")
        for name, k_ms, calls in prof["top"]:
            log(f"    {k_ms / calls:9.4f} ms ({calls:2d} launches)  {name}")
    return rows


# the zoo paths whose last decode step phase 6 times K2 at: granite-moe
# (4b; G 3, D 64), qwen3, nemotron, command-r and arctic (4c; G 4, 6, 8 and
# 7, D 128) and recurrentgemma (4d; G 16, D 256), all on the ring kernel;
# and whose prefill it times K3 at: every zoo path's (granite-moe's D 64 and
# the 4c archs' D 128 plans, recurrentgemma's G 16 with a window of 2048)
ZOO_DECODE = (GRANITE, "qwen3-4b", "nemotron-4-15b", "command-r-35b", "arctic-480b",
              RECURRENTGEMMA)
ZOO_PREFILL = ZOO_DECODE
# the calls of phase 4e's paths that phase 6 times (``frontend_calls``): K3
# at seamless's encoder and cross prefill and at paligemma's prefill (the
# prefix mask), K2 at seamless's cross step and at paligemma's last step
FRONTEND_TIMED = ((SEAMLESS, "encoder"), (SEAMLESS, "cross prefill"), (PALIGEMMA, "prefill"),
                  (SEAMLESS, "cross step"), (PALIGEMMA, "last step"))


PROFILE_TRIES = 4


def k2_path(prof):
    """Which CUDA path K2's launches under the profiler took, from the
    kernels' names: "ring mma" (decode_ring_mma_kernel alone: the ring
    kernel's tensor-core consumer), "ring" (decode_ring_kernel alone),
    "split" (decode_split_kernel + decode_combine_kernel), or None if no
    one of them ran alone."""
    names = [name for name, _, _ in prof["top"] if "decode_" in name]
    kinds = {kind for kind in ("decode_ring_mma_kernel", "decode_ring_kernel",
                               "decode_split_kernel", "decode_combine_kernel")
             if any(f"::{kind}<" in name for name in names)}
    return {frozenset({"decode_ring_mma_kernel"}): "ring mma",
            frozenset({"decode_ring_kernel"}): "ring",
            frozenset({"decode_split_kernel", "decode_combine_kernel"}): "split"}.get(
                frozenset(kinds))


def k2_want(q_dtype, kv_dtype, hq, hkv, d):
    """The path ``k2_path`` must see for a K2 call of these heads."""
    from repro_torch.kernels.decode_attn import kernel as DK
    if not DK.uses_ring(q_dtype, kv_dtype, d):
        return "split"
    return "ring mma" if DK.uses_mma(d, hq // hkv) else "ring"


def profile_k2_rows(rows):
    """Phase 6's K2 rows ({label: (b, s, hq, hkv, d, scale, softcap)}, bf16,
    every slot valid) each profiled in one process of its own, started
    fresh: a spin kernel, then 5 calls, inside 50 ms of host time on each
    side, up to PROFILE_TRIES windows until one shows a K2 kernel. In a
    fresh process every such window saw its kernels (80 of 80 at four of
    these shapes, ``tools/kernel_probe.py --profile-windows``), while after
    phases 2-5 whole windows came back empty (the profiler saw no device
    work at all, not even the spin kernel) at 3 of the 8 rows, in all 4
    tries. Returns {label: {"path", "top", "windows"}}."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--profile-k2",
                          json.dumps(rows)], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"phase 6: the K2 profiling process failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def profile_k2_main(rows):
    """The process of ``profile_k2_rows``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attn import kernel as DK   # built by phase 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    result = {}
    for label, (b, s, hq, hkv, d, scale, cap) in rows.items():
        dq = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")

        def window():
            time.sleep(0.05)
            torch.cuda._sleep(1_000_000)
            for _ in range(5):
                DK.decode_attention_cuda(dq, ck, cv, lens, scale=scale, softcap=cap)
            sync()
            time.sleep(0.05)

        window()
        for tries in range(1, PROFILE_TRIES + 1):
            prof = device_profile(window)
            if k2_path(prof) is not None:
                break
        result[label] = {"path": k2_path(prof), "top": prof["top"], "windows": tries}
        del dq, ck, cv
    print(json.dumps(result), flush=True)


def time_decode(label, dq, ck, cv, lens, scale, cap):
    """K2 at one shape: events around 50 back-to-back calls, a CUDA graph of
    100, the plain version, flex_attention and the bound. Returns (ms,
    plain, library, bound, bound_by, extra); ``extra["profile"]`` is the
    row for ``profile_k2_rows``, which ``observe_k2_paths`` runs after all
    of phase 6's rows."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    args = dict(scale=scale, softcap=cap)

    def k2():
        return DK.decode_attention_cuda(dq, ck, cv, lens, **args)

    ms = cuda_ms(k2, 50, warmup=5)       # back to back: the host's launch cost included
    device = graph_ms(k2, 100)           # the card's time alone
    plain = cuda_ms(lambda: DO.decode_attention_plain(dq, ck, cv, lens, **args), 10)
    lib = lib_err = None
    try:
        call, back = library_flash(dq, ck, cv, 0, lengths=lens, scale=scale, cap=cap)
        lib_err = max_err(back(call()), k2())
        lib = cuda_ms(call, 50, warmup=5)
    except Exception as e:  # the yardstick only; the port does not depend on it
        log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
    b_ms, by = bound_ms(*decode_bound(dq, ck, lens))
    log(f"  {label}: kernel {ms:.4f} ms (events, 50 calls), {device:.4f} ms "
        f"(CUDA graph of 100 calls), plain {plain:.4f} ms, flex_attention {lib} ms "
        f"(max|diff| {lib_err}), bound {b_ms:.4f} ms ({by})")
    b, s, hkv, d = dq.shape[0], ck.shape[1], ck.shape[2], dq.shape[-1]
    return ms, plain, lib, b_ms, by, {"device_ms": device,
                                      "profile": (b, s, dq.shape[2], hkv, d, scale, cap)}


def observe_k2_paths(rows):
    """``profile_k2_rows`` over phase 6's K2 rows ({label: time_decode's
    extra}): logs each row's profiled launches and fails unless each took
    ``k2_want``'s path; sets each row's "path" and "profile_5_calls"."""
    import torch
    shapes = {label: extra.pop("profile") for label, extra in rows.items()}
    seen = profile_k2_rows(shapes)
    log(f"  K2's paths, profiled in a fresh process ({PROFILE_TRIES} windows at most a row):")
    for label, extra in rows.items():
        got = seen[label]
        _, _, hq, hkv, d, _, _ = shapes[label]
        want = k2_want(torch.bfloat16, torch.bfloat16, hq, hkv, d)
        log(f"  {label}: path {got['path']} (window {got['windows']} of {PROFILE_TRIES}), "
            f"device ms a launch:")
        for name, k_ms, calls in got["top"]:
            log(f"    {k_ms / calls:9.4f} ms ({calls:2d} launches)  {name}")
        if got["path"] != want:
            fail(f"phase 6: K2 at {label} {shapes[label]} took the path {got['path']}, not "
                 f"{want} (profiled kernels: {[n for n, _, _ in got['top']]})")
        extra.update(path=got["path"], profile_5_calls=got["top"],
                     profile_windows=got["windows"])



def time_kernels(errs, launches, card, gather, paths):
    """Phase 6. ``launches``: each kernel's launches over the main paths;
    ``paths``: K3's and K2's launches on each serving path."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    log("[6] kernel times at the main paths' shapes, bf16")
    gen = torch.Generator(device="cuda").manual_seed(2)
    (q, k, v), decode = main_path_inputs(torch.bfloat16, gen)
    rows = {"flash_attn": [], "decode_attn": []}
    for kind, window in (("local", WINDOW), ("global", 0)):
        args = dict(scale=SCALE, causal=True, window=window, softcap=50.0)
        ms = cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 5)
        device = graph_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 20)
        plain = cuda_ms(lambda: FO.flash_attention_plain(q, k, v, **args), 2)
        lib = lib_err = None
        try:
            call, back = library_flash(q, k, v, window)
            lib_err = max_err(back(call()), FK.flash_attention_cuda(q, k, v, **args))
            lib = cuda_ms(call, 5, warmup=2)
        except Exception as e:  # the yardstick only; the port does not depend on it
            log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
        b_ms, by = bound_ms(*flash_bound(q, k, v, window))
        mode = FK.launch_plan(q.shape[0], q.shape[2], q.shape[1], k.shape[1], True, window,
                              0, q.shape[3])[0]
        rows["flash_attn"].append((ms, plain, lib, b_ms, by, {"device_ms": device,
                                                              "launch": mode}))
        log(f"  flash_attn {kind}: kernel {ms:.4f} ms (events), {device:.4f} ms (CUDA graph of "
            f"20 calls, {mode}), plain {plain:.4f} ms, flex_attention {lib} ms (max|diff| "
            f"{lib_err}), bound {b_ms:.4f} ms ({by})")
    del q, k, v
    k2_rows, k2_targets = {}, []     # K2's rows for observe_k2_paths, where each path goes
    for kind in ("local", "global"):
        rows["decode_attn"].append(time_decode(f"decode_attn {kind}", *decode[kind],
                                               SCALE, 50.0))
        k2_rows[f"decode_attn {kind}"] = rows["decode_attn"][-1][5]
    # K3 at the zoo's prefill shapes (ZOO_PREFILL), no softcap, by events
    # and over a CUDA graph of 20 calls; the plain version a batch row at a
    # time (granite's (24, 4608, 4608) f32 scores are 2 GB a row)
    zoo_prefill = {}
    t_zoo = time.perf_counter()
    for name, b, sq, steps, hq, hkv, d, scale, window in zoo_paths():
        if name not in ZOO_PREFILL:
            continue
        q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, sq, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        args = dict(scale=scale, causal=True, window=window, softcap=0.0)
        ms = cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 5)
        device = graph_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 20)
        plain = cuda_ms(lambda: [FO.flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                          **args) for i in range(b)], 2)
        lib = lib_err = None
        try:
            call, back = library_flash(q, k, v, window, scale=scale, cap=0.0)
            lib_err = max_err(back(call()), FK.flash_attention_cuda(q, k, v, **args))
            lib = cuda_ms(call, 5, warmup=2)
        except Exception as e:  # the yardstick only; the port does not depend on it
            log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
        b_ms, by = bound_ms(*flash_bound(q, k, v, window))
        zoo_prefill[name] = {"shape": {"batch": b, "seq": sq, "hq": hq, "hkv": hkv, "d": d,
                                       "window": window},
                             "launches": paths[name]["flash_attn"], "ms": ms, "device_ms": device,
                             "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                             "bound_by": by,
                             "launch": FK.launch_plan(b, hq, sq, sq, True, window, 0, d)[0]}
        log(f"  flash_attn {name} prefill (B {b}, S {sq}, {hq}/{hkv} heads of {d}, window "
            f"{window}): kernel {ms:.4f} ms (events), {device:.4f} ms (CUDA graph of 20 calls), "
            f"plain {plain:.4f} ms, flex_attention {lib} ms (max|diff| {lib_err}), bound "
            f"{b_ms:.4f} ms ({by}); {paths[name]['flash_attn']} launches on its path")
        del q, k, v
        torch.cuda.empty_cache()
    log(f"  K3 at the {len(zoo_prefill)} zoo prefills took {time.perf_counter() - t_zoo:.1f} s")
    # K2 at the zoo's decode shapes: each arch's last step of its
    # phase-4b/4c/4d run (recurrentgemma's wrapped ring), no softcap
    zoo = {}
    for name, b, sq, steps, hq, hkv, d, scale, window in zoo_paths():
        if name not in ZOO_DECODE:
            continue
        s = min(sq + steps, window or sq + steps)
        dq = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        label = f"decode_attn {name} (B {b}, S {s}, {hq}/{hkv} heads of {d})"
        ms, plain, lib, b_ms, by, extra = time_decode(label, dq, ck, cv, lens, scale, 0.0)
        zoo[name] = {"shape": {"batch": b, "slots": s, "hq": hq, "hkv": hkv, "d": d},
                     "launches": paths[name]["decode_attn"], "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": by,
                     "device_ms": extra["device_ms"]}
        k2_rows[label] = extra
        k2_targets.append((zoo[name], extra))
        del dq, ck, cv
    # K3 and K2 at phase 4e's shapes (FRONTEND_TIMED), no softcap, each
    # beside its kernel's launches over that path's run (seamless's K3
    # count covers its encoder, self and cross calls, 12 each)
    frontend = {"flash_attn": {}, "decode_attn": {}}
    for name, call, kernel, shape, scale in frontend_calls():
        if (name, call) not in FRONTEND_TIMED:
            continue
        label = f"{name} {call}"
        if kernel == "decode_attn":
            dq, ck, cv, lens, args = frontend_inputs(kernel, shape, scale, torch.bfloat16, gen)
            row = (f"decode_attn {label} (B {shape[0]}, S {shape[1]}, {shape[2]}/{shape[3]} "
                   f"heads of {shape[4]})")
            ms, plain, lib, b_ms, by, extra = time_decode(row, dq, ck, cv, lens, scale, 0.0)
            k2_rows[row] = extra
            del dq, ck, cv
        else:
            q, k, v, args = frontend_inputs(kernel, shape, scale, torch.bfloat16, gen)
            causal, prefix = args["causal"], args["prefix_len"]
            ms = cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 5)
            plain = cuda_ms(lambda: FO.flash_attention_plain(q, k, v, **args), 2)
            lib = lib_err = None
            try:
                fn, back = library_flash(q, k, v, 0, scale=scale, cap=0.0,
                                         causal=causal, prefix=prefix)
                lib_err = max_err(back(fn()), FK.flash_attention_cuda(q, k, v, **args))
                lib = cuda_ms(fn, 5, warmup=2)
            except Exception as e:  # the yardstick only; the port does not depend on it
                log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
            b_ms, by = bound_ms(*flash_bound(q, k, v, 0, causal, prefix))
            device = graph_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 20)
            mode = FK.launch_plan(shape[0], shape[3], shape[1], shape[2], causal, 0, prefix,
                                  shape[5])[0]
            extra = {"device_ms": device, "launch": mode}
            log(f"  flash_attn {label} (B {shape[0]}, Sq {shape[1]}, Skv {shape[2]}, "
                f"{shape[3]}/{shape[4]} heads of {shape[5]}, causal {causal}, prefix {prefix}): "
                f"kernel {ms:.4f} ms (events), {device:.4f} ms (CUDA graph of 20 calls, {mode}), "
                f"plain {plain:.4f} ms, flex_attention {lib} ms (max|diff| {lib_err}), bound "
                f"{b_ms:.4f} ms ({by})")
            del q, k, v
        frontend[kernel][label] = {
            "shape": list(shape), "path_launches": paths[name][kernel], "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms, "bound_by": by,
            **{key: extra[key] for key in ("device_ms", "launch") if key in extra}}
        if kernel == "decode_attn":
            k2_targets.append((frontend[kernel][label], extra))
    observe_k2_paths(k2_rows)
    for target, extra in k2_targets:
        target["path"] = extra["path"]

    def mean(xs):   # over the two layer kinds, each half of the serving path's layers
        return None if None in xs else sum(xs) / len(xs)

    meta = {
        "flash_attn": ("src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                       "src/repro/kernels/flash_attn/kernel.py:85"),
        "decode_attn": ("src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
                        "src/repro/kernels/decode_attn/kernel.py:57")}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(e for c, e in errs[name].items()
                               if "bfloat16 main" in c and "with lse" not in c),
            "ms": mean([x[0] for x in r]), "plain_ms": mean([x[1] for x in r]),
            "bound_ms": mean([x[3] for x in r]),
            "bound_by": r[0][4] if all(x[4] == r[0][4] for x in r) else "mixed",
            "library_ms": mean([x[2] for x in r]),
            **({"device_ms": mean([x[5]["device_ms"] for x in r])} if "device_ms" in r[0][5]
               else {}),
            "per_layer_kind": {kind: {"ms": x[0], "plain_ms": x[1], "library_ms": x[2],
                                      "bound_ms": x[3], "bound_by": x[4], **x[5]}
                               for kind, x in zip(("local", "global"), r)},
            "launches_by_path": {path: n[name] for path, n in paths.items()},
            "zoo_shapes": zoo if name == "decode_attn" else zoo_prefill,
            "frontend_shapes": frontend[name],
            "card": card})
    g = time_gather(*gather)
    kernels.append({
        "name": "ciao_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/ciao_gather/csrc/ciao_gather.cu",
        "replaces": "src/repro/kernels/ciao_gather/kernel.py:84",
        "launches": launches["ciao_gather"],
        "max_abs_err": max(e for c, e in errs["ciao_gather"].items() if "bfloat16 main" in c),
        **{key: mean([r[key] for r in g.values()])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "library_call": "torch.index_select(table, 0, indices): computes out only; no "
                        "library call computes the hit and miss counts",
        "per_call": g, "card": card})
    return kernels


# ------------------------------------------------------------------ phase 7
# The simulator path: the batched engine's torch stepper on the card against
# the golden cells and the port's C stepper. The grids are the reference's
# benchmarks/bench_batched.py ones, rebuilt here from the port's modules.
GOLDEN = ROOT / "tests" / "golden" / "golden_cells.json.gz"
SIM_FIELDS = ("policy", "cycles", "instructions", "ipc", "l1_hit_rate",
              "vta_hits", "mean_active_warps", "timeline", "pairs")
FIG8_APPS = ("kmn", "bicg", "mvt", "kmeans", "syrk", "gesummv", "syr2k", "ii",
             "backprop", "conv2d", "gaussian", "nw")
POLICIES = ("gto", "ccws", "best-swl", "statpcal", "ciao-p", "ciao-t", "ciao-c")
SWEEP_APPS = ("kmn", "syrk", "nw", "bicg")
GRID_SCALE, WIDTH_SCALE, WIDTH = 0.5, 0.05, 3584


def golden_sm_cells():
    import gzip
    doc = json.loads(gzip.decompress(GOLDEN.read_bytes()).decode())
    return [c for c in doc["cells"] if c["kind"] == "sm"]


def golden_batch(cells, scale=None):
    """The golden single-SM cells as BatchCells (at their own scale, or at
    ``scale``), one workload object a (name, seed, scale)."""
    from repro_torch.core.batched import BatchCell
    from repro_torch.workloads import make_workload
    wls, batch = {}, []
    for c in cells:
        key = (c["workload"], c["seed"], c["scale"] if scale is None else scale)
        if key not in wls:
            wls[key] = make_workload(key[0], seed=key[1], scale=key[2])
        batch.append(BatchCell(wls[key], c["policy"], dict(c["policy_kwargs"])))
    return batch


def fig8_batch(scale=GRID_SCALE):
    """bench_batched.py's fig8 grid: 12 apps x 7 policies, seed 0."""
    from repro_torch.core.batched import BatchCell
    from repro_torch.workloads import make_workload
    return [BatchCell(make_workload(w, seed=0, scale=scale), p)
            for w in FIG8_APPS for p in POLICIES]


def sweep_batch(scale=GRID_SCALE):
    """bench_batched.py's knob sweep: 4 apps x ciao-c x 256 detector
    variants (32 cutoffs x 8 low epochs), each capped at 20,000 cycles."""
    from repro_torch.core.batched import BatchCell
    from repro_torch.core.interference import DetectorConfig
    from repro_torch.core.simulator import SimConfig
    from repro_torch.workloads import make_workload
    cfgs = []
    for i in range(32):
        cut = round(0.2 + 0.75 * i / 31, 3)
        for e in (25, 50, 100, 200, 400, 800, 1600, 3200):
            cfgs.append(SimConfig(max_cycles=20_000, detector=DetectorConfig(
                low_cutoff=cut, high_cutoff=min(cut + 0.2, 0.97),
                low_epoch=e, high_epoch=e * 20)))
    return [BatchCell(make_workload(w, seed=0, scale=scale), "ciao-c", cfg=cfg)
            for w in SWEEP_APPS for cfg in cfgs]


def golden_mismatches(results, cells):
    """Fields of each result that differ from its golden record, compared
    as tests/test_batched.py compares them."""
    import dataclasses
    bad = []
    for c, res in zip(cells, results):
        got = dataclasses.asdict(res)
        got["timeline"] = [list(t) for t in got["timeline"]]
        want = c["result"]
        bad += [f"{c['workload']}/{c['policy']}: {f}" for f in SIM_FIELDS if got[f] != want[f]]
        bad += [f"{c['workload']}/{c['policy']}: stat {k}" for k, v in want["stats"].items()
                if got["stats"].get(k) != v]
    return bad


def run_stepper(batch, backend):
    """One run of a batch on a stepper through the engine's public entry
    point (the torch stepper on the card, its default): (results, engine
    perf)."""
    import torch
    from repro_torch.core.batched import BatchedSMEngine
    if backend == "torch":
        torch.cuda.reset_peak_memory_stats()
        eng = BatchedSMEngine(batch)
    else:
        eng = BatchedSMEngine(batch, backend=backend)
    res = eng.run()
    perf = dict(eng.perf)
    if backend == "torch":
        perf["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, perf


def time_steppers(label, batch):
    """One run of a batch on the C stepper, then one on the torch stepper;
    fails unless the torch records equal the C stepper's. A torch run that
    captures its CUDA graph reports the capture apart (``capture_s``, left
    out of ``torch_s``). Returns (the row of the stepper table, the torch
    results, the CUDA graph the torch run replayed)."""
    import dataclasses
    from repro_torch.core import torch_backend
    res_c, perf_c = run_stepper(batch, "c")
    res_t, perf_t = run_stepper(batch, "torch")
    graph = torch_backend.GRAPHS.last
    if perf_t["graph"] and graph is None:
        fail(f"stepper {label}: the torch run replayed no recorded graph")
    got = [dataclasses.asdict(r) for r in res_t]
    want = [dataclasses.asdict(r) for r in res_c]
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        fail(f"stepper {label}: {bad} of {len(batch)} torch records differ from the C "
             f"stepper's")
    torch_s, c_s = perf_t["stepper_s"] - perf_t["capture_s"], perf_c["stepper_s"]
    row = {"cells": len(batch), "iterations": int(perf_t["iterations"]),
           "graph": bool(perf_t["graph"]), "torch_first_s": perf_t["stepper_s"],
           "capture_s": perf_t["capture_s"], "torch_s": torch_s, "c_s": c_s,
           "torch_cells_per_s": len(batch) / torch_s, "c_cells_per_s": len(batch) / c_s,
           "ms_per_iteration": 1e3 * torch_s / max(perf_t["iterations"], 1),
           "peak_gb": perf_t["peak_gb"], "build_s": perf_t["build_s"],
           "drain_s": perf_t["drain_s"]}
    log(f"  {label}: {len(batch)} cells, records equal to the C stepper's; torch "
        f"{'graph' if row['graph'] else 'eager'} {torch_s:.3f} s ({row['iterations']} "
        f"iterations, {row['ms_per_iteration']:.4f} ms each; {row['capture_s']:.3f} s "
        f"capture apart), C {c_s:.4f} s; cells/s torch {row['torch_cells_per_s']:.1f}, "
        f"C {row['c_cells_per_s']:.1f}; peak {row['peak_gb']:.3f} GB; engine build "
        f"{row['build_s']:.2f} s, finalize {row['drain_s']:.2f} s")
    return row, res_t, graph


def chunk_idle_share(graph, ms_per_iteration=None, top=3):
    """One replay of ``graph`` (a captured chunk) under the profiler: its
    device busy ms, and the idle share 1 - busy / wall, both against the
    profiler's wall (which the profiler itself lengthens) and against the
    chunk's time without it (``ms_per_iteration`` x the chunk length)."""
    from repro_torch.core import torch_backend
    prof = device_profile(graph.graph.replay, top=top)
    busy = prof["device_busy_ms"]
    out = {"wall_ms": prof["wall_ms"], "device_busy_ms": busy, "top": prof["top"],
           "idle_share_profiled": None if busy is None else 1.0 - busy / prof["wall_ms"]}
    if ms_per_iteration is not None:
        out["chunk_ms"] = ms_per_iteration * torch_backend.CHUNK
        out["idle_share"] = None if busy is None else 1.0 - busy / out["chunk_ms"]
    return out


def simulator_path(card):
    """Phase 7: the golden cells, the fig8 grid, the knob sweep and the
    golden batch at scale 0.05 and 3,584 cells through the torch stepper on
    the card, each held against the C stepper and timed once."""
    from repro_torch.core import _cstep
    from repro_torch.core.batched import run_batched
    t_phase = time.perf_counter()
    if not _cstep.available():
        fail(f"the port's C stepper does not build: {_cstep.unavailable_reason()}")
    cells = golden_sm_cells()
    log(f"[7] simulator path: the C stepper built ({_cstep.BUILD_DIR.relative_to(ROOT)}); "
        f"{len(cells)} golden single-SM cells at scale {cells[0]['scale']}")
    batch = golden_batch(cells)
    out = {"card": card}
    out["golden"], res, _ = time_steppers("golden", batch)
    bad = golden_mismatches(res, cells) + golden_mismatches(run_batched(batch, backend="c"), cells)
    if bad:
        fail(f"the steppers disagree with the golden cells: {bad[:10]}")
    log("  golden: every field of the 7 cells equals golden_cells.json.gz through the torch "
        "stepper on cuda and through the C stepper")
    out["fig8"] = time_steppers(f"fig8 (12 apps x 7 policies, scale {GRID_SCALE})",
                                fig8_batch())[0]
    out["sweep"], _, graph = time_steppers(f"sweep (4 apps x ciao-c x 256 variants, 20,000 "
                                           f"cycles, scale {GRID_SCALE})", sweep_batch())
    out["sweep"]["idle"] = chunk_idle_share(graph, out["sweep"]["ms_per_iteration"])
    log(f"  one chunk of the sweep under the profiler: {out['sweep']['idle']}")
    base = golden_batch(cells, WIDTH_SCALE)
    out["wide"] = time_steppers(f"golden x {WIDTH // len(base)} at scale {WIDTH_SCALE}",
                                base * (WIDTH // len(base)))[0]
    runs = sorted((r["cells"], r["torch_s"] < r["c_s"]) for k, r in out.items()
                  if isinstance(r, dict) and "cells" in r)
    wins = [w for w, won in runs if won]
    out["crossover"] = wins[0] if wins else None
    log("  crossover: " + (f"torch beats the C stepper from {wins[0]} cells" if wins else
                           f"none up to {runs[-1][0]} cells: the C stepper is faster on "
                           f"every batch run"))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 7 took {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 8
# Training. 8a: every arch's reduced config at f32 (TF32 off), one train step
# on the card against the same step on the CPU. 8b: full-width gemma2-2b in
# bf16 at TRAIN_4K's sequence length, its global batch of 256 (a pod's) cut
# to TRAIN_BATCH for one card.
TRAIN_ARCHS = ("gemma2-2b", GRANITE) + ZOO_ARCHS + RECURRENT_ARCHS + FRONTEND_ARCHS
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_CHUNK, TRAIN_LR = 4096, 2, 8, 1024, 3e-3
# CPU and card from the same f32 state compute the same f32 arithmetic in
# another order. A gradient leaf within GRAD_RTOL of its max |g| (GRAD_ATOL
# where the gradient is zero in exact arithmetic, as a key bias's: softmax
# ignores it); loss, grad norm and lr within METRIC_RTOL; a parameter after
# the step within PARAM_ATOL where the CPU's gradient is resolved: at least
# RESOLVED_GRAD (100x AdamW's eps) and RESOLVED_SHARE of its leaf's max |g|
# (f32 rounding of a leaf's sums is ~1e-6 of its max). Below that, Adam's
# normalisation turns rounding into up to a whole step, so there within the
# step's reach. A bf16 step's loss within BF16_RTOL of the CPU's bf16 loss.
GRAD_RTOL, GRAD_ATOL, METRIC_RTOL, PARAM_ATOL = 1e-4, 1e-7, 1e-5, 1e-6
RESOLVED_GRAD, RESOLVED_SHARE = 1e-6, 1e-3
BF16_RTOL = 2e-2


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def copy_tree(tree, device):
    """A copy of every tensor of ``tree`` on ``device`` (a new tensor even
    where it is already there)."""
    from repro_torch.train.tree import tree_map
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def kernel_counts(reset=False):
    """The three kernels' launch counters (set to 0 first when ``reset``)."""
    from repro_torch.kernels.ciao_gather.kernel import ciao_gather_cuda
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    wrappers = {"flash_attn": flash_attention_cuda, "decode_attn": decode_attention_cuda,
                "ciao_gather": ciao_gather_cuda}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {name: w.launches for name, w in wrappers.items()}


def grads_err(mine, ref):
    """(largest |mine - ref| over a leaf as a share of its tolerance, that leaf)."""
    from repro_torch.train.tree import flatten_with_paths
    ref_flat = flatten_with_paths(ref)
    worst = (0.0, "")
    for key, t in flatten_with_paths(mine).items():
        r = ref_flat[key].to(t.device).float()
        worst = max(worst, (max_err(t, r) / max(GRAD_RTOL * r.abs().max().item(), GRAD_ATOL),
                            key))
    return worst


def params_err(before, after, after_ref, grads_ref, wd):
    """(largest disagreement of a parameter after one step as a share of its
    tolerance: PARAM_ATOL where the reference's gradient is resolved
    (RESOLVED_GRAD, RESOLVED_SHARE), else the step's reach 2 lr (1 + wd |p|);
    that leaf)."""
    import torch
    from repro_torch.train.tree import flatten_with_paths
    b, a, r, g = (flatten_with_paths(t) for t in (before, after, after_ref, grads_ref))
    worst = (0.0, "")
    for key, p in b.items():
        p = p.cpu().float()
        diff = (a[key].cpu().float() - r[key].cpu().float()).abs()
        reach = 2 * TRAIN_LR * (1 + wd * p.abs()) + PARAM_ATOL
        grad = g[key].cpu().float().abs()
        resolved = grad >= max(RESOLVED_GRAD, RESOLVED_SHARE * grad.max().item())
        tol = torch.where(resolved, PARAM_ATOL, reach)
        worst = max(worst, ((diff / tol).max().item(), key))
    return worst


def fresh_state(cfg, params, device):
    """A train state around a copy of ``params`` on ``device``, at step 1
    (the lr schedule gives 0 at step 0)."""
    import torch
    from repro_torch.train import optim as O, train_step as TS
    params = copy_tree(params, device)
    return {"params": params,
            "opt": O.make_optimizer(cfg.optimizer)[0](params, TS.optimizer_groups(cfg, params)),
            "step": torch.ones((), dtype=torch.int32, device=device)}


def train_reduced_arch(name, ckpt_dir):
    """Phase 8a for one arch; returns (its numbers, what disagrees)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.model import init_params
    from repro_torch.train import checkpoint as CK, train_step as TS
    from repro_torch.train.data import SyntheticLM, as_tensors
    from repro_torch.train.tree import flatten_with_paths
    cfg = reduced_config(name)
    run = RunConfig(remat_policy="none", param_dtype="float32", learning_rate=TRAIN_LR,
                    warmup_steps=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    data = SyntheticLM(cfg).numpy_batches(ShapeConfig("train_reduced", 32, 2, "train"))
    np_batch = next(data)
    devices = ("cpu", "cuda")
    batch = {dev: as_tensors(np_batch, dev) for dev in devices}
    state = {dev: fresh_state(cfg, params, dev) for dev in devices}
    step = TS.make_train_step(cfg, run)
    kernel_counts(reset=True)
    lg = {dev: TS.loss_and_grads(cfg, run, state[dev]["params"], batch[dev]) for dev in devices}
    m = {dev: step(state[dev], batch[dev])[1] for dev in devices}
    counts = kernel_counts()
    g_err = grads_err(lg["cuda"][1], lg["cpu"][1])
    p_err = params_err(params, state["cuda"]["params"], state["cpu"]["params"], lg["cpu"][1],
                       run.weight_decay)
    rel = {k: rel_err(m["cuda"][k], m["cpu"][k]) for k in ("loss", "grad_norm", "lr")}
    rel["loss_and_grads"] = rel_err(lg["cuda"][0], lg["cpu"][0])
    # save -> restore -> the next step, against the unbroken run's next step
    card = state["cuda"]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    CK.save(card, ckpt_dir, 2, fingerprint=cfg.fingerprint())
    restored, at = CK.restore(TS.train_state_struct(cfg, run), ckpt_dir, device="cuda",
                              fingerprint=cfg.fingerprint())
    bit_equal = all(torch.equal(a, b) for a, b in zip(flatten_with_paths(restored).values(),
                                                      flatten_with_paths(card).values()))
    batch2 = as_tensors(next(data), "cuda")
    resumed_equal = step(restored, batch2)[1]["loss"].item() == \
        step(card, batch2)[1]["loss"].item()
    # a bf16 step on the card from the CPU's bf16 parameters
    run16 = RunConfig(remat_policy="dots", loss_chunk=8, learning_rate=TRAIN_LR, warmup_steps=1)
    params16 = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    loss16_cpu = TS.loss_and_grads(cfg, run16, params16, batch["cpu"])[0]
    m16 = TS.make_train_step(cfg, run16)(fresh_state(cfg, params16, "cuda"), batch["cuda"])[1]
    counts16 = kernel_counts()
    r = {"optimizer": cfg.optimizer, "loss_cpu": m["cpu"]["loss"].item(),
         "loss_card": m["cuda"]["loss"].item(), "rel": rel, "grad_err_share": g_err[0],
         "grad_worst_leaf": g_err[1], "param_err_share": p_err[0], "param_worst_leaf": p_err[1],
         "launches": counts, "restored_bit_equal": bit_equal, "restored_step": at,
         "resumed_loss_equal": resumed_equal, "bf16_loss": m16["loss"].item(),
         "bf16_loss_rel_to_cpu": rel_err(m16["loss"], loss16_cpu),
         "bf16_grad_norm": m16["grad_norm"].item(), "launches_with_bf16": counts16}
    log(f"[8a] reduced {name} f32 ({cfg.optimizer}), CUDA against CPU: loss {r['loss_card']:.7f} "
        f"/ {r['loss_cpu']:.7f}, rel {json.dumps(rel)}; gradients {g_err[0]:.3g} of their "
        f"tolerance (worst {g_err[1]}), parameters after the step {p_err[0]:.3g} of theirs "
        f"(worst {p_err[1]}); kernel launches {counts}; restore bit-equal {bit_equal}, the "
        f"resumed step's loss equal to the unbroken run's {resumed_equal}; bf16 step loss "
        f"{r['bf16_loss']:.5f} (rel {r['bf16_loss_rel_to_cpu']:.2g} to the CPU's), grad norm "
        f"{r['bf16_grad_norm']:.4g}, launches {counts16}")
    none = {k: 0 for k in counts}
    bad = [what for what, ok in (
        ("loss, grad norm or lr", max(rel.values()) <= METRIC_RTOL),
        ("gradients", g_err[0] <= 1.0), ("parameters after the step", p_err[0] <= 1.0),
        ("kernel launches", counts == counts16 == none),
        ("save -> restore -> step", bit_equal and at == 2 and resumed_equal),
        ("bf16 step", r["bf16_loss_rel_to_cpu"] <= BF16_RTOL
         and math.isfinite(r["bf16_grad_norm"]))) if not ok]
    if name == "gemma2-2b":
        # grad_accum 2 against 1, remat "dots" and "full" against "none", on the card
        on_card = copy_tree(params, "cuda")
        for policy in ("dots", "full"):
            loss, grads = TS.loss_and_grads(cfg, dataclasses.replace(run, remat_policy=policy),
                                            on_card, batch["cuda"])
            err = grads_err(grads, lg["cuda"][1])
            r[f"remat_{policy}"] = {"loss_rel": rel_err(loss, lg["cuda"][0]),
                                    "grad_err_share": err[0]}
            log(f"  remat {policy} against none on the card: {json.dumps(r[f'remat_{policy}'])}")
            if r[f"remat_{policy}"]["loss_rel"] > 1e-6 or err[0] > 1.0:
                bad.append(f"remat {policy}")
        accum = {n: fresh_state(cfg, params, "cuda") for n in (1, 2)}
        ma = {n: TS.make_train_step(cfg, dataclasses.replace(run, grad_accum=n))(
            s, batch["cuda"])[1] for n, s in accum.items()}
        a_err = params_err(params, accum[2]["params"], accum[1]["params"], lg["cuda"][1],
                           run.weight_decay)
        r["grad_accum_2"] = {"loss_rel": rel_err(ma[2]["loss"], ma[1]["loss"]),
                             "grad_norm_rel": rel_err(ma[2]["grad_norm"], ma[1]["grad_norm"]),
                             "param_err_share": a_err[0]}
        log(f"  grad_accum 2 against 1 on the card: {json.dumps(r['grad_accum_2'])} "
            f"(worst {a_err[1]})")
        if max(r["grad_accum_2"]["loss_rel"], r["grad_accum_2"]["grad_norm_rel"]) > METRIC_RTOL \
                or a_err[0] > 1.0:
            bad.append("grad_accum 2")
    return r, bad


def check_train_reduced():
    """Phase 8a: each arch's reduced config at f32, the loss and gradients
    and one ``make_train_step`` step (AdamW, arctic's Adafactor) on the card
    against the CPU from the same parameters (the port's ``init_params``,
    seeded) on the same ``SyntheticLM`` batch; no kernel launch on the card;
    save -> restore -> step on the card gives the unbroken run's loss; a
    bf16 step on the card (remat "dots", a chunked loss) near the CPU's;
    for gemma2 also ``grad_accum`` 2 against 1 and remat "dots" and "full"
    against "none"."""
    import shutil
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    out = {}
    for name in TRAIN_ARCHS:
        out[name], bad = train_reduced_arch(name, ckpt_dir)
        if bad:
            fail(f"phase 8a: reduced {name}: {', '.join(bad)} disagree")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def attention_layer_ms(cfg, batch, seq, chunk):
    """``attention_chunked`` at one layer of a training step (bf16 q, k, v of
    ``batch`` x ``seq``, ``chunk`` keys a chunk), by CUDA events: the
    forward, and forward + backward, for each of the config's mask kinds."""
    import torch
    from repro_torch.models.attention import attention_chunked
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(heads):
        return torch.randn(batch, seq, heads, cfg.head_dim, generator=gen,
                           device="cuda").to(torch.bfloat16).requires_grad_(True)

    q, k, v = rnd(cfg.num_heads), rnd(cfg.num_kv_heads), rnd(cfg.num_kv_heads)
    go = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for kind, mask in (("local", "local"), ("global", "causal")):
        def fwd():
            return attention_chunked(cfg, q, k, v, mask_kind=mask, chunk=chunk)
        out[kind] = {"fwd_ms": cuda_ms(fwd, 3),
                     "fwd_bwd_ms": cuda_ms(lambda: fwd().backward(go), 3)}
    return out


def full_width_train_config():
    """Phase 8b's (and 9a's) gemma2-2b and RunConfig."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    return get_config("gemma2-2b"), RunConfig(remat_policy="full", loss_chunk=TRAIN_CHUNK,
                                              attn_chunk=TRAIN_CHUNK, warmup_steps=2)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else sum(xs[len(xs) // 2 - 1:len(xs) // 2 + 1]) / 2


def train_full_width(card):
    """Phase 8b: gemma2-2b at full width in bf16, TRAIN_BATCH x TRAIN_SEQ
    tokens a step, AdamW, remat "full", loss and attention chunks of
    TRAIN_CHUNK, warmup 2, TRAIN_STEPS steps of ``SyntheticLM``: finite
    losses and grad norms, parameters that move, the mean of the last three
    losses below the first, no kernel launch; step ms (median of steps
    2..), tokens/s, the share of the card's dense bf16 peak that 6 N tokens
    a step gives, one step's device idle share and kernels under the
    profiler, the forward + backward alone, one layer's chunked attention,
    and the peak memory beside the reckoned one."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import SyntheticLM
    cfg, run = full_width_train_config()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    v_d = cfg.vocab_size * cfg.d_model
    # bf16 params and gradients, AdamW's f32 m and v, clip's f32 gradients,
    # the bf16 updates, and three f32 temporaries of the largest leaf (the
    # embedding) inside the optimizer
    reckoned = (2 * n + 2 * n + 8 * n + 4 * n + 3 * 4 * v_d) / 1e9
    log(f"[8b] gemma2-2b bf16 training at full width ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n / 1e9:.3f} B params): {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step (TRAIN_4K's sequence; its batch of 256 cut to "
        f"{TRAIN_BATCH}), AdamW, remat {run.remat_policy}, loss_chunk {run.loss_chunk}, "
        f"attn_chunk {run.attn_chunk}, {TRAIN_STEPS} steps; peak reckoned {reckoned:.1f} GB")
    t0 = time.perf_counter()
    data = SyntheticLM(cfg).batches(ShapeConfig("train_4k_batch_2", TRAIN_SEQ, TRAIN_BATCH,
                                                "train"), "cuda")
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TS.init_train_state(cfg, run, torch.Generator(device="cuda").manual_seed(0), "cuda")
    sync()
    init_s = time.perf_counter() - t0
    watched = {"layers/0/attn/wq": state["params"]["layers"][0]["attn"]["wq"],
               "embed/table": state["params"]["embed"]["table"],
               "final_norm/scale": state["params"]["final_norm"]["scale"]}
    before = {k: t.clone() for k, t in watched.items()}
    step = TS.make_train_step(cfg, run)
    kernel_counts(reset=True)
    losses, norms, lrs, step_ms = [], [], [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        _, m = step(state, b)
        losses.append(m["loss"].item())              # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(m["grad_norm"].item())
        lrs.append(m["lr"].item())
    counts = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = {k: not torch.equal(before[k], t) for k, t in watched.items()}
    med = median(step_ms[1:])
    result = {
        "layers": cfg.num_layers, "params_b": n / 1e9, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms, "lrs": lrs,
        "step_ms": step_ms, "step_ms_median_2_on": med, "tokens_per_s": tokens * 1e3 / med,
        "flop_share_6nt": 6 * n * tokens / (med / 1e3) / PEAK_BF16_OPS,
        "peak_mem_gb": peak_gb, "reckoned_peak_gb": reckoned, "launches": counts,
        "params_moved": moved, "data_s": data_s, "init_s": init_s, "card": card}
    log(f"  losses {[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in norms]}, "
        f"lr {lrs}; step ms {[round(x, 1) for x in step_ms]}; launches {counts}")
    log(f"  step {med:.1f} ms (median of steps 2-{TRAIN_STEPS}), {result['tokens_per_s']:.0f} "
        f"tokens/s, 6 N tokens a step = {result['flop_share_6nt']:.4f} of {PEAK_BF16_OPS / 1e12:.0f} "
        f"TFLOP/s; peak memory {peak_gb:.2f} GB against {reckoned:.2f} GB reckoned; on {card}")
    finite = all(math.isfinite(x) for x in losses + norms)
    falling = sum(losses[-3:]) / 3 < losses[0]
    if not (finite and all(moved.values()) and falling
            and counts == {k: 0 for k in counts}):
        fail(f"phase 8b: finite {finite}, parameters moved {moved}, the last three losses' "
             f"mean below the first {falling}, launches {counts}")
    # where a step's time goes: one step under the profiler (device idle
    # share against the untraced median), the forward + backward alone (the
    # rest of a step is clip, the optimizer and the update), and one layer's
    # chunked attention, forward twice (remat) and backward once
    prof = device_profile(lambda: step(state, batches[-1])[1]["loss"].item(), top=400)
    busy = prof["device_busy_ms"]
    gemm = sum(ms for name, ms, _ in prof["top"] if any(w in name for w in GEMM_NAMES))
    sync()
    t0 = time.perf_counter()
    loss, grads = TS.loss_and_grads(cfg, run, state["params"], batches[0])
    loss.item()
    fwd_bwd = (time.perf_counter() - t0) * 1e3
    del grads
    torch.cuda.empty_cache()
    attn = attention_layer_ms(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CHUNK)
    kinds = cfg.layer_kinds()
    attn_step = sum(kinds.count(kind) * (a["fwd_ms"] + a["fwd_bwd_ms"])
                    for kind, a in attn.items())
    result["breakdown"] = {
        "device_busy_ms": busy, "idle_share": None if busy is None else 1 - busy / med,
        "profiled_wall_ms": prof["wall_ms"], "gemm_kernels_ms": gemm,
        "other_kernels_ms": None if busy is None else busy - gemm,
        "fwd_bwd_ms": fwd_bwd, "clip_optimizer_update_ms": med - fwd_bwd,
        "attention_layer": attn, "attention_step_ms": attn_step, "top": prof["top"][:15]}
    log(f"  one step under the profiler: device busy {busy} ms (idle share "
        f"{result['breakdown']['idle_share']}), GEMM kernels {gemm:.1f} ms; forward + backward "
        f"alone {fwd_bwd:.1f} ms, so clip + optimizer + update ~{med - fwd_bwd:.1f} ms; chunked "
        f"attention a layer {json.dumps(attn)}, a step (forward twice, backward once) "
        f"~{attn_step:.1f} ms; top kernels:")
    for name, ms, calls in prof["top"][:15]:
        log(f"    {ms:9.3f} ms {calls:5d}x  {name}")
    del state, batches
    torch.cuda.empty_cache()
    return result


def train_phase(card):
    """Phase 8: 8a and 8b; returns (their numbers, the kernels' launches
    over both: none)."""
    kernel_counts(reset=True)
    reduced = check_train_reduced()
    launches = kernel_counts()
    full = train_full_width(card)
    launches = {k: launches[k] + full["launches"][k] for k in launches}
    return {"reduced": reduced, "full_width": full}, launches


# ------------------------------------------------------------------ phase 9
# Sharding. 9a: phase 8b's workload through the DTensor path: a one-rank
# NCCL group (a FileStore under build/), a (1, 1, 1) ("pod", "data",
# "model") mesh, the state placed by ``tree_shardings`` of
# ``state_logical_specs`` and the batches by ``batch_logical_specs``. On
# one rank the local shards are the whole tensors, so a step computes what
# 8b's does; the gap between the two is DTensor's host cost (dispatch, and
# on the first step the sharding propagation of every op).
SHARD_NAMES = ("pod", "data", "model")


def scalar(t) -> float:
    """A 0-d tensor or DTensor as a float (waits for it)."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def sharded_full_width(card, plain):
    """Phase 9a: 8b's gemma2-2b, run and batches on a (1, 1, 1) mesh of a
    one-rank NCCL group; each step's loss within 8a's bf16 tolerance of
    8b's (``plain``), no kernel launch; step ms (median of steps 2..),
    tokens/s, one step's idle share and the peak memory beside 8b's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.parallel.sharding import distribute_tree, make_env, tree_shardings
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import SyntheticLM
    cfg, run = full_width_train_config()
    # DTensor warns of each sequential all-reduce over a (1, 1, 1) mesh's dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    store = ROOT / "build" / "chip_smoke_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        env = make_env(make_device_mesh((1, 1, 1), SHARD_NAMES))
        log(f"[9a] gemma2-2b bf16 training through DTensor on {env.mesh}: 8b's workload")
        data = SyntheticLM(cfg).batches(ShapeConfig("train_4k_batch_2", TRAIN_SEQ, TRAIN_BATCH,
                                                    "train"), "cuda")
        batch_sh = None
        batches = []
        for _ in range(TRAIN_STEPS):
            b = next(data)
            batch_sh = batch_sh or tree_shardings(env, TS.batch_logical_specs(cfg, "train"), b)
            batches.append(distribute_tree(b, batch_sh))
        torch.cuda.reset_peak_memory_stats()
        state = TS.init_train_state(cfg, run, torch.Generator(device="cuda").manual_seed(0),
                                    "cuda")
        state = distribute_tree(state, tree_shardings(env, TS.state_logical_specs(cfg, run), state))
        step = TS.make_train_step(cfg, run, env)
        kernel_counts(reset=True)
        losses, step_ms = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            _, m = step(state, b)
            losses.append(scalar(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        med = median(step_ms[1:])
        prof = device_profile(lambda: scalar(step(state, batches[-1])[1]["loss"]), top=5)
        busy = prof["device_busy_ms"]
        rel = [rel_err(a, b) for a, b in zip(losses, plain["losses"])]
        plain_idle = plain["breakdown"]["idle_share"]
        result = {
            "mesh": [1, 1, 1], "losses": losses, "loss_rel_to_8b": rel, "step_ms": step_ms,
            "step_ms_median_2_on": med, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / med,
            "idle_share": None if busy is None else 1 - busy / med, "device_busy_ms": busy,
            "peak_mem_gb": peak_gb, "launches": counts, "card": card,
            "plain_8b": {"step_ms_median_2_on": plain["step_ms_median_2_on"],
                         "tokens_per_s": plain["tokens_per_s"], "idle_share": plain_idle,
                         "peak_mem_gb": plain["peak_mem_gb"]},
            "host_cost_ms": med - plain["step_ms_median_2_on"]}
        log(f"  losses {[round(x, 4) for x in losses]} (8b: "
            f"{[round(x, 4) for x in plain['losses']]}; rel at most {max(rel):.3g}); step ms "
            f"{[round(x, 1) for x in step_ms]}; launches {counts}")
        log(f"  step {med:.1f} ms (8b {plain['step_ms_median_2_on']:.1f}), "
            f"{result['tokens_per_s']:.0f} tokens/s (8b {plain['tokens_per_s']:.0f}), idle share "
            f"{result['idle_share']} (8b {plain_idle}), peak {peak_gb:.2f} GB (8b "
            f"{plain['peak_mem_gb']:.2f}); the first step {step_ms[0]:.0f} ms; on {card}")
        if not (max(rel) <= BF16_RTOL and counts == {k: 0 for k in counts}):
            fail(f"phase 9a: losses {rel} of 8b's (tolerance {BF16_RTOL}), launches {counts}")
        del state, batches
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    return result


# ----------------------------------------------------------------- phase 10
# Serving on a mesh and the dry run. 10a: K2's log-sum-exp against the plain
# version's; 10b: K2 over slices of one cache merged by ``merge_stacked``
# (the arithmetic the ranks run, ``attention.merge_shards``) against K2 on
# the whole cache; 10c: phase 4 through the DTensor path on a (1, 1, 1)
# mesh; 10d: the dry run's gemma2-2b and zoo cells on the meta device.
MERGE_WAYS = (2, 16)


def lse_shapes():
    """(label, B, S, Hq, Hkv, D, softcap, dtypes) of 10a and 10b: gemma2's
    global cache at its last step (the ring kernel in bf16, the split kernel
    with f32 queries), granite's (the split kernel, G 3, D 64) and
    recurrentgemma's wrapped ring (the ring kernel at G 16, bf16 only)."""
    import torch
    from repro_torch.configs import get_config
    out = []
    for name, s in (("gemma2-2b", SEQ + STEPS), (GRANITE, SEQ + STEPS),
                    (RECURRENTGEMMA, 2048)):
        cfg = get_config(name)
        dtypes = ((torch.bfloat16,) if cfg.num_heads // cfg.num_kv_heads == 16
                  else (torch.float32, torch.bfloat16))
        out.append((name, BATCH, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    cfg.attn_logit_softcap, dtypes))
    return out


def check_lse():
    """10a: K2 with ``return_lse`` at ``lse_shapes`` and at S shorter than a
    tile, ragged lengths with a row of length 0: the lse within
    LSE_RTOL |lse| + LSE_ATOL of the plain version's, the f32 output within
    TOL["float32"] of the plain version's unrounded one, and that output
    rounded to q's dtype bit-equal to the call without the lse."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    gen = torch.Generator(device="cuda").manual_seed(10)
    bad = []
    log("[10a] K2's log-sum-exp against the plain version's")
    for name, b, s_main, hq, hkv, d, cap, dtypes in lse_shapes():
        for s in (s_main, 20):
            lens = torch.tensor([s, s // 3 + 1, 0, 1], dtype=torch.int32, device="cuda")
            for dtype in dtypes:
                q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(dtype)
                ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
                          .to(torch.bfloat16) for _ in range(2))
                args = dict(scale=d ** -0.5, softcap=cap)
                out, lse = DK.decode_attention_cuda(q, ck, cv, lens, return_lse=True, **args)
                plain_out, plain_lse = DO.decode_attention_plain(q, ck, cv, lens,
                                                                 return_lse=True, **args)
                lse_ratio = ((lse - plain_lse).abs()
                             / (LSE_RTOL * plain_lse.abs() + LSE_ATOL)).max().item()
                out_err = (out - plain_out).abs().max().item()
                same = torch.equal(out.to(dtype),
                                   DK.decode_attention_cuda(q, ck, cv, lens, **args))
                log(f"  {name} {(b, s, hq, hkv, d)} q {dtype}: lse |err|/limit {lse_ratio:.3g}, "
                    f"f32 out max|err| {out_err:.3g}, rounded out bit-equal {same}")
                if not (lse_ratio <= 1.0 and out_err <= TOL["float32"]["decode_attn"][0]
                        and same and lse.dtype == out.dtype == torch.float32):
                    bad.append(f"{name} {s} {dtype}")
    if bad:
        fail(f"phase 10a: K2's lse disagrees: {bad}")


def check_merge(card):
    """10b: each cache of ``lse_shapes`` (bf16) cut into m in MERGE_WAYS
    slices along S; K2 with the lse on each slice at its local lengths
    clamp(len - offset, 0, S/m), ``merge_stacked``, rounded to bf16, against
    K2 on the whole cache within TOL["bfloat16"], at ragged lengths that
    leave slices empty. Times, at gemma2's shape, one slice's K2 (a rank's
    launch) and the merge's arithmetic beside the whole cache's K2 (events
    around back-to-back calls), and the slice's plain version with the lse
    and flex_attention with ``return_lse`` (the library's call) beside it."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn.ops import decode_attention_plain
    from repro_torch.models.attention import merge_stacked
    gen = torch.Generator(device="cuda").manual_seed(11)
    atol, rtol, _ = TOL["bfloat16"]["decode_attn"]
    bad, timing = [], {}
    log("[10b] K2 over slices of one cache, merged, against K2 on the whole cache")
    for name, b, s, hq, hkv, d, cap, _ in lse_shapes():
        q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor([s, s // 3 + 1, 5, s // 16 + 1], dtype=torch.int32, device="cuda")
        args = dict(scale=d ** -0.5, softcap=cap)
        whole = DK.decode_attention_cuda(q, ck, cv, lens, **args)
        for m in MERGE_WAYS:
            if s % m:
                fail(f"phase 10b: {name}'s {s} slots do not split into {m}")
            n = s // m
            parts = [(ck[:, i * n:(i + 1) * n].contiguous(), cv[:, i * n:(i + 1) * n].contiguous(),
                      torch.clamp(lens - i * n, 0, n).to(torch.int32)) for i in range(m)]
            outs, lses = zip(*(DK.decode_attention_cuda(q, k, v, mine, return_lse=True, **args)
                               for k, v, mine in parts))
            has = torch.stack([(mine > 0) | (lens <= 0) for _, _, mine in parts])
            merged = merge_stacked(torch.stack(outs), torch.stack(lses), has).to(torch.bfloat16)
            ratio = ((merged.float() - whole.float()).abs()
                     / (atol + rtol * whole.float().abs())).max().item()
            empty = int((~has).sum())
            log(f"  {name} {(b, s, hq, hkv, d)} in {m} slices ({empty} empty (row, slice) "
                f"pairs): max |err|/limit {ratio:.3g}")
            if not ratio <= 1.0:
                bad.append(f"{name} m {m}")
            if name == "gemma2-2b":
                k0, v0, mine0 = parts[0]
                stacked = (torch.stack(outs), torch.stack(lses), has)
                timing[m] = {
                    "slice_ms": cuda_ms(lambda: DK.decode_attention_cuda(
                        q, k0, v0, mine0, return_lse=True, **args), 50),
                    "merge_ms": cuda_ms(lambda: merge_stacked(*stacked), 50),
                    "whole_ms": cuda_ms(lambda: DK.decode_attention_cuda(q, ck, cv, lens, **args),
                                        50),
                    "slice_plain_ms": cuda_ms(lambda: decode_attention_plain(
                        q, k0, v0, mine0, return_lse=True, **args), 20)}
                try:
                    call, _ = library_flash(q, k0, v0, 0, lengths=mine0, scale=d ** -0.5,
                                            cap=cap, causal=False, lse=True)
                    call()
                    timing[m]["slice_library_ms"] = cuda_ms(call, 50)
                except Exception as e:  # noqa: BLE001 - the yardstick only
                    log(f"  flex_attention with the lse unavailable ({type(e).__name__}: {e})")
                    timing[m]["slice_library_ms"] = None
            del parts, outs, lses
    log(f"  gemma2's last step, ms (events, back-to-back calls; on {card}): {json.dumps(timing)}")
    if bad:
        fail(f"phase 10b: the merged slices disagree with the whole cache: {bad}")
    return timing


def sharded_serve(card, phase4):
    """10c: phase 4's weights and prompts (the same seeded draws) through
    ``generate`` on a (1, 1, 1) mesh of a one-rank NCCL group, the decode
    rules (the prefill under ``phase_env``): greedy tokens equal to phase
    4's, logits within phase 3's bf16 tolerance of them, K3 26 and K2 832
    launches; prefill ms, decode ms a step and the idle share beside phase
    4's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (distribute_tree, make_env, phase_env,
                                               tree_shardings)
    from repro_torch.serving.generate import generate, greedy
    cfg = get_config("gemma2-2b")
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    store = ROOT / "build" / "chip_smoke_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        env = make_env(make_device_mesh((1, 1, 1), SHARD_NAMES), "decode")
        log(f"[10c] gemma2-2b bf16 served through DTensor on {env.mesh}: phase 4's workload")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(cfg, gen, "cuda", torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
        params = distribute_tree(params, tree_shardings(env, M.param_specs(cfg), params))
        t0 = time.perf_counter()
        generate(cfg, params, prompts[:, :256], 2, env=env)    # propagation, cuBLAS
        sync()
        warm_s = time.perf_counter() - t0
        flash_attention_cuda.launches = decode_attention_cuda.launches = 0
        tokens, logits = generate(cfg, params, prompts, STEPS, env=env)
        sync()
        launches = {"flash_attn": flash_attention_cuda.launches,
                    "decode_attn": decode_attention_cuda.launches}
        tokens, logits = tokens.full_tensor().cpu(), logits.full_tensor().cpu()
        same = torch.equal(tokens, phase4["tokens"])
        err = max_err(logits, phase4["logits"])
        per_prefill, per_step = attention_calls(cfg)
        want = {"flash_attn": per_prefill, "decode_attn": per_step * STEPS}
        log(f"  tokens equal phase 4's: {same}; max|logit err| {err:.3g} (tol 3e-2); "
            f"launches {launches} (want {want}); warm-up {warm_s:.1f} s")
        if not (same and err <= 3e-2 and launches == want):
            fail(f"phase 10c: tokens equal {same}, logit err {err}, launches {launches}")

        batch = {"tokens": distribute_tree(prompts, tree_shardings(
            env, ("act_batch", None), prompts))}
        penv = phase_env(env, "prefill")

        def run_prefill():
            return M.prefill(cfg, params, batch, max_len=SEQ + STEPS, env=penv, cache_env=env)

        sync()
        t0 = time.perf_counter()
        logits0, cache, pos = run_prefill()
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = greedy(logits0)
        sync()
        t0 = time.perf_counter()
        for i in range(STEPS):
            step_logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache, env=env)
        sync()
        decode_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        prof = device_profile(lambda: M.decode_step(cfg, params, tok, pos + STEPS, cache,
                                                    env=env), top=5)
        idle = 1 - prof["device_busy_ms"] / decode_ms if prof["device_busy_ms"] else None
        p4 = phase4["result"]
        p4_idle = p4.get("decode_step_profile", {}).get("idle_share")
        result = {"mesh": [1, 1, 1], "tokens_equal": same, "max_logit_err": err,
                  "launches": launches, "warm_up_s": warm_s, "prefill_ms": prefill_ms,
                  "decode_ms_per_step": decode_ms, "decode_idle_share": idle, "card": card,
                  "phase4": {"prefill_ms": p4["prefill_ms"],
                             "decode_ms_per_step": p4["decode_ms_per_step"],
                             "decode_idle_share": p4_idle}}
        log(f"  prefill {prefill_ms:.1f} ms (phase 4 {p4['prefill_ms']:.1f}), decode "
            f"{decode_ms:.2f} ms a step (phase 4 {p4['decode_ms_per_step']:.2f}), idle share "
            f"{idle} (phase 4 {p4_idle}); the difference is DTensor's host cost; on {card}")
        del params, cache
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    return result


# 10d: gemma2-2b's six dry-run cells and the zoo's twelve (granite-moe,
# mamba2, recurrentgemma and seamless on (16, 16)), each held to the port's
# record on the torch that wrote reference_cells.json within DRY_TOL on
# every figure
DRY_CELLS = ([("gemma2-2b", shape, mesh) for shape in ("train_4k", "prefill_32k", "decode_32k")
              for mesh in ("single", "multi")]
             + [(arch, shape, "single") for arch in ("granite-moe-3b-a800m", "mamba2-2.7b",
                                                     "recurrentgemma-9b", "seamless-m4t-medium")
                for shape in ("train_4k", "prefill_32k", "decode_32k")])
DRY_TOL = 0.01


def dry_figures(rec):
    """Every figure of a dry-run record (``run_cell``'s, or a cell's side in
    reference_cells.json), flat: FLOPs, bytes, the effective collective
    bytes by kind and in all, the collectives' count and the memory
    analysis."""
    coll = rec.get("collectives", rec)
    out = {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
           "collective_total_effective": coll["collective_total_effective"],
           "collective_num_ops": coll["collective_num_ops"]}
    out.update({f"collective {k}": v for k, v in coll["collective_bytes_effective"].items()})
    out.update({f"memory {k}": v for k, v in rec["memory_analysis"].items()})
    return out


def dry_run_cells():
    """10d: gemma2-2b's train_4k, prefill_32k and decode_32k cells on the
    (16, 16) and (2, 16, 16) meshes, and the zoo's on (16, 16)
    (``launch/dryrun.run_cell``: a fake
    group of 256/512 ranks, the meta device; the card is not touched) on
    this machine's torch. Each figure must be within DRY_TOL of the port's
    record in ``reference_cells.json`` (its ``made_with`` torch); the port's
    share of the reference's figures (XLA's compiled program, from the
    same file) is printed beside it."""
    import torch
    from repro_torch.launch import dryrun
    book = json.loads(dryrun.REFERENCE_CELLS.read_text())
    log(f"[10d] dry run on torch {torch.__version__} against the records of torch "
        f"{book['made_with']['torch']} (arithmetic on shapes, no device)")
    out, misses, start = {}, [], time.perf_counter()
    for arch, shape, mesh in DRY_CELLS:
        key = f"{arch}__{shape}__{mesh}"
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, save=False, verbose=False)
        mine, theirs = dry_figures(rec), dry_figures(book["cells"][key]["port"])
        worst = 0.0
        for name in sorted(set(mine) | set(theirs)):
            a, b = mine.get(name, 0.0), theirs.get(name, 0.0)
            err = abs(a - b) / max(abs(b), 1e-30) if a != b else 0.0
            worst = max(worst, err)
            if err > DRY_TOL:
                misses.append(f"{key} {name}: {a} here, {b} in the file")
        ratios = rec["reference"]["port_over_reference"]
        out[key] = {"seconds": time.perf_counter() - t0, "worst_rel_diff": worst,
                    "figures": mine, "port_over_reference": ratios}
        log(f"  {key}: {time.perf_counter() - t0:.1f} s, every figure within {worst:.2e} of "
            f"the file's; flops {mine['flops']:.4e}, collectives "
            f"{mine['collective_total_effective']:.4e} B, peak {mine['memory peak_bytes']:.4e} B")
        log("    port / reference: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ratios.items())
                                                 if v is not None))
    log(f"[10d] {len(DRY_CELLS)} cells in {time.perf_counter() - start:.1f} s")
    if misses:
        fail(f"{len(misses)} dry-run figures differ from reference_cells.json by more than "
             f"{DRY_TOL:.0%}: {misses}")
    return out


DRY_OUT = ROOT / "build" / "dry_run"


def start_dry_run():
    """10d in a process of its own (``--dry-run-cells``), started before
    phase 8: it needs no card, and beside phases 8-10c it takes none of the
    script's time limit but what is left of it at 10d. Its output goes to
    files under build/dry_run (DTensor's warnings would fill a pipe)."""
    DRY_OUT.mkdir(parents=True, exist_ok=True)
    with open(DRY_OUT / "out.log", "w") as out, open(DRY_OUT / "err.log", "w") as err:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dry-run-cells"],
                                stdout=out, stderr=err)


def finish_dry_run(proc):
    """10d's output, relayed, and its records (``dry_run_cells``'s)."""
    t0 = time.perf_counter()
    code = proc.wait(timeout=900)
    lines = (DRY_OUT / "out.log").read_text().strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if code != 0:
        err = (DRY_OUT / "err.log").read_text().strip().splitlines()
        fail(f"10d: {err[-1] if err else f'exit {code}'}")
    log(f"[10d] waited {time.perf_counter() - t0:.1f} s for its process")
    return json.loads(lines[-1])


def sharded_phase(card, phase4, dry):
    """Phase 10, in order; ``dry`` is 10d's process (``start_dry_run``)."""
    import torch
    check_lse()
    merge = check_merge(card)
    torch.cuda.empty_cache()
    serve_mesh = sharded_serve(card, phase4)
    return {"merge_ms": merge, "serve": serve_mesh, "dry_run": finish_dry_run(dry)}


# ----------------------------------------------------------------- phase 11
# The runner, the run ledger and the runs CLI, and the four examples.
# 11a: benchmarks/run.py's fig8 grid through run_grid on the torch rung
# against the C rung, and a 2-SM grid whose chunks the torch rung sends to
# C; 11b: the --quick grid (benchmarks/run.py) under a ledger: truncated by
# a deadline, resumed, inspected with ``python -m repro_torch.runs`` and
# drained by two ``runs work`` processes; 11c: the examples on the card.
QUICK_APPS, QUICK_POLICIES, QUICK_SCALE = ("syrk", "kmn"), ("gto", "ciao-p", "ciao-c"), 0.2
MS_APPS, MS_POLICIES, MS_SCALE = ("kmn", "syrk"), ("gto", "ciao-p", "ciao-c"), 0.25
# 11a's fig8 grid runs at a fifth of GRID_SCALE: phase 7 already holds and
# times fig8's 84 cells at GRID_SCALE on the stepper, and at 0.5 the grid
# took 129.5 s more through run_grid (a script of 1,065 s against its
# 1,200 s limit on an H100)
RUNNER_SCALE = 0.1
# The 11b run with a deadline: its first chunk's dispatch is held back by
# QUICK_DELAY_S (the repo's fault plan), so the deadline passes while that
# chunk runs and the chunk after it is truncated, at any card speed.
QUICK_DEADLINE_S, QUICK_DELAY_S = 2.0, 4.0
# examples/torch_serve_ciao.py's policy table on the CPU (the reference's
# table, held equal in tests/test_torch_examples.py): (steps, decoded
# tokens, work units, preemptions, refetched pages, completed) a policy
SERVE_TABLE = {"gto": (5911, 92064, 128022.0, 106, 178, 256),
               "ccws": (9101, 92064, 127008.0, 93, 198, 256),
               "statpcal": (5583, 92064, 122448.0, 67, 177, 256),
               "ciao-p": (5776, 92064, 122347.0, 74, 173, 256),
               "ciao-t": (8840, 92064, 124102.0, 83, 199, 256),
               "ciao-c": (5783, 92064, 121517.0, 73, 173, 256)}


def env_vars(**kv):
    """Environment variables set for a block, the old values back after it."""
    from unittest import mock
    return mock.patch.dict(os.environ, {k: str(v) for k, v in kv.items()})


def timed_grid(grid, **kw):
    """(records, seconds, last_batched_perf()) of one ``run_grid``."""
    from repro_torch.core.runner import last_batched_perf, run_grid
    t0 = time.perf_counter()
    recs = run_grid(grid, **kw)
    return recs, time.perf_counter() - t0, last_batched_perf()


def runner_full_size(device="cuda"):
    """11a: the fig8 grid (12 apps x 7 policies at RUNNER_SCALE, seed 0, the
    limit sweeps flattened) through ``run_grid(engine="torch",
    strict=True)`` on the card, field for field against the C rung's run
    on the host; its JSON round trip; a 2-SM grid whose chunks go to C
    (``host_chunks``) with records equal to the batched run's."""
    import dataclasses
    from repro_torch.core.gpu import GPUConfig
    from repro_torch.core.runner import ExperimentGrid, load_records, save_records
    out = {}
    grid = ExperimentGrid(name="fig8", workloads=FIG8_APPS, policies=POLICIES,
                          scale=RUNNER_SCALE, seed=0)
    log(f"[11a] run_grid: fig8 ({len(FIG8_APPS)} apps x {len(POLICIES)} policies, scale "
        f"{RUNNER_SCALE}) on the torch rung ({device}) and on the C rung")
    recs, secs, perf = timed_grid(grid, engine="torch", strict=True, device=device)
    with env_vars(REPRO_BATCHED_BACKEND="c"):
        c_recs, c_secs, c_perf = timed_grid(grid, engine="batched", strict=True)
    if c_perf["stepper_s"] <= 0 or perf["iterations"] <= 0:
        fail("11a: the fig8 runs did not run their steppers")
    if perf["host_chunks"]:
        fail(f"11a: fig8 sent {perf['host_chunks']} single-SM chunks to the host")
    got = [dataclasses.asdict(r) for r in recs]
    want = [dataclasses.asdict(r) for r in c_recs]
    if got != want:
        fail(f"11a: {sum(a != b for a, b in zip(got, want))} of {len(recs)} fig8 records on the "
             f"torch rung differ from the C rung's")
    path = ROOT / "build" / "phase11" / "fig8.json"
    save_records(recs, str(path), grid=grid)
    if load_records(str(path)) != recs:
        fail("11a: save_records -> load_records does not give the fig8 records back")
    out["fig8"] = {"cells": len(recs), "torch_s": secs, "c_s": c_secs,
                   "iterations": perf["iterations"], "capture_s": perf["capture_s"],
                   "perf": perf, "c_perf": c_perf}
    log(f"  fig8: {len(recs)} records equal to the C rung's, JSON round trip equal; torch "
        f"{secs:.2f} s ({perf['iterations']:.0f} iterations, {perf['capture_s']:.2f} s capture, "
        f"{perf['chunks']:.0f} chunks), C {c_secs:.3f} s")
    log(f"  last_batched_perf (torch): {json.dumps(perf)}")
    ms = ExperimentGrid(name="fig8-2sm", workloads=MS_APPS, policies=MS_POLICIES,
                        scale=MS_SCALE, seed=0, gpu=GPUConfig(num_sms=2))
    recs, secs, perf = timed_grid(ms, engine="torch", strict=True, device=device)
    with env_vars(REPRO_BATCHED_BACKEND="c"):
        c_recs, c_secs, _ = timed_grid(ms, engine="batched", strict=True)
    if not perf["host_chunks"] or perf["host_chunks"] != perf["chunks"] or perf["iterations"]:
        fail(f"11a: the 2-SM grid's chunks did not all go to the host: {perf}")
    if [dataclasses.asdict(r) for r in recs] != [dataclasses.asdict(r) for r in c_recs]:
        fail("11a: the 2-SM grid's records under engine='torch' differ from the batched run's")
    out["multi_sm"] = {"cells": len(recs), "seconds": secs, "c_s": c_secs,
                       "host_chunks": perf["host_chunks"], "perf": perf}
    log(f"  2-SM grid ({len(MS_APPS)} apps x {len(MS_POLICIES)} policies, scale {MS_SCALE}): "
        f"{perf['host_chunks']:.0f} of {perf['chunks']:.0f} chunks on the host, records equal "
        f"to the batched run's; {secs:.3f} s")
    return out


def quick_grid():
    from repro_torch.core.runner import ExperimentGrid
    return ExperimentGrid(name="quick", workloads=QUICK_APPS, policies=QUICK_POLICIES,
                          scale=QUICK_SCALE)


def quick_budget():
    """A token budget that puts each of the quick grid's workloads in a
    chunk of its own (the largest one-workload plane, so two do not fit)."""
    from repro_torch.core.runner import _cached_workload, workload_seed
    return max(len(wl.traces) * max(len(k) for k, _ in wl.traces) * 8
               for wl in (_cached_workload(w, workload_seed(0, w), QUICK_SCALE)
                          for w in QUICK_APPS))


def runs_cli(*argv, env=None):
    """``python -m repro_torch.runs`` in a subprocess: (return code, stdout)."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.runs", *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    if out.returncode:
        log(f"  runs {' '.join(argv)}: rc {out.returncode}: {out.stderr.strip()[-2000:]}")
    return out.returncode, out.stdout


def ledger_and_cli(device="cuda"):
    """11b: the quick grid (2 chunks) under a ledger on the torch rung: a
    run with a deadline truncates its second chunk, ``resume`` fills it in
    equal to an uninterrupted run; ``runs list`` and ``show`` report the
    run complete; ``runs create`` and two ``runs work`` processes drain a
    fresh run together on the card, and the reassembled records equal the
    serial run's."""
    import dataclasses
    import shutil
    from repro_torch.core import faults
    from repro_torch.core.ledger import RunLedger
    from repro_torch.core.runner import FailedCell, RunRecord
    out = {}
    runs_dir = ROOT / "build" / "phase11" / "runs"
    shutil.rmtree(runs_dir, ignore_errors=True)
    grid = quick_grid()
    budget = quick_budget()
    env = dict(os.environ, REPRO_RUNS_DIR=str(runs_dir), REPRO_BATCH_TOKEN_BUDGET=str(budget),
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_BATCHED_BACKEND", None)
    with env_vars(REPRO_RUNS_DIR=runs_dir, REPRO_BATCH_TOKEN_BUDGET=budget):
        with env_vars(REPRO_BATCHED_BACKEND="c"):
            serial, serial_s, _ = timed_grid(grid, engine="batched", strict=True)
        log(f"[11b] the quick grid ({len(QUICK_APPS)} apps x {len(QUICK_POLICIES)} policies, "
            f"scale {QUICK_SCALE}, a token budget of {budget} bytes: one chunk an app) under a "
            f"ledger on the torch rung ({device}); deadline {QUICK_DEADLINE_S} s, the first "
            f"dispatch held {QUICK_DELAY_S} s")
        with faults.injected(f"chunk.dispatch@1=delay:{QUICK_DELAY_S}"):
            cut, cut_s, cut_perf = timed_grid(grid, engine="torch", device=device, run_id="quick-dl",
                                              deadline_s=QUICK_DEADLINE_S)
        done = [r for r in cut if isinstance(r, RunRecord)]
        trunc = [r for r in cut if isinstance(r, FailedCell) and r.truncated]
        if not done or not trunc or len(done) + len(trunc) != len(cut):
            fail(f"11b: the deadline run gave {len(done)} records and {len(trunc)} truncated cells "
                 f"of {len(cut)}")
        if RunLedger("quick-dl").load()["status"] != "truncated":
            fail("11b: the deadline run's ledger is not marked truncated")
        resumed, resume_s, resume_perf = timed_grid(grid, engine="torch", device=device,
                                                    resume="quick-dl", strict=True)
        if resumed != serial or resume_perf["chunks_resumed"] != 1:
            fail(f"11b: the resumed run's records differ from the uninterrupted run's "
                 f"(chunks resumed {resume_perf['chunks_resumed']})")
        log(f"  deadline run {cut_s:.2f} s: {len(done)} records, {len(trunc)} truncated cells; "
            f"resume {resume_s:.2f} s, 1 chunk from the ledger, records equal to the "
            f"uninterrupted run's")
        rc, listed = runs_cli("list", "--json", env=env)
        infos = {i["run_id"]: i for i in json.loads(listed)} if rc == 0 else {}
        if infos.get("quick-dl", {}).get("status") != "complete":
            fail(f"11b: runs list does not report quick-dl complete: {infos}")
        rc, shown = runs_cli("show", "quick-dl", "--assert-status", "complete", env=env)
        if rc:
            fail("11b: runs show --assert-status complete failed")
        log(f"  runs list / show: exit 0, quick-dl complete ({infos['quick-dl']['shards']} "
            f"shards): {shown.strip().splitlines()[0]}")
        rc, _ = runs_cli("create", "quick-drain", "--workloads", ",".join(QUICK_APPS),
                         "--policies", ",".join(QUICK_POLICIES), "--scale", str(QUICK_SCALE),
                         "--engine", "torch", "--name", "quick", env=env)
        if rc:
            fail("11b: runs create failed")
        t0 = time.perf_counter()
        workers = [subprocess.Popen([sys.executable, "-m", "repro_torch.runs", "work", "quick-drain",
                                     "--worker", f"w{k}", "--device", device], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                   for k in range(2)]
        outs = []
        try:
            for w in workers:
                outs.append(w.communicate(timeout=600)[0])
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
        drain_s = time.perf_counter() - t0
        for w, text in zip(workers, outs):
            if w.returncode:
                fail(f"11b: a runs work process exited {w.returncode}: {text[-3000:]}")
        summaries = RunLedger("quick-drain").worker_summaries()
        claims = {d["worker"]: d.get("lease_claims", 0) for d in summaries}
        drained, _, drained_perf = timed_grid(grid, engine="torch", device=device,
                                              resume="quick-drain", strict=True)
        if drained != serial or drained_perf["chunks_resumed"] != drained_perf["chunks"]:
            fail("11b: the two workers' records differ from the serial run's")
        if sum(claims.values()) < drained_perf["chunks"]:
            fail(f"11b: the workers claimed {claims} of {drained_perf['chunks']} chunks")
        log(f"  runs create + 2 x runs work on {device}: {drain_s:.2f} s, claims {claims}, "
            f"records equal to the serial run's; " + " | ".join(
                t.strip().splitlines()[-1] for t in outs))
    out.update(serial_c_s=serial_s, deadline_run_s=cut_s, truncated=len(trunc),
               completed=len(done), resume_s=resume_s, drain_s=drain_s, claims=claims,
               deadline_perf=cut_perf, resume_perf=resume_perf)
    return out


def load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_on_card(device="cuda"):
    """11c: examples/torch_serve_ciao.py's decode on the card (K3 once an
    attention layer at the prefill, K2 once a layer a step; tokens equal
    to the CPU plain path's on the same seeded weights, logits within phase
    3's bf16 tolerance) and its policy table (equal to the CPU run's);
    torch_quickstart.py (40 steps; its greedy generation through K3 and
    K2) and torch_train_tiny_lm.py --steps 20 with falling losses, the
    training launching no kernel."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import init_params
    out = {}
    serve = load_example("torch_serve_ciao")
    cfg = reduced_config("gemma2-2b")
    log(f"[11c] examples/torch_serve_ciao.py on {device}")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device, torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (4, 10), device=device,
                            generator=torch.Generator(device=device).manual_seed(1))
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tokens, logits = serve.real_model_decode(device)
    serve_s = time.perf_counter() - t0
    counts = kernel_counts()
    per_prefill, per_step = attention_calls(cfg)
    want = {"flash_attn": per_prefill, "decode_attn": per_step * 10, "ciao_gather": 0}
    if device == "cuda" and counts != want:
        fail(f"11c: the serve example launched {counts}, want {want}")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_tokens, cpu_logits = serve.real_model_decode("cpu", to_device(params, "cpu"),
                                                         prompts.cpu())
    err = max_err(logits, cpu_logits)
    if tokens != cpu_tokens or err > 3e-2:
        fail(f"11c: the serve example's tokens on {device} {tokens} differ from the CPU "
             f"path's {cpu_tokens} (max |logit err| {err:.3g})")
    log(f"  decode: launches {counts}, tokens equal to the CPU plain path's, max|logit err| "
        f"{err:.3g}; {serve_s:.2f} s")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        table = serve.ciao_policy_comparison()
    got = {p: (st.steps, st.decoded_tokens, st.work_units, st.preemptions, st.refetched_pages,
               st.completed) for p, st in table.items()}
    if got != SERVE_TABLE:
        fail(f"11c: the policy table {got} differs from the CPU run's {SERVE_TABLE}")
    out["serve"] = {"launches": counts, "tokens": tokens, "max_logit_err": err, "seconds": serve_s,
                    "policy_table_s": time.perf_counter() - t0,
                    "tokens_per_unit": {p: st.tokens_per_unit for p, st in table.items()}}
    log(f"  policy table equal to the CPU run's ({out['serve']['policy_table_s']:.2f} s)")
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        quick = load_example("torch_quickstart").main(device, steps=40)
    counts = kernel_counts()
    losses = quick["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not all(math.isfinite(x) for x in losses) or not last < first - 0.5:
        fail(f"11c: the quickstart's loss does not fall: {losses}")
    # its training launches nothing; its greedy generation (a prefill, 12
    # steps) goes through K3 and K2
    want = {"flash_attn": per_prefill, "decode_attn": per_step * 12, "ciao_gather": 0}
    if device == "cuda" and counts != want:
        fail(f"11c: the quickstart launched {counts}, want {want}")
    out["quickstart"] = {"first5": first, "last5": last, "launches": counts,
                         "seconds": time.perf_counter() - t0}
    ckpt = ROOT / "build" / "phase11" / "tiny_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        trained = load_example("torch_train_tiny_lm").main(
            ["--steps", "20", "--ckpt", str(ckpt)] + (["--device", device] if device != "cuda"
                                                       else []))
    tl = trained["losses"]
    if len(tl) != 20 or not all(math.isfinite(x) for x in tl) or not tl[-1] < tl[0] - 0.5:
        fail(f"11c: torch_train_tiny_lm's loss does not fall: {tl}")
    counts = kernel_counts()
    if any(counts.values()):
        fail(f"11c: training launched kernels: {counts}")
    out["train_tiny_lm"] = {"first": tl[0], "last": tl[-1], "seconds": time.perf_counter() - t0}
    log(f"  quickstart 40 steps: loss {first:.3f} -> {last:.3f} (means of 5), its generation "
        f"launched {out['quickstart']['launches']}; train_tiny_lm 20 steps: {tl[0]:.3f} -> "
        f"{tl[-1]:.3f}, no kernel launched")
    return out


def runner_phase(card, device="cuda"):
    """Phase 11, in order."""
    t0 = time.perf_counter()
    out = {"card": card, "runner": runner_full_size(device)}
    out["runner_s"] = time.perf_counter() - t0
    out["ledger"] = ledger_and_cli(device)
    out["ledger_s"] = time.perf_counter() - t0 - out["runner_s"]
    out["examples"] = examples_on_card(device)
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> None:
    import torch
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)}")
    phase_s = {}
    t = time.perf_counter()

    def took(phase):
        nonlocal t
        phase_s[phase] = time.perf_counter() - t
        log(f"[{phase}] took {phase_s[phase]:.1f} s")
        t = time.perf_counter()

    build_kernels()
    took("1")
    errs, failed = check_kernels()
    if failed:
        fail(f"{len(failed)} kernel checks disagree with the plain versions: {failed}")
    check_forward_only()
    took("2")
    check_reduced()
    took("3")
    phase4 = {}
    paths = {"gemma2-2b": serve_full_width(card, phase4)}
    took("4")
    paths[GRANITE] = serve_granite(card)
    took("4b")
    paths.update({name: r["launches"] for name, r in serve_zoo(card).items()})
    took("4c")
    paths.update({name: r["launches"] for name, r in serve_recurrent(card).items()})
    took("4d")
    paths.update({name: r["launches"] for name, r in serve_frontends(card).items()})
    took("4e")
    launches = {k: sum(n[k] for n in paths.values()) for k in ("flash_attn", "decode_attn")}
    launches["ciao_gather"], gather = gather_full_width(errs)
    took("5")
    kernels = time_kernels(errs, launches, card, gather, paths)
    took("6")
    stepper = simulator_path(card)
    took("7")
    dry = start_dry_run()
    train, train_launches = train_phase(card)
    took("8")
    train["sharded"] = {"full_width": sharded_full_width(card, train["full_width"])}
    took("9")
    sharded = sharded_phase(card, phase4, dry)
    took("10")
    runner = runner_phase(card)
    took("11")
    for k in kernels:
        k["train_launches"] = train_launches[k["name"]]
        k["sharded_launches"] = sharded["serve"]["launches"].get(k["name"], 0)
        k["example_launches"] = runner["examples"]["serve"]["launches"][k["name"]]
    log(f"the script took {time.perf_counter() - t_script:.1f} s, kernels' build included; "
        f"by phase: {json.dumps(phase_s)}")
    log(json.dumps({"stepper": stepper}))
    log(json.dumps({"train": train}))
    log(json.dumps({"sharded_serving": sharded}))
    log(json.dumps({"runner": runner}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # torch.compile (the flex_attention yardstick) caches inside the
    # checkout and compiles in this process, leaving no worker behind.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    if sys.argv[1:2] == ["--profile-k2"]:     # phase 6's profiling process
        profile_k2_main(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--dry-run-cells"]:    # 10d's process
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(dry_run_cells()), flush=True)
    else:
        main()
