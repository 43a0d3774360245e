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
    3x;
 3. reduced gemma2-2b: the port's CPU plain path against its CUDA kernel
    path, logits and greedy tokens;
 4. full-width gemma2-2b in bf16 with random weights from a seeded
    generator: 4 requests of 4608-token prompts (longer than the 4096-token
    local window), 32 greedy decode steps through ``generate``; the launch
    counts show the path went through the kernels;
 5. the CIAO gather path at full width: the gather workload's index stream
    (72,000 requests of 48 streams, 6 of them isolated) against a bf16 table
    of gemma2-2b's vocab x d_model, through ``ciao_gather`` with the trace's
    isolation bits and with none; rows byte-equal and counts equal to the
    plain version, and the launch count shows the path went through K1;
 6. kernel times at the main paths' shapes (CUDA events around back-to-back
    calls) beside their bounds, the plain versions and one PyTorch library
    call of the same function, with the device time of K1's and K2's
    launches under the profiler, and K2's time over a CUDA graph of 100
    calls (``device_ms``: without the host's launch cost);
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

Phase 2 also shows that the attention kernels refuse CUDA inputs that
require grad (they have no backward). Before the card line comes one JSON
object {"stepper": ...} of phase 7's numbers; the line before the last is
one JSON object of per-kernel numbers; the last line is
{"ok": true, "device": {...}}. Without a card, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
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
        report, fn = {}, ""
        for line in b.log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill stores" in line:
                report.setdefault(fn, []).append(line.strip().split(" stack frame, ")[-1])
            elif "Used" in line and "registers" in line:
                report.setdefault(fn, []).insert(0, line.split("Used")[1].split(",")[0].strip())
        names = demangle(list(report))
        for fn, items in report.items():
            log(f"    {', '.join(items)}  {names[fn]}")


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
SCALE = 256 ** -0.5


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

    def hold(name, case, out, plain, v):
        """``plain(v)`` is the plain version on the values ``v``;
        ``plain(v.abs())`` gives |p| @ |v| for the tolerance's p term."""
        atol, rtol, ptol = TOL[str(out.dtype).split(".")[1]][name]
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
        kv_dtypes = (torch.float32, torch.bfloat16) if dtype == torch.float32 else (dtype,)
        for (b, s, hq, hkv, d, lengths) in DECODE_GRID if "decode_attn" in only else ():
            for kv_dtype in kv_dtypes:
                q = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(dtype)
                ck = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(kv_dtype)
                cv = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(kv_dtype)
                lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                                     dtype=torch.int32) if lengths is None else \
                    torch.tensor(lengths, dtype=torch.int32, device="cuda")
                args = dict(scale=d ** -0.5, softcap=50.0)
                hold("decode_attn", f"{dtype}/{kv_dtype} grid {(b, s, hq, hkv, d, lengths)}",
                     DK.decode_attention_cuda(q, ck, cv, lens, **args),
                     lambda w: DO.decode_attention_plain(q, ck, w, lens, **args), cv)
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
def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def check_reduced():
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.models.model import init_params
    from repro_torch.serving import generate
    log("[3] reduced gemma2-2b f32: CPU plain path against the CUDA kernel path")
    cfg = reduced_config("gemma2-2b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (3, 24), generator=torch.Generator().manual_seed(1))
    steps = 10
    for kv_dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        cpu_tok, cpu_logits = generate(cfg, params, prompts, steps, device="cpu",
                                       kv_dtype=kv_dtype)
        flash_attention_cuda.launches = decode_attention_cuda.launches = 0
        tok, logits = generate(cfg, to_device(params, "cuda"), prompts, steps, kv_dtype=kv_dtype)
        counts = (flash_attention_cuda.launches, decode_attention_cuda.launches)
        err = max_err(logits.cpu(), cpu_logits)
        gap = cpu_logits.topk(2, dim=-1).values
        clear = torch.cat([torch.ones_like(gap[:, :1, 0], dtype=torch.bool),
                           (gap[:, :-1, 0] - gap[:, :-1, 1]) > tol], dim=1)
        same = bool((tok.cpu() == cpu_tok)[clear].all())
        log(f"  kv {kv_dtype}: max|logit err| {err:.3g} (tol {tol:g}), greedy tokens equal "
            f"where the top-2 gap exceeds it: {same}, launches flash {counts[0]} decode {counts[1]}")
        if err > tol or not same:
            fail(f"reduced gemma2-2b CUDA path disagrees with the CPU path (kv {kv_dtype})")
        if counts != (cfg.num_layers, cfg.num_layers * steps):
            fail(f"reduced gemma2-2b launch counts {counts}")


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


def serve_full_width(card: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.models import model as M
    from repro_torch.serving import generate
    cfg = get_config("gemma2-2b")
    log(f"[4] gemma2-2b bf16 at full width ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params): "
        f"{BATCH} x {SEQ}-token prompts, {STEPS} greedy steps")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    generate(cfg, params, prompts[:, :256], 2)     # warm-up: cuBLAS, allocator
    sync()

    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = decode_attention_cuda.launches = 0
    t0 = time.perf_counter()
    tokens, logits = generate(cfg, params, prompts, STEPS)
    sync()
    total_s = time.perf_counter() - t0
    launches = {"flash_attn": flash_attention_cuda.launches,
                "decode_attn": decode_attention_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attn": cfg.num_layers, "decode_attn": cfg.num_layers * STEPS}
    log(f"  generate: {total_s * 1e3:.1f} ms, launches {launches} (want {want}), "
        f"peak memory {peak_gb:.2f} GB, init {init_s:.1f} s")
    if launches != want:
        fail(f"launch counts {launches}, want {want}")
    if tokens.shape != (BATCH, STEPS) or logits.shape != (BATCH, STEPS, cfg.vocab_size):
        fail(f"shapes tokens {tuple(tokens.shape)} logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits.float()).all()):
        fail("non-finite logits")
    if not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail("token out of range")
    if not torch.equal(logits[:, :-1].argmax(-1), tokens[:, 1:]):
        fail("greedy tokens do not follow the logits")

    # the two phases apart: prefill alone, then the decode steps
    def run_prefill():
        return M.prefill(cfg, params, {"tokens": prompts}, max_len=SEQ + STEPS)

    sync()
    t0 = time.perf_counter()
    logits0, cache, pos = run_prefill()
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits0.argmax(-1)[:, None]
    fed = []
    t0 = time.perf_counter()
    for i in range(STEPS):
        fed.append(tok)
        step_logits, cache = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
        tok = step_logits.argmax(-1)[:, None]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    # the reference's own check (test_greedy_generation_deterministic): a
    # rerun gives the same greedy sequence
    if not torch.equal(torch.cat(fed, dim=1), tokens):
        fail("a second run of prefill and decode gave other greedy tokens")
    # Device busy time from the profiler; the idle share puts it against the
    # untraced wall time, since tracing slows the host side.
    pf = device_profile(run_prefill)
    dec = device_profile(     # the last step again, at its own slot
        lambda: M.decode_step(cfg, params, tok, pos + STEPS, cache))
    for prof, wall in ((pf, prefill_ms), (dec, decode_ms)):
        prof["idle_share"] = 1 - prof["device_busy_ms"] / wall if prof["device_busy_ms"] else None
    result = {
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "decode_tokens_per_s": BATCH * 1e3 / decode_ms, "generate_ms": total_s * 1e3,
        "peak_mem_gb": peak_gb, "launches": launches,
        "prefill_profile": pf, "decode_step_profile": dec, "card": card}
    log(f"  prefill {prefill_ms:.1f} ms, decode {decode_ms:.3f} ms/step, "
        f"{result['decode_tokens_per_s']:.1f} tokens/s, device idle share prefill "
        f"{pf['idle_share']} decode {dec['idle_share']}; on {card}")
    for what, prof in (("prefill", pf), ("decode step", dec)):
        log(f"  {what}: device busy {prof['device_busy_ms']} ms "
            f"(profiled wall {prof['wall_ms']:.1f} ms); top kernels:")
        for name, ms, calls in prof["top"]:
            log(f"    {ms:9.3f} ms {calls:5d}x  {name}")
    log(json.dumps({"main_path": result}))
    del params, cache, logits
    torch.cuda.empty_cache()
    return launches


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
def flash_bound(q, k, v, window):
    b, s, hq, d = q.shape
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
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


def library_flash(q, k, v, window, lengths=None):
    """One PyTorch call computing the same function: flex_attention with the
    softcap as score_mod and the mask as a block mask, compiled. Timed as a
    yardstick only; the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    b, hq, sq, _ = qt.shape
    skv = kt.shape[2]
    if lengths is None:
        def mask(bi, h, qi, ki):
            ok = ki <= qi
            return ok & (qi - ki < window) if window else ok
    else:
        def mask(bi, h, qi, ki):
            return ki < lengths[bi]

    def cap(score, bi, h, qi, ki):
        return torch.tanh(score / 50.0) * 50.0

    block = create_block_mask(mask, b, None, sq, skv, device="cuda")
    fn = torch.compile(flex_attention)
    return lambda: fn(qt, kt, vt, score_mod=cap, block_mask=block, scale=SCALE,
                      enable_gqa=True), lambda out: out.transpose(1, 2)


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


def time_kernels(errs, launches, card, gather):
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    log("[6] kernel times at the main paths' shapes, bf16")
    gen = torch.Generator(device="cuda").manual_seed(2)
    (q, k, v), decode = main_path_inputs(torch.bfloat16, gen)
    rows = {"flash_attn": [], "decode_attn": []}
    for kind, window in (("local", WINDOW), ("global", 0)):
        args = dict(scale=SCALE, causal=True, window=window, softcap=50.0)
        ms = cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 5)
        plain = cuda_ms(lambda: FO.flash_attention_plain(q, k, v, **args), 2)
        lib = lib_err = None
        try:
            call, back = library_flash(q, k, v, window)
            lib_err = max_err(back(call()), FK.flash_attention_cuda(q, k, v, **args))
            lib = cuda_ms(call, 5, warmup=2)
        except Exception as e:  # the yardstick only; the port does not depend on it
            log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
        b_ms, by = bound_ms(*flash_bound(q, k, v, window))
        rows["flash_attn"].append((ms, plain, lib, b_ms, by, {}))
        log(f"  flash_attn {kind}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"flex_attention {lib} ms (max|diff| {lib_err}), bound {b_ms:.4f} ms ({by})")
    del q, k, v
    for kind in ("local", "global"):
        dq, ck, cv, lens = decode[kind]
        args = dict(scale=SCALE, softcap=50.0)

        def k2():
            return DK.decode_attention_cuda(dq, ck, cv, lens, **args)

        ms = cuda_ms(k2, 50, warmup=5)       # back to back: the host's launch cost included
        device = graph_ms(k2, 100)           # the card's time alone
        plain = cuda_ms(lambda: DO.decode_attention_plain(dq, ck, cv, lens, **args), 10)
        lib = lib_err = None
        try:
            call, back = library_flash(dq, ck, cv, 0, lengths=lens)
            lib_err = max_err(back(call()), DK.decode_attention_cuda(dq, ck, cv, lens, **args))
            lib = cuda_ms(call, 50, warmup=5)
        except Exception as e:  # the yardstick only; the port does not depend on it
            log(f"  flex_attention unavailable ({type(e).__name__}: {e}); library_ms null")
        b_ms, by = bound_ms(*decode_bound(dq, ck, lens))
        prof = device_profile(lambda: [k2() for _ in range(5)])
        rows["decode_attn"].append((ms, plain, lib, b_ms, by,
                                    {"device_ms": device, "profile_5_calls": prof}))
        log(f"  decode_attn {kind}: kernel {ms:.4f} ms (events, 50 calls), {device:.4f} ms "
            f"(CUDA graph of 100 calls), plain {plain:.4f} ms, flex_attention {lib} ms "
            f"(max|diff| {lib_err}), bound {b_ms:.4f} ms ({by}); 5 calls under the profiler, "
            f"device ms a launch:")
        for name, k_ms, calls in prof["top"]:
            log(f"    {k_ms / calls:9.4f} ms ({calls:2d} launches)  {name}")

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
            "max_abs_err": max(e for c, e in errs[name].items() if "bfloat16 main" in c),
            "ms": mean([x[0] for x in r]), "plain_ms": mean([x[1] for x in r]),
            "bound_ms": mean([x[3] for x in r]),
            "bound_by": r[0][4] if all(x[4] == r[0][4] for x in r) else "mixed",
            "library_ms": mean([x[2] for x in r]),
            **({"device_ms": mean([x[5]["device_ms"] for x in r])} if "device_ms" in r[0][5]
               else {}),
            "per_layer_kind": {kind: {"ms": x[0], "plain_ms": x[1], "library_ms": x[2],
                                      "bound_ms": x[3], "bound_by": x[4], **x[5]}
                               for kind, x in zip(("local", "global"), r)},
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
    build_kernels()
    errs, failed = check_kernels()
    if failed:
        fail(f"{len(failed)} kernel checks disagree with the plain versions: {failed}")
    check_forward_only()
    check_reduced()
    launches = serve_full_width(card)
    launches["ciao_gather"], gather = gather_full_width(errs)
    kernels = time_kernels(errs, launches, card, gather)
    stepper = simulator_path(card)
    log(f"the script took {time.perf_counter() - t_script:.1f} s, kernels' build included")
    log(json.dumps({"stepper": stepper}))
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
    main()
