#!/usr/bin/env python3
"""Check and time the CIAO gather (K1) and decode attention (K2) kernels on the card.

    python3 tools/kernel_probe.py [--check] [--broken [KERNEL ...]] [--variants [NAME ...]]
                                  [--parent DIR] [--source KERNEL:NAME=PATH ...]
                                  [--cases LABEL ...] [--decode [ARCH ...]] [--scaling]
                                  [--build-times DIR] [--split-blocks N [N ...]]
                                  [--profile-windows N]

--check [KERNEL ...]
            build the kernels and run phase 2 of chip_smoke.py (each kernel,
            or those named, against its plain version at its grid and edge
            cases);
--broken [KERNEL ...]
            build broken copies of K1, K2 and K3, or of the kernels named
            (ciao_gather, decode_attn, flash_attn) (text edits of the sources,
            under build/probe/) and run phase 2's checks of that kernel with
            each, printing which checks fail (K3's copies reading every K
            tile from the ring's first stage and folding the exponent with
            the stale row maximum; without the K stage
            wait also with a slowed producer, and the slowed producer alone;
            its split launch merging warpgroup 0's partial without warpgroup
            1's; K2's ring kernel without a stage's keys at D 64 and without
            one lane group's partials at D 128);
--variants [NAME ...]
            time text-edited variants of both kernels (all of them, or those
            named) in turns at the main paths' shapes; those marked "wrong"
            leave out part of the work on purpose and only say what that
            part costs;
--parent    DIR is an older revision of src/repro_torch/kernels (for example
            `git archive HEAD~1 src/repro_torch/kernels` unpacked): its
            decode_attn and ciao_gather wrappers, built from its own sources,
            are timed in turns with the current ones, beside the plain
            versions, the library calls and the bounds, with the device
            time of each launch under the profiler (K2 at gemma2-2b's local
            and global steps and at every shape phase 6 times it: the zoo's
            last decode steps and the frontends' steps);
--source    another source of one kernel (decode_attn or ciao_gather),
            bound through the current wrapper, timed in turns like the
            parent;
--cases LABEL ...
            time K2 only at the ``decode_cases`` of these labels (e.g.
            local global recurrentgemma-9b "paligemma-3b last step"), and
            K1 not at all unless a K1 library is timed;
--decode [ARCH ...]
            (with --parent) full-width decode after one prefill, with the
            parent's K2 and the current one in turns, and a profiled step of
            each (device busy ms and K2's device ms): gemma2-2b (phase 4's 4 x
            4608 tokens, 32 steps) when no ARCH is named; else each ARCH at
            its chip_smoke.py phase's workload (granite-moe-3b-a800m at 4b's,
            the 4c archs at 2 x 1024 tokens and 8 steps with 4c's depth
            cuts), "zoo" naming granite-moe and the four 4c archs;
--scaling   K1 at larger traces and caches than the gather path's (4x the
            requests, 4096 + 1024 slots), every K1 library in turns, with
            the device time of each of its kernels;
--build-times DIR
            nvcc's wall seconds for decode_attn.cu of the older revision
            DIR (as for --parent) and of the current one, one build at a
            time, in turns (older, current, current, older);
--split-blocks N [N ...]
            K2's split kernel (f32 queries against a bf16 cache: the bf16
            serving path takes the ring kernel) at the zoo paths' last decode
            steps at D 64 and 128 (chip_smoke.ZOO_DECODE but recurrentgemma)
            with its plan aimed at each N blocks an SM
            (kernel.SPLIT_BLOCKS_PER_SM), in turns, each held against the
            plain version.
--mma-plans NAME=VALUE[,NAME=VALUE] ...
            K2's tensor-core consumer (D 256, G 8 and 16) at its ``--cases``
            (recurrentgemma's and paligemma's steps by default) with each
            set of ``kernel`` constants (MMA_MIN_TILES, MMA_MAX_SPLITS) in
            turn, in turns: a CUDA graph of 100 calls and
            events around 50, and max |err| against the plain version;
--profile-windows N
            why phase 6's profiler windows can show no device work: at each
            K2 case (``--cases``), a CUDA graph of the kernel is timed and
            then N windows of phase 6's shape are profiled, in a process
            with kineto's CUPTI teardown between sessions (torch's default)
            and in one without (TEARDOWN_CUPTI=0), counting the windows
            that saw no device work.

K2 is timed three ways: CUDA events around 50 back-to-back calls (as
chip_smoke.py's phase 6 times it, host launch cost included), a CUDA graph
of 100 calls (device time alone), and the host's own time to issue a call.

There is no ncu on the card's machine, so what holds a kernel back is
measured by difference. Every time is printed with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as C  # noqa: E402
from probe_util import OUT, build_all, edited  # noqa: E402

# (kernel, name, right function?, edits)
# K3's consumers skip the wait on a K stage's full barrier (every step after
# the first). The producer issues K one step ahead of V, so the wait is
# hidden by timing; with the producer issuing V first and sleeping before
# each K load, the checks catch the copy. The slow producer alone is a
# right kernel and must pass.
K3_SKIP_K_WAIT = ("        mbar_wait(full_k(sk), (rk / kST) & 1);\n", "")
K3_SLOW_PRODUCER = (
    "        if (i + 1 < it.nb) load(&tm_k, sK, true, i + 1);\n"
    "        load(&tm_v, sV, false, i);\n",
    "        load(&tm_v, sV, false, i);\n"
    "        if (i + 1 < it.nb) {\n"
    "          __nanosleep(20000);\n"
    "          load(&tm_k, sK, true, i + 1);\n"
    "        }\n")
BROKEN = [
    # the consumers read every K tile from the ring's first stage (the
    # 128-key tiles of the D 64 and 128 plans, and the rest)
    ("flash_attn", "k_ring_one_stage", [(
        "        gemm_qk<D>(s, sQw, sK + sk * T::KV_BYTES);\n",
        "        gemm_qk<D>(s, sQw, sK);\n")]),
    # the folded exponent x u - m u taken with the row maximum before this
    # tile's update (D 64's and D 128's unmasked tiles)
    ("flash_attn", "fold_stale_max", [(
        "    m[r] = grow ? t : m[r];\n    nm[r] = -m[r] * u;\n",
        "    nm[r] = -m[r] * u;\n    m[r] = grow ? t : m[r];\n")]),
    ("flash_attn", "skip_k_stage_wait", [K3_SKIP_K_WAIT]),
    ("flash_attn", "skip_k_stage_wait_slow_producer", [K3_SKIP_K_WAIT, K3_SLOW_PRODUCER]),
    ("flash_attn", "slow_producer_alone_right", [K3_SLOW_PRODUCER]),
    # the split launch stores warpgroup 0's partial without merging
    # warpgroup 1's (the other half of the key tiles)
    ("flash_attn", "drop_second_warpgroup_partial", [(
        "      merge_part(wpart, tid, u, acc, m, l);\n", "")]),
    # both ring kernels' consumers skip the wait on stage 1's full barrier
    ("decode_attn", "skip_stage1_full_wait", [(
        "      mbar_wait(full0 + 8 * st, (i / kStages) & 1);\n",
        "      if (st != 1) mbar_wait(full0 + 8 * st, (i / kStages) & 1);\n", 2)]),
    # the last block's merge leaves out the last split's (or cluster's) partial
    ("decode_attn", "drop_last_split", [(
        "    for (int s = 0; s < nparts; ++s) {\n      const float4 a = __ldcg(",
        "    for (int s = 0; s < nparts - 1; ++s) {\n      const float4 a = __ldcg(")]),
    # the tensor-core consumer: a k-step of Q K^T dropped (columns 112-127),
    # the accumulator not rescaled when the row maximum moves, and the
    # cluster's merge without its last block's partial
    ("decode_attn", "mma_drop_qk_kstep", [(
        "          mma_16816(s1, qa[2 * kk + 1], b2, b3);\n",
        "          if (kk != 3) mma_16816(s1, qa[2 * kk + 1], b2, b3);\n")]),
    ("decode_attn", "mma_no_rescale", [(
        "            o[j][2 * h] *= corr;\n            o[j][2 * h + 1] *= corr;\n", "")]),
    ("decode_attn", "mma_lose_cluster_partial", [(
        "    for (int r = 0; r < nsplit; ++r) {\n      const float c = ex2(",
        "    for (int r = 0; r < nsplit - 1; ++r) {\n      const float c = ex2(")]),
    # the ring kernel's consumers skip a split's second stage at D 64
    ("decode_attn", "drop_second_stage_d64", [(
        "        if (base >= n) break;\n",
        "        if (base >= n || (D == 64 && i == 1)) break;\n")]),
    # the ring kernel's lane-group sum skips its one level at D 128, losing
    # lane group 1's partial accumulators
    ("decode_attn", "lose_lane_group_d128", [(
        "    for (int o = D / 8; o < 32; o <<= 1) {\n",
        "    for (int o = D == 128 ? 32 : D / 8; o < 32; o <<= 1) {\n")]),
    ("ciao_gather", "every_request_a_miss", [(
        "atomicAdd(&cnt[2 * r.z + (r0 + lane == p ? 1 : 0)], 1)",
        "atomicAdd(&cnt[2 * r.z + 1], 1)")]),
    ("ciao_gather", "skip_last_of_run", [(
        "const int m = min(32, q - r0);", "const int m = min(32, q - 1 - r0);")]),
]
VARIANTS = [
    ("decode_attn", "kernel", True, []),
    ("decode_attn", "no_math", False, [("        if (base >= n) break;\n",
                                        "        if (true) break;\n")]),
    ("decode_attn", "rows_only", True, [("      if (n == kTileKeys) {\n", "      if (false) {\n")]),
    ("decode_attn", "no_tiles", False, [(
        "  const int ntiles = (end - start + kTileKeys - 1) / kTileKeys;",
        "  const int ntiles = 0;")]),
    ("decode_attn", "no_split_merge", False, [(
        "  for (int idx = threadIdx.x; idx < G * D / 4; idx += blockDim.x) {",
        "  for (int idx = G * D; idx < G * D / 4; idx += blockDim.x) {")]),
    ("decode_attn", "stages_2", True, [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    ("decode_attn", "stages_6", True, [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    # the TMA boxes' L2 promotion: a D 64 row is 128 bytes, so 256-byte
    # promotion also fetches the next head's row
    ("decode_attn", "l2_128b_at_d64", True, [(
        "CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,",
        "CU_TENSOR_MAP_SWIZZLE_NONE, D == 64 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B : "
        "CU_TENSOR_MAP_L2_PROMOTION_L2_256B,")]),
    ("decode_attn", "l2_none", True, [(
        "CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,",
        "CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,")]),
    # the producer waits for q in shared memory before its first loads
    ("decode_attn", "q_before_producer", True, [(
        "  __syncthreads();\n  // the producer's first loads go out while the consumers bring q into\n",
        "  for (int e = threadIdx.x; e < G * D; e += blockDim.x) sq[e] = "
        "__bfloat162float(q[qrow * D + e]);\n  __syncthreads();\n"
        "  // the producer's first loads go out while the consumers bring q into\n"),
        ("  if (warp < kConsumers) {\n    for (int e = threadIdx.x; e < G * D; e += kConsumers * 32)\n"
         "      sq[e] = __bfloat162float(q[qrow * D + e]);\n"
         "    asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers * 32) : \"memory\");\n  }\n",
         "")]),
    # a consumer warp's passes over a stage never unrolled, and always
    ("decode_attn", "passes_rolled", True, [(
        "#pragma unroll kPassUnroll\n", "#pragma unroll 1\n")]),
    ("decode_attn", "passes_unrolled", True, [(
        "#pragma unroll kPassUnroll\n", "#pragma unroll\n")]),
    # the tensor-core consumer (D 256, G 8 and 16) without its math, and
    # without its tiles (neither loads nor math: launch, prologue, the key
    # groups' and the splits' merges)
    ("decode_attn", "mma_no_math", False, [("      if (key0 < n) {\n",
                                            "      if (false) {\n")]),
    ("decode_attn", "mma_no_tiles", False, [(
        "  const int ntiles = end > start ? (end - start + T - 1) / T : 0;",
        "  const int ntiles = 0;")]),
    # P rounded to bf16 once, without its remainder's product
    ("decode_attn", "mma_p_bf16_once", False, [(
        "            mma_1688(o[4 * jj + j], e0, e1, v[j]);\n", "")]),
]


def bind(module, so):
    """(lib, fn) of the library ``so`` with the argument types that
    ``module._entry`` gives its own library."""
    from repro_torch.kernels import _build
    lib, load = ctypes.CDLL(str(so)), _build.load
    _build.load = lambda name: lib
    try:
        return module._entry.__wrapped__()
    finally:
        _build.load = load


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod       # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def wrappers():
    """The current wrapper module of each kernel."""
    from repro_torch.kernels.ciao_gather import kernel as CK
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.flash_attn import kernel as FK
    return {"decode_attn": DK, "ciao_gather": CK, "flash_attn": FK}


def run_broken(kernels=()):
    """Each broken copy (of ``kernels``, or of every kernel) in a process of
    its own: a copy may fail its launch (the card's context is lost then),
    which counts as failing phase 2."""
    from repro_torch.kernels import _build
    broken = [b for b in BROKEN if not kernels or b[0] in kernels]
    sources = {}
    for kernel, name, edits in broken:
        path = OUT / f"{kernel}_{name}.cu"
        path.write_text(edited(_build.source(kernel).read_text(), edits))
        sources[f"{kernel}_{name}"] = path
    built = build_all(sources)
    for kernel, name, _ in broken:
        proc = subprocess.run([sys.executable, __file__, "--broken-one", kernel,
                               str(built[f"{kernel}_{name}"])], capture_output=True, text=True)
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        verdict = lines[-1] if proc.returncode == 0 and lines else \
            f"the launch failed (exit {proc.returncode}): {' | '.join(lines[-3:])}"
        C.log(f"broken copy {kernel} {name}: {verdict}")


def run_broken_one(kernel: str, so: Path):
    mod = wrappers()[kernel]
    mod._entry = (lambda e: lambda: e)(bind(mod, so))
    _, failed = C.check_kernels(only=(kernel,))
    C.sync()
    C.log(f"{len(failed)} of phase 2's {kernel} checks fail: {failed}")


def gather_inputs(scale: float = 1.0):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.workloads import gather_index_stream
    cfg = get_config("gemma2-2b")
    indices, streams, iso = gather_index_stream(0, scale, table_rows=cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    idx, st = (torch.from_numpy(a.astype(np.int32)).cuda() for a in (indices, streams))
    return table, idx, st, {"isolated": torch.from_numpy(iso).cuda(),
                            "not isolated": torch.zeros_like(torch.from_numpy(iso)).cuda()}


def use(mod, entry):
    mod._entry = (lambda e: lambda: e)(entry)


def host_us(fn, iters: int, reps: int = 5) -> float:
    """The host's time to issue one ``fn()``, in microseconds: the least,
    over ``reps`` runs, of ``iters`` calls back to back timed on the host
    clock before the synchronise. The least leaves out most of the time
    the shared host gives to other processes (the thread CPU clock ticks
    in 10 ms there, too coarse for a call)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        C.sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    C.sync()
    return best * 1e6 / iters


def host_breakdown(dq, ck, cv, lens, args):
    """Where the current K2 wrapper's host time goes, in us a call
    (``host_us``): the whole call, its one allocation (the output), and the
    bare ctypes launch with its arguments ready."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK
    b, _, hq, d = dq.shape
    s, hkv = ck.shape[1], ck.shape[2]
    splits = DK.plan_for(b, hkv, s, d, dq.dtype, ck.dtype, DK._sm_count(0), g=hq // hkv)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(dq)
    n_acc = b * hq * splits * d
    tickets, partials = DK._scratch(dq.device, stream, b * hkv, n_acc + b * hq * splits * 2)
    lib, fn = DK._entry()
    ptrs = (dq.data_ptr(), ck.data_ptr(), cv.data_ptr(), lens.data_ptr(), out.data_ptr(),
            partials.data_ptr(), partials.data_ptr() + 4 * n_acc, tickets.data_ptr())
    launch_args = (*ptrs, b, s, hq, hkv, d, splits, float(args["scale"]),
                   float(args["softcap"]), 1, 1, stream)

    parts = {"call": lambda: DK.decode_attention_cuda(dq, ck, cv, lens, **args),
             "output allocation": lambda: torch.empty_like(dq),
             "ctypes launch": lambda: fn(*launch_args)}
    return {k: host_us(f, 200) for k, f in parts.items()}


def time_in_turns(libs, call, iters, timer):
    """{name: [t, t]}: each (module, (lib, fn)) in turns, twice."""
    times = {n: [] for n in libs}
    names = list(libs)
    for name in names + names[::-1]:
        use(*libs[name])
        times[name].append(timer(lambda: call(libs[name][0]), iters))
    return times


def per_launch(prof):
    return "; ".join(f"{k[:60]} {ms / n:.4f} ms ({n} launches)" for k, ms, n in prof["top"])


def decode_cases(gen, labels=None):
    """K2's bf16 shapes on the serving paths, {label: ((q, cache_k, cache_v,
    lengths), args)}: gemma2-2b's last decode step on a local and a global
    layer (G 2, softcap 50), each zoo path's last step that phase 6 times
    (``chip_smoke.ZOO_DECODE``: granite-moe at D 64, qwen3, nemotron,
    command-r and arctic at D 128, recurrentgemma's wrapped 2,048-slot
    ring at G 16), and the frontends' steps (seamless's cross step at D 64,
    paligemma's last step), every slot valid, no softcap."""
    import torch
    _, decode = C.main_path_inputs(torch.bfloat16, gen)
    cases = {kind: (decode[kind], dict(scale=C.SCALE, softcap=50.0))
             for kind in ("local", "global")}
    for name, b, sq, steps, hq, hkv, d, scale, window in C.zoo_paths():
        if name in C.ZOO_DECODE:
            s = min(sq + steps, window or sq + steps)
            dq = torch.randn(b, 1, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
            ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
            cases[name] = ((dq, ck, cv, lens), dict(scale=scale, softcap=0.0))
    for name, call, kernel, shape, scale in C.frontend_calls():
        if kernel == "decode_attn" and (name, call) in C.FRONTEND_TIMED:
            *inputs, args = C.frontend_inputs(kernel, shape, scale, torch.bfloat16, gen)
            cases[f"{name} {call}"] = (tuple(inputs), args)
    if labels:
        missing = set(labels) - set(cases)
        if missing:
            raise SystemExit(f"--cases: no K2 case {sorted(missing)}; have {sorted(cases)}")
        cases = {k: v for k, v in cases.items() if k in labels}
    return cases


def time_decode(libs_k2, card, profile, labels=None):
    """K2 at the serving shapes (``decode_cases``): events (host launch cost
    included), a CUDA graph (device time) and the host's time a call, each
    library in turns."""
    import torch
    from repro_torch.kernels.decode_attn import ops as DO
    gen = torch.Generator(device="cuda").manual_seed(2)
    for kind, ((dq, ck, cv, lens), args) in decode_cases(gen, labels).items():
        ref = DO.decode_attention_plain(dq, ck, cv, lens, **args).float()
        atol, rtol, _ = C.TOL["bfloat16"]["decode_attn"]
        limit = atol + rtol * ref.abs()
        errs = {}
        for name, (mod, entry) in libs_k2.items():
            use(mod, entry)
            out = mod.decode_attention_cuda(dq, ck, cv, lens, **args).float()
            errs[name] = ((out - ref).abs() / limit).max().item()

        def call(m):
            return m.decode_attention_cuda(dq, ck, cv, lens, **args)

        events = time_in_turns(libs_k2, call, 50, lambda f, n: C.cuda_ms(f, n, warmup=5))
        graph = time_in_turns(libs_k2, call, 100, C.graph_ms)
        host = time_in_turns(libs_k2, call, 200, host_us)
        plain = C.cuda_ms(lambda: DO.decode_attention_plain(dq, ck, cv, lens, **args), 10)
        lib = None
        try:
            fn, _ = C.library_flash(dq, ck, cv, 0, lengths=lens, scale=args["scale"],
                                    cap=args["softcap"])
            fn()
            lib = C.cuda_ms(fn, 50, warmup=5)
        except Exception as e:  # the yardstick only
            C.log(f"  flex_attention unavailable ({type(e).__name__}: {e})")
        b_ms, by = C.bound_ms(*C.decode_bound(dq, ck, lens))
        C.log(f"decode_attn {kind}: bound {b_ms:.4f} ms ({by}), plain {plain:.4f} ms, "
              f"flex_attention {lib} ms; {card}")
        for name in libs_k2:
            e, g, h = events[name], graph[name], host[name]
            C.log(f"  {name:24s} events {e[0]:.4f} / {e[1]:.4f} ms ({b_ms / min(e):.3f} of the "
                  f"bound), graph {g[0]:.4f} / {g[1]:.4f} ms ({b_ms / min(g):.3f}), host "
                  f"{h[0]:.1f} / {h[1]:.1f} us a call, |err|/limit {errs[name]:.3g}")
        if "kernel" in libs_k2:
            use(*libs_k2["kernel"])
            C.log("  the current wrapper's host us a call: " + ", ".join(
                f"{k} {v:.1f}" for k, v in host_breakdown(dq, ck, cv, lens, args).items()))
        if profile:
            for name, (mod, entry) in libs_k2.items():
                use(mod, entry)
                prof = C.device_profile(lambda: [call(mod) for _ in range(5)])
                C.log(f"  {name}: 5 calls under the profiler, device ms a launch: "
                      + per_launch(prof))
    torch.cuda.empty_cache()


def time_gather(libs_k1, card, profile, shapes):
    """K1 at each (label, trace scale, c_main, c_iso): exactness, events in
    turns, and with ``profile`` the device time of each of its kernels."""
    import torch
    from repro_torch.kernels.ciao_gather import ops as CO
    if not libs_k1:
        return
    for label, scale, c_main, c_iso in shapes:
        table, idx, st, isos = gather_inputs(scale)
        for iso_label, iso in isos.items():
            ref_out, ref_stats = CO.ciao_gather_plain(table, idx, st, iso, c_main=c_main,
                                                      c_iso=c_iso)
            exact = {}
            for name, (mod, entry) in libs_k1.items():
                use(mod, entry)
                out, stats = mod.ciao_gather_cuda(table, idx, st, iso, c_main=c_main,
                                                  c_iso=c_iso)
                exact[name] = (C.byte_equal(out, ref_out), bool((stats == ref_stats).all()))
            del out, ref_out

            def call(m):
                return m.ciao_gather_cuda(table, idx, st, iso, c_main=c_main, c_iso=c_iso)

            times = time_in_turns(libs_k1, call, 20, lambda f, n: C.cuda_ms(f, n, warmup=2))
            lib = [C.cuda_ms(lambda: torch.index_select(table, 0, idx), 20, warmup=2)
                   for _ in range(2)]
            plain = C.cuda_ms(lambda: CO.ciao_gather_plain(table, idx, st, iso, c_main=c_main,
                                                           c_iso=c_iso), 1)
            b_ms, by = C.bound_ms(*C.gather_bound(table, idx, st, iso))
            C.log(f"ciao_gather {label}, {iso_label} ({len(idx)} requests, c_main {c_main}, "
                  f"c_iso {c_iso}): bound {b_ms:.4f} ms ({by}), plain {plain:.2f} ms, "
                  f"index_select {lib[0]:.4f} / {lib[1]:.4f} ms; {card}")
            for name, t in times.items():
                C.log(f"  {name:24s} {t[0]:.4f} / {t[1]:.4f} ms, {b_ms / min(t):.3f} of the "
                      f"bound, rows byte-equal, stats equal {exact[name]}")
            if profile:
                for name, (mod, entry) in libs_k1.items():
                    use(mod, entry)
                    prof = C.device_profile(lambda: [call(mod) for _ in range(5)])
                    C.log(f"  {name}: 5 calls under the profiler, device ms a launch: "
                          + per_launch(prof))
        del table, idx, st, isos
        torch.cuda.empty_cache()


def decode_workload(name):
    """(config, batch, prompt, steps) of ``name``'s serving phase in
    chip_smoke.py: 4 and 4b (BATCH x SEQ, STEPS) for gemma2-2b and
    granite-moe, 4c (ZOO_BATCH x ZOO_SEQ, ZOO_STEPS, with its depth cuts)
    for the others."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if name in ("gemma2-2b", C.GRANITE):
        return cfg, C.BATCH, C.SEQ, C.STEPS
    if name not in C.ZOO_ARCHS:
        raise SystemExit(f"--decode takes gemma2-2b, {C.GRANITE} or {C.ZOO_ARCHS}, not {name}")
    if name in C.DEPTH_CUTS and (name == "arctic-480b" or C.reckoned_peak_gb(
            cfg, C.ZOO_BATCH, C.ZOO_SEQ, C.ZOO_STEPS) > C.PEAK_BUDGET_GB):
        cfg = dataclasses.replace(cfg, num_layers=C.DEPTH_CUTS[name])
    return cfg, C.ZOO_BATCH, C.ZOO_SEQ, C.ZOO_STEPS


def time_decode_steps(libs_k2, card, name="gemma2-2b"):
    """One arch at full width (``decode_workload``): one prefill, then its
    decode steps with each K2 library in turns (in both orders, five times
    over): wall and host CPU ms a step, the host's ms inside the K2 calls,
    and one profiled step of each (device busy ms and K2's device ms). The
    steps write the same cache slots each time, so every turn does the same
    work."""
    import torch
    from repro_torch.kernels.decode_attn import ops as DO
    from repro_torch.models import model as M

    k2_s = []     # host seconds inside each K2 call

    def use_k2(tag):     # the model reaches K2 through ops.kernel
        mod, entry = libs_k2[tag]
        use(mod, entry)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = mod.decode_attention_cuda(*a, **kw)
            k2_s.append(time.perf_counter() - t0)
            return out

        DO.kernel = types.SimpleNamespace(decode_attention_cuda=timed)

    own = DO.kernel
    cfg, batch, seq, n_steps = decode_workload(name)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, g, "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device="cuda")
    logits0, cache, pos = M.prefill(cfg, params, {"tokens": prompts}, max_len=seq + n_steps)
    tok0 = logits0.argmax(-1)[:, None]

    def steps():
        tok = tok0
        for i in range(n_steps):
            step_logits, _ = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
            tok = step_logits.argmax(-1)[:, None]

    names = list(libs_k2)
    for tag in names:
        use_k2(tag)
        steps()
    wall = {n: [] for n in names}
    cpu = {n: [] for n in names}     # this thread's CPU ms a step, before the synchronise
    in_k2 = {n: [] for n in names}   # host ms a step inside the K2 calls
    for tag in (names + names[::-1]) * 5:
        use_k2(tag)
        C.sync()
        k2_s.clear()
        t0, c0 = time.perf_counter(), time.thread_time()
        steps()
        c1 = time.thread_time()
        C.sync()
        wall[tag].append((time.perf_counter() - t0) * 1e3 / n_steps)
        cpu[tag].append((c1 - c0) * 1e3 / n_steps)
        in_k2[tag].append(sum(k2_s) * 1e3 / n_steps)
    C.log(f"decode, {name} bf16 ({cfg.num_layers} layers), batch {batch}, {n_steps} steps "
          f"after a {seq}-token prefill, ms a step in turns; {card}")
    for tag in names:
        use_k2(tag)
        prof = C.device_profile(lambda: M.decode_step(cfg, params, tok0, pos + n_steps, cache),
                                top=64)
        k2 = sum(ms for k, ms, n in prof["top"] if "decode" in k)
        C.log(f"  {tag:24s} wall {', '.join(f'{x:.2f}' for x in wall[tag])} ms a step "
              f"(median {statistics.median(wall[tag]):.2f}); host CPU "
              f"{', '.join(f'{x:.2f}' for x in cpu[tag])} ms a step (median "
              f"{statistics.median(cpu[tag]):.2f}); host in K2 calls "
              f"{', '.join(f'{x:.2f}' for x in in_k2[tag])} ms a step (median "
              f"{statistics.median(in_k2[tag]):.2f}); one step profiled: device busy "
              f"{prof['device_busy_ms']:.3f} ms, K2 {k2:.4f} ms")
        for kname, ms, calls in prof["top"][:6]:
            C.log(f"    {ms:9.4f} ms {calls:4d}x  {kname}")
    DO.kernel = own
    del params, cache
    torch.cuda.empty_cache()


GATHER_PATH = [("gather path", 1.0, 256, 64)]
GATHER_SCALING = [("4x requests", 4.0, 256, 64), ("5120 slots", 1.0, 4096, 1024),
                  ("4x requests, 5120 slots", 4.0, 4096, 1024)]


def build_times(parent: Path) -> None:
    """decode_attn.cu's build time, older revision against current, one nvcc
    at a time so the builds do not share the machine's cores."""
    from repro_torch.kernels import _build
    srcs = {"older": parent / "decode_attn" / "csrc" / "decode_attn.cu",
            "current": _build.source("decode_attn")}
    times = {tag: [] for tag in srcs}
    for tag in ("older", "current", "current", "older"):
        t0 = time.perf_counter()
        build_all({f"decode_attn_build_{tag}": srcs[tag]})
        times[tag].append(time.perf_counter() - t0)
    for tag, ts in times.items():
        C.log(f"decode_attn.cu {tag}: nvcc {', '.join(f'{t:.1f}' for t in ts)} s "
              f"({srcs[tag].resolve().relative_to(ROOT)})")


def time_mma_plans(plans, card, labels=None):
    """The tensor-core consumer's split plan with each set of ``kernel``
    constants in ``plans`` ("NAME=VALUE,NAME=VALUE"), in turns (the plans,
    then reversed)."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    gen = torch.Generator(device="cuda").manual_seed(2)
    sets = {p: dict((k, int(v)) for k, v in (kv.split("=") for kv in p.split(","))) for p in plans}
    keep = {k: getattr(DK, k) for kvs in sets.values() for k in kvs}
    cases = decode_cases(gen, labels or ["recurrentgemma-9b", "paligemma-3b last step"])
    for kind, ((dq, ck, cv, lens), args) in cases.items():
        plain = DO.decode_attention_plain(dq, ck, cv, lens, **args)
        times = {p: [] for p in plans}
        b, s, hkv = dq.shape[0], ck.shape[1], ck.shape[2]
        splits = {}
        for p in list(plans) + list(plans)[::-1]:
            for k, v in sets[p].items():
                setattr(DK, k, v)
            splits[p] = DK.mma_split_plan(b, hkv, s, DK._sm_count(0))
            call = lambda: DK.decode_attention_cuda(dq, ck, cv, lens, **args)  # noqa: E731
            err = C.max_err(call(), plain)
            times[p].append((C.graph_ms(call, 100), C.cuda_ms(call, 50, warmup=5), err))
            for k, v in keep.items():
                setattr(DK, k, v)
        b_ms, by = C.bound_ms(*C.decode_bound(dq, ck, lens))
        C.log(f"K2 mma {kind} (B {b}, S {s}, {dq.shape[2]}/{hkv} heads of {dq.shape[3]}), "
              f"bound {b_ms:.4f} ms ({by}), {card}:")
        for p, ts in times.items():
            C.log(f"  {p} ({splits[p]} splits): graph "
                  f"{', '.join(f'{t[0]:.4f}' for t in ts)} ms; events "
                  f"{', '.join(f'{t[1]:.4f}' for t in ts)} ms; max|err| {max(t[2] for t in ts):.3g}")


def time_split_blocks(values, card):
    """K2's split kernel (f32 queries, a bf16 cache) at the zoo's decode
    shapes at D 64 and 128 with SPLIT_BLOCKS_PER_SM at each of ``values``,
    in turns (values, then reversed): events around 50 calls and a CUDA
    graph of 100, and max |err| against the plain version."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK, ops as DO
    gen = torch.Generator(device="cuda").manual_seed(2)
    keep = DK.SPLIT_BLOCKS_PER_SM
    for name, b, sq, steps, hq, hkv, d, scale, _ in C.zoo_paths():
        if name not in C.ZOO_DECODE or d not in DK.ODD_GROUP_DIMS:
            continue
        s = sq + steps
        dq = torch.randn(b, 1, hq, d, generator=gen, device="cuda")    # f32: the split kernel
        ck, cv = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        args = dict(scale=scale, softcap=0.0)
        plain = DO.decode_attention_plain(dq, ck, cv, lens, **args)
        times = {n: [] for n in values}
        for n in list(values) + list(values)[::-1]:
            DK.SPLIT_BLOCKS_PER_SM = n
            call = lambda: DK.decode_attention_cuda(dq, ck, cv, lens, **args)  # noqa: E731
            err = C.max_err(call(), plain)
            times[n].append((C.cuda_ms(call, 50, warmup=5), C.graph_ms(call, 100), err))
        DK.SPLIT_BLOCKS_PER_SM = keep
        b_ms, by = C.bound_ms(*C.decode_bound(dq, ck, lens))
        C.log(f"K2 {name} (B {b}, S {s}, {hq}/{hkv} heads of {d}), bound {b_ms:.4f} ms ({by}), "
              f"{card}:")
        for n, ts in times.items():
            splits = DK.split_plan(b, hkv, s, DK._sm_count(0), n)
            C.log(f"  {n:2d} blocks an SM ({splits} splits): events "
                  f"{', '.join(f'{t[0]:.4f}' for t in ts)} ms; graph "
                  f"{', '.join(f'{t[1]:.4f}' for t in ts)} ms; max|err| {max(t[2] for t in ts):.3g}")
        del dq, ck, cv


def profile_windows(n: int, labels) -> None:
    """Phase 6's profiler window (``chip_smoke.time_decode``: a spin kernel,
    five K2 calls, 50 ms of host time on each side) ``n`` times at each K2
    case, each after a CUDA graph of the kernel was captured and replayed as
    phase 6 does, in this process; logs how many windows saw no device work
    and how many saw the K2 kernel."""
    import os
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK
    C.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(2)
    teardown = os.environ.get("TEARDOWN_CUPTI", "unset")
    for kind, ((dq, ck, cv, lens), args) in decode_cases(gen, labels).items():
        def k2():
            return DK.decode_attention_cuda(dq, ck, cv, lens, **args)

        def window():
            time.sleep(0.05)
            torch.cuda._sleep(1_000_000)
            for _ in range(5):
                k2()
            C.sync()
            time.sleep(0.05)

        C.graph_ms(k2, 100)
        empty = seen = 0
        names = set()
        for _ in range(n):
            prof = C.device_profile(window)
            empty += not prof["top"]
            seen += C.k2_path(prof) is not None
            names |= {name for name, _, _ in prof["top"] if "decode" in name}
        C.log(f"profiler windows, TEARDOWN_CUPTI={teardown}, K2 {kind}: {n} windows, {empty} "
              f"saw no device work, {seen} saw K2 ({sorted(names)})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", nargs="*", metavar="KERNEL")
    ap.add_argument("--broken", nargs="*", metavar="KERNEL")
    ap.add_argument("--variants", nargs="*", metavar="NAME")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--source", action="append", default=[], metavar="KERNEL:NAME=PATH")
    ap.add_argument("--decode", nargs="*", metavar="ARCH")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--build-times", type=Path, metavar="DIR")
    ap.add_argument("--split-blocks", type=int, nargs="+", metavar="N")
    ap.add_argument("--cases", nargs="+", metavar="LABEL")
    ap.add_argument("--mma-plans", nargs="+", metavar="NAME=VALUE[,NAME=VALUE]")
    ap.add_argument("--profile-windows", type=int, metavar="N")
    ap.add_argument("--profile-windows-one", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--broken-one", nargs=2, metavar=("KERNEL", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.broken_one:
        run_broken_one(args.broken_one[0], Path(args.broken_one[1]))
        return
    if args.profile_windows_one:
        profile_windows(args.profile_windows_one, args.cases)
        return
    if args.decode is not None and not args.parent:
        ap.error("--decode needs --parent")
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        C.fail("no CUDA device")
    card = C.card_line()
    C.log(card)
    OUT.mkdir(parents=True, exist_ok=True)
    if args.check is not None:
        C.build_kernels()
        _, failed = C.check_kernels(only=tuple(args.check) or C.KERNELS)
        C.log(f"phase 2: {len(failed)} checks fail: {failed}")
    if args.broken is not None:
        run_broken(args.broken)
    if args.build_times:
        build_times(args.build_times)
    if args.split_blocks:
        C.build_kernels()
        time_split_blocks(args.split_blocks, card)
    if args.mma_plans:
        C.build_kernels()
        time_mma_plans(args.mma_plans, card, args.cases)
    if args.profile_windows:
        import os
        for teardown in (None, "0"):
            env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
            if teardown is not None:
                env["TEARDOWN_CUPTI"] = teardown
            proc = subprocess.run([sys.executable, __file__, "--profile-windows-one",
                                   str(args.profile_windows), *(["--cases", *args.cases]
                                                                if args.cases else [])],
                                  env=env, capture_output=True, text=True)
            C.log((proc.stdout + proc.stderr[-2000:]).strip())
    if not (args.variants is not None or args.parent or args.source or args.scaling):
        return
    mods = wrappers()
    sources, planned = {}, {}     # library key -> (kernel, tag, wrapper module)
    for kernel, name, ok, edits in [v for v in VARIANTS if (
            v[1] in args.variants if args.variants else
            args.variants is not None or v[1] == "kernel")]:
        path = OUT / f"{kernel}_{name}.cu"
        path.write_text(edited(_build.source(kernel).read_text(), edits))
        sources[path.stem] = path
        planned[path.stem] = (kernel, name if ok else f"{name} (wrong on purpose)", mods[kernel])
    if args.parent:
        for kernel in ("decode_attn", "ciao_gather"):
            sources[f"{kernel}_parent"] = args.parent / kernel / "csrc" / f"{kernel}.cu"
            planned[f"{kernel}_parent"] = (kernel, "parent", load_module(
                args.parent / kernel / "kernel.py", f"parent_{kernel}"))
    for spec in args.source:
        kernel, rest = spec.split(":", 1)
        name, path = rest.split("=", 1)
        sources[f"{kernel}_{name}"] = Path(path)
        planned[f"{kernel}_{name}"] = (kernel, name, mods[kernel])
    t0 = time.perf_counter()
    built = build_all(sources)
    C.log(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    for key, so in built.items():
        if planned[key][0] == "decode_attn":
            C.log(f"  ptxas -v, {key}: " + "; ".join(
                f"{name} {items}" for name, items in
                C.ptxas_report(so.with_suffix(".log").read_text()).items()
                if "decode_ring_kernel" in name))
    libs = {"decode_attn": {}, "ciao_gather": {}}
    for key, (kernel, tag, mod) in planned.items():
        libs[kernel][tag] = (mod, bind(mod, built[key]))
    profile = bool(args.parent or args.source)
    time_decode(libs["decode_attn"], card, profile, args.cases)
    time_gather(libs["ciao_gather"], card, profile,
                GATHER_PATH + (GATHER_SCALING if args.scaling else []))
    if args.decode is not None:
        archs = [a for name in args.decode or ["gemma2-2b"]
                 for a in ((C.GRANITE,) + C.ZOO_ARCHS if name == "zoo" else (name,))]
        for arch in archs:
            time_decode_steps({tag: lib for tag, lib in libs["decode_attn"].items()
                               if "wrong" not in tag}, card, arch)
    C.log(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    C.log(card)


if __name__ == "__main__":
    main()
