#!/usr/bin/env python3
"""Check and time the CIAO gather (K1) and decode attention (K2) kernels on the card.

    python3 tools/kernel_probe.py [--check] [--broken] [--variants] [--parent DIR]
                                  [--source KERNEL:NAME=PATH ...] [--decode] [--scaling]

--check     build the kernels and run phase 2 of chip_smoke.py (each kernel
            against its plain version at its grid and edge cases);
--broken    build broken copies of K1, K2 and K3 (text edits of the sources,
            under build/probe/) and run phase 2's checks of that kernel with
            each, printing which checks fail (K3's copy without the K stage
            wait also with a slowed producer, and the slowed producer alone);
--variants  time text-edited variants of both kernels in turns at the main
            paths' shapes; those marked "wrong" leave out part of the work on
            purpose and only say what that part costs;
--parent    DIR is an older revision of src/repro_torch/kernels (for example
            `git archive HEAD~1 src/repro_torch/kernels` unpacked): its
            decode_attn and ciao_gather wrappers, built from its own sources,
            are timed in turns with the current ones, beside the plain
            versions, the library calls and the bounds, with the device
            time of each launch under the profiler;
--source    another source of one kernel (decode_attn or ciao_gather),
            bound through the current wrapper, timed in turns like the
            parent;
--decode    (with --parent) full-width gemma2-2b decode, 32 steps after one
            prefill, with the parent's K2 and the current one in turns, and
            a profiled step of each;
--scaling   K1 at larger traces and caches than the gather path's (4x the
            requests, 4096 + 1024 slots), every K1 library in turns, with
            the device time of each of its kernels.

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
K3_SKIP_K_WAIT = ("        mbar_wait(full_k(sk), (i / kStages) & 1);\n", "")
K3_SLOW_PRODUCER = (
    "        if (i + 1 < n)\n"
    "          load(&tm_k, sK, full_k((i + 1) % kStages), empty_k((i + 1) % kStages), i + 1);\n"
    "        load(&tm_v, sV, full_v(i % kStages), empty_v(i % kStages), i);\n",
    "        load(&tm_v, sV, full_v(i % kStages), empty_v(i % kStages), i);\n"
    "        if (i + 1 < n) {\n"
    "          __nanosleep(20000);\n"
    "          load(&tm_k, sK, full_k((i + 1) % kStages), empty_k((i + 1) % kStages), i + 1);\n"
    "        }\n")
BROKEN = [
    ("flash_attn", "skip_k_stage_wait", [K3_SKIP_K_WAIT]),
    ("flash_attn", "skip_k_stage_wait_slow_producer", [K3_SKIP_K_WAIT, K3_SLOW_PRODUCER]),
    ("flash_attn", "slow_producer_alone_right", [K3_SLOW_PRODUCER]),
    ("decode_attn", "skip_stage1_full_wait", [(
        "      mbar_wait(full0 + 8 * st, (i / kStages) & 1);\n",
        "      if (st != 1) mbar_wait(full0 + 8 * st, (i / kStages) & 1);\n")]),
    ("decode_attn", "drop_last_split", [(
        "    for (int s = 0; s < nsplit; ++s) {\n      const float c = ex2(__ldcg(",
        "    for (int s = 0; s < nsplit - 1; ++s) {\n      const float c = ex2(__ldcg(")]),
    ("ciao_gather", "every_request_a_miss", [(
        "atomicAdd(&cnt[2 * r.z + (r0 + lane == p ? 1 : 0)], 1)",
        "atomicAdd(&cnt[2 * r.z + 1], 1)")]),
    ("ciao_gather", "skip_last_of_run", [(
        "const int m = min(32, q - r0);", "const int m = min(32, q - 1 - r0);")]),
]
VARIANTS = [
    ("decode_attn", "kernel", True, []),
    ("decode_attn", "no_math", False, [("      if (4 * warp < n) {\n", "      if (false) {\n")]),
    ("decode_attn", "rows_only", True, [("      if (n == kTileKeys) {\n", "      if (false) {\n")]),
    ("decode_attn", "no_tiles", False, [(
        "  const int ntiles = (end - start + kTileKeys - 1) / kTileKeys;",
        "  const int ntiles = 0;")]),
    ("decode_attn", "no_split_merge", False, [(
        "  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {\n"
        "    const int g = idx / D, d = idx % D;\n    const size_t row0",
        "  for (int idx = G * D; idx < G * D; idx += blockDim.x) {\n"
        "    const int g = idx / D, d = idx % D;\n    const size_t row0")]),
    ("decode_attn", "stages_2", True, [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    ("decode_attn", "stages_6", True, [("constexpr int kStages = 4;", "constexpr int kStages = 6;")]),
    ("ciao_gather", "kernel", True, []),
    ("ciao_gather", "batch_1", True, [("constexpr int kBatch = 2;", "constexpr int kBatch = 1;")]),
    ("ciao_gather", "batch_4", True, [("constexpr int kBatch = 2;", "constexpr int kBatch = 4;")]),
    ("ciao_gather", "gather_warps_4", True, [("constexpr int kGatherWarps = 8;",
                                              "constexpr int kGatherWarps = 4;")]),
    ("ciao_gather", "no_hit_copies", False, [(
        "          const int m = min(32, q - r0);", "          const int m = r0 == p ? 1 : 0;")]),
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
    spec.loader.exec_module(mod)
    return mod


def wrappers():
    """The current wrapper module of each kernel."""
    from repro_torch.kernels.ciao_gather import kernel as CK
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.flash_attn import kernel as FK
    return {"decode_attn": DK, "ciao_gather": CK, "flash_attn": FK}


def run_broken():
    """Each broken copy in a process of its own: a copy may fail its launch
    (the card's context is lost then), which counts as failing phase 2."""
    from repro_torch.kernels import _build
    sources = {}
    for kernel, name, edits in BROKEN:
        path = OUT / f"{kernel}_{name}.cu"
        path.write_text(edited(_build.source(kernel).read_text(), edits))
        sources[f"{kernel}_{name}"] = path
    built = build_all(sources)
    for kernel, name, _ in BROKEN:
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
    splits = DK.split_plan(b, hkv, s, DK._sm_count(0))
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


def time_decode(libs_k2, card, profile):
    """K2 at the serving shapes: events (host launch cost included), a CUDA
    graph (device time) and the host's time a call, each library in turns."""
    import torch
    from repro_torch.kernels.decode_attn import ops as DO
    gen = torch.Generator(device="cuda").manual_seed(2)
    _, decode = C.main_path_inputs(torch.bfloat16, gen)
    args = dict(scale=C.SCALE, softcap=50.0)
    for kind in ("local", "global"):
        dq, ck, cv, lens = decode[kind]
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
            fn, _ = C.library_flash(dq, ck, cv, 0, lengths=lens)
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
    del decode
    torch.cuda.empty_cache()


def time_gather(libs_k1, card, profile, shapes):
    """K1 at each (label, trace scale, c_main, c_iso): exactness, events in
    turns, and with ``profile`` the device time of each of its kernels."""
    import torch
    from repro_torch.kernels.ciao_gather import ops as CO
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


def time_decode_steps(libs_k2, card):
    """Full-width gemma2-2b: one prefill, then 32 decode steps with each K2
    library in turns (in both orders, five times over): wall and host CPU
    ms a step, the host's ms inside the K2 calls, and one profiled step of
    each. The steps write the same cache slots each time, so every turn
    does the same work."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as DO
    from repro_torch.models import model as M

    k2_s = []     # host seconds inside each K2 call

    def use_k2(name):     # the model reaches K2 through ops.kernel
        mod, entry = libs_k2[name]
        use(mod, entry)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = mod.decode_attention_cuda(*a, **kw)
            k2_s.append(time.perf_counter() - t0)
            return out

        DO.kernel = types.SimpleNamespace(decode_attention_cuda=timed)

    own = DO.kernel
    cfg = get_config("gemma2-2b")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, g, "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (C.BATCH, C.SEQ), generator=g, device="cuda")
    logits0, cache, pos = M.prefill(cfg, params, {"tokens": prompts}, max_len=C.SEQ + C.STEPS)
    tok0 = logits0.argmax(-1)[:, None]

    def steps():
        tok = tok0
        for i in range(C.STEPS):
            step_logits, _ = M.decode_step(cfg, params, tok, pos + 1 + i, cache)
            tok = step_logits.argmax(-1)[:, None]

    names = list(libs_k2)
    for name in names:
        use_k2(name)
        steps()
    wall = {n: [] for n in names}
    cpu = {n: [] for n in names}     # this thread's CPU ms a step, before the synchronise
    in_k2 = {n: [] for n in names}   # host ms a step inside the 26 K2 calls
    for name in (names + names[::-1]) * 5:
        use_k2(name)
        C.sync()
        k2_s.clear()
        t0, c0 = time.perf_counter(), time.thread_time()
        steps()
        c1 = time.thread_time()
        C.sync()
        wall[name].append((time.perf_counter() - t0) * 1e3 / C.STEPS)
        cpu[name].append((c1 - c0) * 1e3 / C.STEPS)
        in_k2[name].append(sum(k2_s) * 1e3 / C.STEPS)
    C.log(f"decode, gemma2-2b bf16, batch {C.BATCH}, {C.STEPS} steps after a {C.SEQ}-token "
          f"prefill, ms a step in turns; {card}")
    for name in names:
        use_k2(name)
        prof = C.device_profile(lambda: M.decode_step(cfg, params, tok0, pos + C.STEPS, cache),
                                top=6)
        k2 = sum(ms for k, ms, n in prof["top"] if "decode" in k)
        C.log(f"  {name:24s} wall {', '.join(f'{x:.2f}' for x in wall[name])} ms a step "
              f"(median {statistics.median(wall[name]):.2f}); host CPU "
              f"{', '.join(f'{x:.2f}' for x in cpu[name])} ms a step (median "
              f"{statistics.median(cpu[name]):.2f}); host in K2 calls "
              f"{', '.join(f'{x:.2f}' for x in in_k2[name])} ms a step (median "
              f"{statistics.median(in_k2[name]):.2f}); one step profiled: device busy "
              f"{prof['device_busy_ms']:.3f} ms, K2 {k2:.4f} ms")
        for kname, ms, calls in prof["top"]:
            C.log(f"    {ms:9.4f} ms {calls:4d}x  {kname}")
    DO.kernel = own
    del params, cache
    torch.cuda.empty_cache()


GATHER_PATH = [("gather path", 1.0, 256, 64)]
GATHER_SCALING = [("4x requests", 4.0, 256, 64), ("5120 slots", 1.0, 4096, 1024),
                  ("4x requests, 5120 slots", 4.0, 4096, 1024)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--broken", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--source", action="append", default=[], metavar="KERNEL:NAME=PATH")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--broken-one", nargs=2, metavar=("KERNEL", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.broken_one:
        run_broken_one(args.broken_one[0], Path(args.broken_one[1]))
        return
    if args.decode and not args.parent:
        ap.error("--decode needs --parent")
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        C.fail("no CUDA device")
    card = C.card_line()
    C.log(card)
    OUT.mkdir(parents=True, exist_ok=True)
    if args.check:
        C.build_kernels()
        _, failed = C.check_kernels()
        C.log(f"phase 2: {len(failed)} checks fail: {failed}")
    if args.broken:
        run_broken()
    if not (args.variants or args.parent or args.source or args.scaling):
        return
    mods = wrappers()
    sources, planned = {}, {}     # library key -> (kernel, tag, wrapper module)
    for kernel, name, ok, edits in VARIANTS if args.variants else \
            [v for v in VARIANTS if v[1] == "kernel"]:
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
    libs = {"decode_attn": {}, "ciao_gather": {}}
    for key, (kernel, tag, mod) in planned.items():
        libs[kernel][tag] = (mod, bind(mod, built[key]))
    profile = bool(args.parent or args.source)
    time_decode(libs["decode_attn"], card, profile)
    time_gather(libs["ciao_gather"], card, profile,
                GATHER_PATH + (GATHER_SCALING if args.scaling else []))
    if args.decode:
        time_decode_steps({tag: lib for tag, lib in libs["decode_attn"].items()
                           if "wrong" not in tag}, card)
    C.log(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    C.log(card)


if __name__ == "__main__":
    main()
