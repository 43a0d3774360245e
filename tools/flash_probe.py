#!/usr/bin/env python3
"""Probe what holds the bf16 flash attention kernel (K3) back on the card.

    python3 tools/flash_probe.py [--source NAME=PATH ...] [--prefill] [--timeline]

There is no ncu on the card's machine, so this measures by difference. It
builds variants of ``src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu``
(the source with a few text edits, or another source given with
``--source``, e.g. an older revision of the file) into ``build/probe/``, one
nvcc each, in parallel, and times each at gemma2-2b's prefill shapes (bf16,
4 x 4608 tokens, 8 q / 4 kv heads of 256, softcap 50; local window 4096 and
global) in turns, beside the plain version and ``flex_attention``. Each
variant's error against the plain version is printed in units of
``chip_smoke.TOL``: the variants marked "wrong" leave out part of the work on
purpose and only say what that part costs.

--prefill   full-width gemma2-2b prefill with each extra source and the
            kernel in turns, and a torch.profiler breakdown of each;
--timeline  the kernel and the no-softmax variant again with clock64 stamps
            in the consumer loop of one block (the longest q-block of head
            0), printed as mean cycles of each phase of a step.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as C  # noqa: E402
from probe_util import OUT, build_all, edited  # noqa: E402

NO_SOFTMAX = ('''  if (mask)
    softmax_tile<CAP, true>(s, mul, cap2, kt, c0, ra, Skv, causal, window, prefix, m, corr, psum);
  else
    softmax_tile<CAP, false>(s, mul, cap2, kt, c0, ra, Skv, causal, window, prefix, m, corr,
                             psum);''',
              "  corr[0] = corr[1] = 1.f; psum[0] = psum[1] = 1.f;")
# (name, right function?, edits)
VARIANTS = [
    ("kernel", True, []),
    ("no_softmax", False, [NO_SOFTMAX]),
    ("no_loads", False, [("        mbar_expect_tx(full, T::BYTES);\n",
                          "        if (i >= kStages) { mbar_arrive(full); return; }\n"
                          "        mbar_expect_tx(full, T::BYTES);\n")]),
    ("no_pingpong", True, [("named_sync(1 + cw);", "", 3), ("named_arrive(2 - cw);", "", 2),
                           ("if (cw == 1) named_arrive(1);", ""),
                           ("if (cw == 0) named_arrive(2);", "")]),
    ("forward_order", True, [("const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;",
                              "const int q0 = blockIdx.y * kBQ;")]),
    ("mask_every_tile", True, [("    auto masked = [&](int k0) {\n",
                                "    auto masked = [&](int k0) {\n      return true;\n")]),
    ("rescale_every_tile", True, [
        ("const bool grow = mx[r] - m[r] > kRegrow;", "const bool grow = true;"),
        ("if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))", "if (true)")]),
    ("rcp_as_fmul", False, [("rcp(ex2(x * mul) + 1.f)", "((ex2(x * mul) + 1.f) * 0.5f)")]),
]
STAMPS = [  # (anchor, replacement, count): clock64 stamps for --timeline
    ("namespace {\n", "namespace {\n__device__ long long g_stamp[2 * 80 * 8];\n"
     "#define STAMP(k) do { if (probe && tid == 0 && i < 80) { long long c_; asm volatile("
     "\"mov.u64 %0, %%clock64;\" : \"=l\"(c_) :: \"memory\"); "
     "g_stamp[(cw * 80 + i) * 8 + (k)] = c_; } } while (0)\n", 1),
    ("    const uint32_t sQw = sQ + cw * T::BYTES;\n",
     "    const uint32_t sQw = sQ + cw * T::BYTES;\n"
     "    const bool probe = blockIdx.x == 0 && blockIdx.y == 0;\n", 1),
    ("        mbar_wait(full_k(sk), (i / kStages) & 1);\n",
     "        STAMP(0);\n        mbar_wait(full_k(sk), (i / kStages) & 1);\n", 1),
    ("        named_sync(1 + cw);\n        wgmma_fence();\n"
     "        gemm_qk<D>(s, sQw, sK + sk * T::BYTES);\n",
     "        STAMP(1);\n        named_sync(1 + cw);\n        STAMP(2);\n        wgmma_fence();\n"
     "        gemm_qk<D>(s, sQw, sK + sk * T::BYTES);\n", 1),
    ("        named_arrive(2 - cw);\n        wgmma_wait<1>();\n        pin(s);\n",
     "        named_arrive(2 - cw);\n        STAMP(3);\n        wgmma_wait<1>();\n        pin(s);\n"
     "        STAMP(4);\n", 1),
    ("        wgmma_wait<0>();\n        pin(acc);\n        pin(p);\n"
     "        if (tid == 0) mbar_arrive(empty_v(sv));\n",
     "        STAMP(5);\n        wgmma_wait<0>();\n        pin(acc);\n        pin(p);\n"
     "        STAMP(6);\n"
     "        if (tid == 0) mbar_arrive(empty_v(sv));\n", 1),
    ("        to_p(s, p);\n      }\n", "        to_p(s, p);\n        STAMP(7);\n      }\n", 1),
]
STAMP_READ = ('\nextern "C" int flash_probe_read(void* host) {\n'
              "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n")
PHASES = ["wait for K and V", "wait for the turn", "issue", "wait for QK", "softmax",
          "wait for PV", "rescale"]


def build_libs(sources):
    """{name: path.cu} -> {name: (lib, launch fn)}, one nvcc each, in parallel."""
    libs = {}
    for name, so in build_all(sources).items():
        lib = ctypes.CDLL(str(so))
        fn = lib.flash_attn_launch
        # an older revision of the source has no prefix argument
        prefix = "int prefix, int dtype" in Path(sources[name]).read_text()
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * (4 if prefix else 3) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (lib, fn if prefix else (lambda f: lambda *a: f(*a[:14], *a[15:]))(fn))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as FK, ops as FO
    if not torch.cuda.is_available():
        C.fail("no CUDA device")
    card = C.card_line()
    C.log(card)
    OUT.mkdir(parents=True, exist_ok=True)
    good = _build.source("flash_attn").read_text()
    sources, right = {}, {}
    for name, ok, edits in VARIANTS:
        (OUT / f"{name}.cu").write_text(edited(good, edits))
        sources[name], right[name] = OUT / f"{name}.cu", ok
    extra = dict(s.split("=", 1) for s in args.source)
    for name, path in extra.items():
        sources[name], right[name] = Path(path), True
    if args.timeline:
        for name in ("kernel", "no_softmax"):
            src = edited((OUT / f"{name}.cu").read_text(), STAMPS) + STAMP_READ
            (OUT / f"{name}_stamped.cu").write_text(src)
            sources[f"{name}_stamped"] = OUT / f"{name}_stamped.cu"
    t0 = time.perf_counter()
    libs = build_libs(sources)
    C.log(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")

    def use(name):
        FK._entry = lambda: libs[name]

    timed = [n for n in libs if not n.endswith("_stamped")]
    gen = torch.Generator(device="cuda").manual_seed(2)
    (q, k, v), _ = C.main_path_inputs(torch.bfloat16, gen)
    for kind, window, cap in (("local", C.WINDOW, 50.0), ("global", 0, 50.0), ("global", 0, 0.0)):
        fa = dict(scale=C.SCALE, causal=True, window=window, softcap=cap)
        ref = FO.flash_attention_plain(q, k, v, **fa).float()
        atol, rtol, ptol = C.TOL["bfloat16"]["flash_attn"]
        pv = FO.flash_attention_plain(q, k, v.abs(), **fa).float()
        limit = atol + rtol * ref.abs() + ptol * pv
        errs = {}
        for name in timed:
            use(name)
            errs[name] = ((FK.flash_attention_cuda(q, k, v, **fa).float() - ref).abs()
                          / limit).max().item()
        del ref, pv, limit
        times = {n: [] for n in timed}
        for name in timed + timed[::-1]:     # in turns, each twice
            use(name)
            times[name].append(C.cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **fa), 10,
                                         warmup=2))
        b_ms, _ = C.bound_ms(*C.flash_bound(q, k, v, window))
        C.log(f"{kind} window {window} softcap {cap}: bound {b_ms:.4f} ms")
        for name in timed:
            tag = "" if right[name] else "  (wrong on purpose)"
            C.log(f"  {name:20s} {times[name][0]:.4f} / {times[name][1]:.4f} ms, "
                  f"{b_ms / min(times[name]):.3f} of the bound, |err|/limit {errs[name]:.3g}{tag}")
        if cap:
            use("kernel")
            plain = C.cuda_ms(lambda: FO.flash_attention_plain(q, k, v, **fa), 2)
            call, _ = C.library_flash(q, k, v, window)
            call()
            lib = [C.cuda_ms(call, 10, warmup=2) for _ in range(2)]
            C.log(f"  {'plain':20s} {plain:.4f} ms; flex_attention {lib[0]:.4f} / {lib[1]:.4f} ms")
    C.log(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())

    if args.timeline:
        for name in ("kernel_stamped", "no_softmax_stamped"):
            use(name)
            FK.flash_attention_cuda(q, k, v, scale=C.SCALE, causal=True, softcap=50.0)
            buf = np.zeros(2 * 80 * 8, np.int64)
            C.sync()
            if libs[name][0].flash_probe_read(ctypes.c_void_p(buf.ctypes.data)):
                C.fail("cannot read the stamps")
            t = buf.reshape(2, 80, 8).astype(np.float64)[:, 4:68]   # steady steps
            C.log(f"timeline {name.removesuffix('_stamped')} (global, softcap 50), cycles a step:")
            for cw in range(2):
                d = np.diff(t[cw], axis=1).mean(0)
                period = np.diff(t[cw, :, 0]).mean()
                C.log(f"  warpgroup {cw}: period {period:.0f}; "
                      + ", ".join(f"{p} {x:.0f}" for p, x in zip(PHASES, d)))
    del q, k, v
    torch.cuda.empty_cache()

    if args.prefill:
        from repro_torch.configs import get_config
        from repro_torch.models import model as M
        cfg = get_config("gemma2-2b")
        g = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(cfg, g, "cuda", torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (C.BATCH, C.SEQ), generator=g, device="cuda")

        def prefill():
            return M.prefill(cfg, params, {"tokens": prompts}, max_len=C.SEQ + C.STEPS)

        names = [*extra, "kernel"]
        use("kernel")
        prefill()
        C.sync()
        wall = {n: [] for n in names}
        for name in (names + names[::-1]) * 2:
            use(name)
            C.sync()
            t0 = time.perf_counter()
            prefill()
            C.sync()
            wall[name].append((time.perf_counter() - t0) * 1e3)
        for name in names:
            use(name)
            prof = C.device_profile(prefill)
            C.log(f"prefill with {name}: {', '.join(f'{x:.1f}' for x in wall[name])} ms; "
                  f"device busy {prof['device_busy_ms']:.1f} ms; top kernels:")
            for kname, ms, calls in prof["top"]:
                C.log(f"  {ms:9.3f} ms {calls:5d}x  {kname}")
    C.log(card)


if __name__ == "__main__":
    main()
