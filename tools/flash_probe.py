#!/usr/bin/env python3
"""Probe what holds the bf16 flash attention kernel (K3) back on the card.

    python3 tools/flash_probe.py [--check] [--source NAME=PATH ...] [--shapes GROUP ...]
                                 [--only NAME ...] [--library] [--turns N]
                                 [--prefill [ARCH ...]] [--timeline]

There is no ncu on the card's machine, so this measures by difference. It
builds variants of ``src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu``
(the source with a few text edits, or another source given with
``--source``, e.g. the parent revision of the file) into ``build/probe/``,
one nvcc each, in parallel, and times each at the main paths' prefill shapes
in turns (current, others, others reversed, current), by CUDA events around
back-to-back calls and over a CUDA graph of 20 calls (the card's time alone).
Each variant's error against the plain version is printed in units of
``chip_smoke.TOL``: the variants marked "wrong" leave out part of the work on
purpose and only say what that part costs.

Shape groups (``--shapes``, default all):
  gemma2    gemma2-2b's prefill (4 x 4608 tokens, 8 q / 4 kv heads of 256):
            local window 4096 and global with softcap 50, global without;
            recurrentgemma-9b's (4 x 4608, 16 / 1 heads of 256, window
            2048);
  d64       granite-moe-3b-a800m's prefill (4 x 4608 causal, 24 / 8 heads of
            64) and seamless-m4t-medium's encoder (4 x 4096 x 4096,
            non-causal, 16 heads of 64);
  d128      the prefills of qwen3-4b, nemotron-4-15b, command-r-35b and
            arctic-480b (2 x 1024 causal, 32 / 48 / 64 / 56 q on 8 kv heads
            of 128);
  frontend  seamless's cross prefill (Sq 64 against 4096 keys, D 64) and
            self prefill (Sq 64 causal, one key tile), and paligemma-3b's
            prefill (4 x 1024, prefix 256, D 256).

--check     phase 2 of chip_smoke.py for K3 alone (the current source)
            before the variants are built;
--only      time only these variants (and every --source);
--library   flex_attention at each shape too (compiled once a shape);
--turns N   times each variant N times a shape, and each --prefill library
            N times (an even number; default 2), in turns;
--prefill [ARCH ...]
            full-width prefill (gemma2-2b when no ARCH is named; also
            granite-moe-3b-a800m, seamless-m4t-medium) with each extra
            source and the kernel in turns, and a torch.profiler breakdown
            of each;
--timeline  the kernel and the no-softmax variant again with clock64 stamps
            in the consumer loop of one block (the longest q-block of head
            0) at gemma2's global softcap shape, the two d64 shapes and the
            two frontend shapes, printed as mean cycles of each phase of a
            step.
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

NO_SOFTMAX = ("""  if (mask) {
    const int dl[2] = {lo[0] - k0, lo[1] - k0}, dh[2] = {hi[0] - k0, hi[1] - k0};
    softmax_tile<P::BK / 2, CAP, true, P::FOLD>(s, mul, cap2, dl, dh, m, corr, psum);
  } else {
    softmax_tile<P::BK / 2, CAP, false, P::FOLD>(s, mul, cap2, lo, hi, m, corr, psum);
  }""", "  corr[0] = corr[1] = 1.f; psum[0] = psum[1] = 1.f;")
# 2^x on the FMA pipe (16 ex2 a clock on an SM's special-function units,
# 128 FMA-pipe operations): x clamped to -127 (so x <= -127 gives exactly
# +0), split as j + f, j = floor(x) by the rounded-down add of 1.5 * 2^23,
# 2^f by a degree-3 minimax polynomial (relative error < 9e-5), j added to
# the exponent field. The emu variants compute that many of every 8
# exponentials of a tile with it.
EX2_FMA = """__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float t = __fadd_rd(x, 12582912.f);
  const float f = x - (t - 12582912.f);
  float p = fmaf(0.077119089663028717041015625f, f, 0.227564394474029541015625f);
  p = fmaf(p, f, 0.695146143436431884765625f);
  p = fmaf(p, f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

"""


def emu(n):
    """n of every 8 exponentials of a tile on the FMA pipe, at every D."""
    return [("// wgmma shared-memory descriptor", EX2_FMA + "// wgmma shared-memory descriptor"),
            ("    s[i] = ex2(e);\n", f"    s[i] = (i & 7) < {n} ? ex2_fma(e) : ex2(e);\n")]



def source_plan(src, d):
    """{field: text} of ``Plan<d>`` in the source (the primary template's
    where d has no specialisation)."""
    import re
    blocks = {m.group(1): m.group(2)
              for m in re.finditer(r"struct Plan(?:<(\d+)>)? \{(.*?)\};", src, re.S)}
    return dict(re.findall(r"(\w+) = (\w+)", blocks.get(str(d), blocks[None])))


def plan(d, **changes):
    """An edit giving head dim d the source's plan for d with ``changes``
    (lower-case field names): a specialisation of its own after D 64's, or
    D 64's own rewritten."""
    def edits(src):
        fields = source_plan(src, d)
        fields.update({k.upper(): str(v).lower() for k, v in changes.items()})
        body = (f"  static constexpr int BK = {fields['BK']}, NWG = {fields['NWG']};\n"
                f"  static constexpr bool FOLD = {fields['FOLD']}, SPLIT = {fields['SPLIT']};\n")
        block = src[src.index("struct Plan<64> {\n"):]
        block = block[:block.index("};\n") + 3]
        if d == 64:
            return [(block, "struct Plan<64> {\n" + body + "};\n")]
        old = src[src.index("struct Plan<" + str(d) + "> {\n"):] if \
            f"struct Plan<{d}> {{" in src else None
        if old is not None:
            old = old[:old.index("};\n") + 3]
            return [(old, f"struct Plan<{d}> {{\n" + body + "};\n")]
        return [(block, block + f"template <>\nstruct Plan<{d}> {{\n" + body + "};\n")]
    return edits


# Each block loads its Q and runs its epilogue (and, under key splits, its
# merge), but no KV tile: the producer issues no K or V load and the
# consumers wait for Q alone.
NO_TILES = [("      if (it.nb > 0) load(&tm_k, sK, true, 0);\n"
             "      for (int i = 0; i < it.nb; ++i) {\n",
             "      for (int i = 0; i < 0; ++i) {\n"),
            ("    const int cnt = it.nb > i0 ? (it.nb - i0 + di - 1) / di : 0;\n",
             "    const int cnt = 0;\n")]
# The epilogue stages O / l in shared memory but stores no row.
NO_STORE = ("        tma_store(&tm_o, sQw + c * T::Q_CHUNK_B, c * T::CW, it.h, rmin, it.b);\n",
            "        if (false) tma_store(&tm_o, sQw + c * T::Q_CHUNK_B, c * T::CW, it.h, rmin, "
            "it.b);\n")
# Each block runs only the first of its KV tiles.
ONE_TILE = [("  it.nb = (hi - lo + kBK - 1) / kBK;", "  it.nb = min(1, (hi - lo + kBK - 1) / kBK);")]
# The split launch at Sq <= 64 under D 64's plan.
SPLIT_IF = "    if (Sq <= kWgRows) return launch_wgmma_mode<D, CAP, 2, kSplit>(MODE_ARGS);\n"


# (name, right function?, edits or a function of the source giving them)
VARIANTS = [
    ("kernel", True, []),
    ("no_softmax", False, [NO_SOFTMAX]),
    # the softmax without its exponentials (p = the exponent), without the
    # bf16 packs of p (zeros), and without the O rescale and its warp vote
    ("no_ex2", False, [("    s[i] = ex2(e);\n", "    s[i] = e;\n")]),
    ("no_pack", False, [("p[ks][j] = pack_bf16(s[8 * ks + 2 * j], s[8 * ks + 2 * j + 1]);",
                         "p[ks][j] = 0u;")]),
    ("no_rescale_test", False, [
        ("if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f))", "if (false)")]),
    ("mask_every_tile", True, [("    auto masked = [&](int k0) {\n",
                                "    auto masked = [&](int k0) {\n      return true;\n")]),
    # D 64's and D 128's plans, one choice changed at a time, and what D 128
    # and 256 would take of them
    ("d64_nwg2", True, plan(64, nwg=2)),
    ("d64_bk64", True, plan(64, bk=64)),
    ("d64_nofold", True, plan(64, fold=False)),
    ("d128_bk64", True, plan(128, bk=64)),
    ("d128_nwg3_bk64", True, plan(128, nwg=3, bk=64)),
    ("d256_fold", True, plan(256, fold=True)),
    # the ring's depth (not at D 256: 3 stages of 32 KB tiles overflow
    # shared memory) and the turns between warpgroups, at every D
    ("stages3", True, [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    ("no_pingpong", True, [("if (!kSplitMode) named_sync(1 + cw);", "", 3),
                           ("if (!kSplitMode && cw != kNWG - 1) named_arrive(next);", ""),
                           ("if (!kSplitMode) named_arrive(next);", "", 2),
                           ("if (!kSplitMode && cw == kNWG - 1) named_arrive(1);", "")]),
    # exponentials on the FMA pipe
    ("emu1", True, emu(1)),
    ("emu2", True, emu(2)),
    # a block's fixed costs: launch, setup, the Q load and the epilogue
    # (no_tiles: no KV tile at all), and those with one tile (one_tile)
    ("no_tiles", False, NO_TILES),
    ("one_tile", False, ONE_TILE),
    # the epilogue's stores left out, with and without the tiles
    ("no_store", False, [NO_STORE]),
    ("no_tiles_no_store", False, NO_TILES + [NO_STORE]),
    # the split launch (Sq <= 64 at D 64) left out (one block of two
    # warpgroups, the second on rows past Sq), and run with a ring of 2
    # stages (one a warpgroup)
    ("no_split", True, [(SPLIT_IF, "")]),
    ("split_stages2", True, [("constexpr int kSplitStages = 4;", "constexpr int kSplitStages = 2;")]),
]
NSTAMP = 128     # steps stamped a warpgroup
STAMPS = [  # (anchor, replacement, count): clock64 stamps for --timeline
    ("namespace {\n", "namespace {\n__device__ long long g_stamp[3 * 128 * 8];\n"
     "#define STAMP(k) do { if (probe && tid == 0 && v < 128) { long long c_; asm volatile("
     "\"mov.u64 %0, %%clock64;\" : \"=l\"(c_) :: \"memory\"); "
     "g_stamp[(cw * 128 + v) * 8 + (k)] = c_; } } while (0)\n", 1),
    # block 0
    ("    const int cnt = it.nb > i0 ? (it.nb - i0 + di - 1) / di : 0;\n",
     "    const int cnt = it.nb > i0 ? (it.nb - i0 + di - 1) / di : 0;\n"
     "    const bool probe = blockIdx.x == 0;\n", 1),
    ("        mbar_wait(full_k(sk), (rk / kST) & 1);\n",
     "        STAMP(0);\n        mbar_wait(full_k(sk), (rk / kST) & 1);\n", 1),
    ("        if (!kSplitMode) named_sync(1 + cw);\n        wgmma_fence();\n"
     "        gemm_qk<D>(s, sQw, sK + sk * T::KV_BYTES);\n",
     "        STAMP(1);\n        if (!kSplitMode) named_sync(1 + cw);\n        STAMP(2);\n"
     "        wgmma_fence();\n        gemm_qk<D>(s, sQw, sK + sk * T::KV_BYTES);\n", 1),
    ("        if (!kSplitMode) named_arrive(next);\n        wgmma_wait<1>();\n"
     "        pin(s);\n",
     "        if (!kSplitMode) named_arrive(next);\n        STAMP(3);\n"
     "        wgmma_wait<1>();\n        pin(s);\n        STAMP(4);\n", 1),
    ("        wgmma_wait<0>();\n        pin(acc);\n        pin(p);\n"
     "        if (tid == 0) mbar_arrive(empty_v(sv));\n",
     "        STAMP(5);\n        wgmma_wait<0>();\n        pin(acc);\n        pin(p);\n"
     "        STAMP(6);\n        if (tid == 0) mbar_arrive(empty_v(sv));\n", 1),
    ("        to_p(s, p);\n      }\n", "        to_p(s, p);\n        STAMP(7);\n      }\n",
     1),
]
STAMP_READ = ('\nextern "C" int flash_probe_read(void* host) {\n'
              "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n"
              'extern "C" int flash_probe_reset() {\n'
              "  static long long zeros[3 * 128 * 8];\n"
              "  return (int)cudaMemcpyToSymbol(g_stamp, zeros, sizeof(zeros));\n}\n")
PHASES = ["wait for K and V", "wait for the turn", "issue", "wait for QK", "softmax",
          "wait for PV", "rescale"]
GROUPS = ("gemma2", "d64", "d128", "frontend")


def probe_shapes(groups):
    """[(label, group, (b, sq, skv, hq, hkv, d), K3's keyword arguments)] at
    the main paths' prefill shapes, as chip_smoke.py's phases 2 and 6 take
    them."""
    out = []
    if "gemma2" in groups:
        dims = (C.BATCH, C.SEQ, C.SEQ, 8, 4, 256)
        for label, window, cap in (("gemma2 local cap 50", C.WINDOW, 50.0),
                                   ("gemma2 global cap 50", 0, 50.0),
                                   ("gemma2 global", 0, 0.0)):
            out.append((label, "gemma2", dims,
                        dict(scale=C.SCALE, causal=True, window=window, softcap=cap)))
    paths = {name: rest for name, *rest in C.zoo_paths()}
    for name, group in ((C.GRANITE, "d64"), *((a, "d128") for a in C.ZOO_ARCHS),
                        (C.RECURRENTGEMMA, "gemma2")):
        if group not in groups:
            continue
        b, sq, _, hq, hkv, d, scale, window = paths[name]
        out.append((f"{name} prefill", group, (b, sq, sq, hq, hkv, d),
                    dict(scale=scale, causal=True, window=window, softcap=0.0)))
    for name, call, kernel, shape, scale in C.frontend_calls():
        group = {(C.SEAMLESS, "encoder"): "d64", (C.SEAMLESS, "cross prefill"): "frontend",
                 (C.SEAMLESS, "self prefill"): "frontend",
                 (C.PALIGEMMA, "prefill"): "frontend"}.get((name, call))
        if group in groups:
            b, sq, skv, hq, hkv, d, causal, prefix = shape
            out.append((f"{name} {call}", group, (b, sq, skv, hq, hkv, d),
                        dict(scale=scale, causal=causal, prefix_len=prefix, softcap=0.0)))
    # D 256 last: a variant that cannot launch there (its ring overflows
    # shared memory) leaves that error in its library's CUDA runtime, which
    # the library's next launch would report as its own
    return sorted(out, key=lambda s: s[2][5] == 256)


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


def errors_against_plain(outs, q, k, v, args):
    """{name: max |out - ref| / limit} over the batch, with the plain version
    (and |p| @ |v| for the tolerance's p term) a batch row at a time."""
    import torch
    from repro_torch.kernels.flash_attn import ops as FO
    atol, rtol, ptol = C.TOL["bfloat16"]["flash_attn"]
    errs = dict.fromkeys(outs, 0.0)
    for i in range(q.shape[0]):
        row = (q[i:i + 1], k[i:i + 1])
        ref = FO.flash_attention_plain(*row, v[i:i + 1], **args).float()
        limit = atol + rtol * ref.abs() + ptol * FO.flash_attention_plain(
            *row, v[i:i + 1].abs(), **args).float()
        for name, out in outs.items():
            e = ((out[i:i + 1].float() - ref).abs() / limit).max().item()
            errs[name] = max(errs[name], e if e == e else float("inf"))
        del ref, limit
    torch.cuda.empty_cache()
    return errs


def time_shape(label, dims, args, gen, timed, right, use, library, turns):
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    b, sq, skv, hq, hkv, d = dims
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, skv, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    outs = {}
    for name in timed:
        use(name)
        try:
            outs[name] = FK.flash_attention_cuda(q, k, v, **args)
        except RuntimeError as e:   # a variant whose ring does not fit at this D
            C.log(f"  {name} does not launch at {label}: {e}")
    timed = list(outs)
    errs = errors_against_plain(outs, q, k, v, args)
    del outs
    ev = {n: [] for n in timed}
    gr = {n: [] for n in timed}
    for name in (timed + timed[::-1]) * (turns // 2):     # in turns
        use(name)
        ev[name].append(C.cuda_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 10,
                                  warmup=2))
        gr[name].append(C.graph_ms(lambda: FK.flash_attention_cuda(q, k, v, **args), 20))
    window = args.get("window", 0)
    b_ms, by = C.bound_ms(*C.flash_bound(q, k, v, window, args["causal"],
                                         args.get("prefix_len", 0)))
    C.log(f"{label} (B {b}, Sq {sq}, Skv {skv}, {hq}/{hkv} heads of {d}, {args}): "
          f"bound {b_ms:.4f} ms ({by})")
    for name in timed:
        tag = "" if right[name] else "  (wrong on purpose)"
        C.log(f"  {name:22s} graph {' / '.join(f'{x:.4f}' for x in gr[name])} ms, events "
              f"{' / '.join(f'{x:.4f}' for x in ev[name])} ms, {b_ms / min(gr[name]):.3f} of "
              f"the bound, |err|/limit {errs[name]:.3g}{tag}")
    if library:
        try:
            call, _ = C.library_flash(q, k, v, window, scale=args["scale"],
                                      cap=args["softcap"], causal=args["causal"],
                                      prefix=args.get("prefix_len", 0))
            call()
            lib = [C.cuda_ms(call, 10, warmup=2) for _ in range(2)]
            C.log(f"  {'flex_attention':22s} {lib[0]:.4f} / {lib[1]:.4f} ms")
        except Exception as e:  # the yardstick only
            C.log(f"  flex_attention unavailable ({type(e).__name__}: {e})")
    del q, k, v
    torch.cuda.empty_cache()


def timeline(libs, gen, use):
    """Mean cycles of each phase of a consumer step in one block, from the
    clock64 stamps of the *_stamped libraries."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import kernel as FK
    shapes = [s for s in probe_shapes(("gemma2", "d64", "frontend"))
              if s[0] != "gemma2 local cap 50" and s[0] != "gemma2 global"]
    for label, _, (b, sq, skv, hq, hkv, d), args in shapes:
        q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, skv, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        for name in ("kernel_stamped", "no_softmax_stamped"):
            use(name)
            if libs[name][0].flash_probe_reset():
                C.fail("cannot reset the stamps")
            FK.flash_attention_cuda(q, k, v, **args)
            buf = np.zeros(3 * NSTAMP * 8, np.int64)
            C.sync()
            if libs[name][0].flash_probe_read(ctypes.c_void_p(buf.ctypes.data)):
                C.fail("cannot read the stamps")
            t = buf.reshape(3, NSTAMP, 8).astype(np.float64)
            steps = int((t[0, :, 7] > 0).sum())
            t = t[:, 4:max(steps - 4, 5)]       # steady steps
            C.log(f"timeline {name.removesuffix('_stamped')} at {label} ({steps} steps "
                  f"stamped), cycles a step:")
            for cw in range(3):
                if not t[cw].any():
                    continue
                dd = np.diff(t[cw], axis=1).mean(0)
                period = np.diff(t[cw, :, 0]).mean()
                C.log(f"  warpgroup {cw}: period {period:.0f}; "
                      + ", ".join(f"{p} {x:.0f}" for p, x in zip(PHASES, dd)))
        del q, k, v
        torch.cuda.empty_cache()


def time_prefill(arch, names, use, turns):
    """Full-width prefill of ``arch`` at chip_smoke.py's workload (gemma2-2b
    and granite-moe-3b-a800m: BATCH x SEQ tokens; seamless-m4t-medium: BATCH
    sources of SRC_LEN frames and DEC_PROMPT-token prompts) with each
    library in ``names`` in turns, ``turns`` times each (at least 2), then a
    torch.profiler breakdown of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    seq, src_len = (C.DEC_PROMPT, C.SRC_LEN) if cfg.is_encoder_decoder else (C.SEQ, 0)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, g, "cuda", torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (C.BATCH, seq), generator=g, device="cuda")
    inputs = {"tokens": prompts,
              **C.frontend_batch(cfg, C.BATCH, src_len, torch.bfloat16, g, "cuda")}

    def prefill():
        return M.prefill(cfg, params, inputs, max_len=M.prompt_len(inputs) + C.STEPS)

    use("kernel")
    prefill()
    C.sync()
    wall = {n: [] for n in names}
    for name in (names + names[::-1]) * max(1, turns // 2):
        use(name)
        C.sync()
        t0 = time.perf_counter()
        prefill()
        C.sync()
        wall[name].append((time.perf_counter() - t0) * 1e3)
    for name in names:
        use(name)
        prof = C.device_profile(prefill)
        C.log(f"{arch} prefill with {name}: {', '.join(f'{x:.1f}' for x in wall[name])} ms; "
              f"device busy {prof['device_busy_ms']:.1f} ms; top kernels:")
        for kname, ms, calls in prof["top"]:
            C.log(f"  {ms:9.3f} ms {calls:5d}x  {kname}")
    del params
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shapes", nargs="+", choices=GROUPS, default=list(GROUPS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", nargs="+", metavar="NAME")
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--prefill", nargs="*", metavar="ARCH")
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as FK
    if not torch.cuda.is_available():
        C.fail("no CUDA device")
    card = C.card_line()
    C.log(card)
    OUT.mkdir(parents=True, exist_ok=True)
    if args.check:
        _, failed = C.check_kernels(only=("flash_attn",))
        C.log(f"phase 2, flash_attn: {len(failed)} checks fail: {failed}")
    good = _build.source("flash_attn").read_text()
    sources, right = {}, {}
    for name, ok, edits in VARIANTS:
        if args.only and name != "kernel" and name not in args.only:
            continue
        (OUT / f"{name}.cu").write_text(edited(good, edits(good) if callable(edits) else edits))
        sources[name], right[name] = OUT / f"{name}.cu", ok
    extra = dict(s.split("=", 1) for s in args.source)
    for name, path in extra.items():
        sources[name], right[name] = Path(path), True
    if args.timeline:
        for name, _, edits in VARIANTS:
            if name in ("kernel", "no_softmax"):
                src = edited(edited(good, edits), STAMPS) + STAMP_READ
                (OUT / f"{name}_stamped.cu").write_text(src)
                sources[f"{name}_stamped"] = OUT / f"{name}_stamped.cu"
    t0 = time.perf_counter()
    libs = build_libs(sources)
    C.log(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        report = C.ptxas_report((OUT / f"lib{name}.log").read_text())
        C.log(f"  ptxas -v, {name}: " + "; ".join(
            f"{k} {v}" for k, v in report.items() if "flash_wgmma_kernel" in k))

    def use(name):
        FK._entry = lambda: libs[name]

    timed = [n for n in libs if not n.endswith("_stamped")]
    timed = ["kernel"] + [n for n in timed if n != "kernel"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, _, dims, fa in probe_shapes(args.shapes):
        time_shape(label, dims, fa, gen, timed, right, use, args.library, args.turns)
    C.log(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    if args.timeline:
        timeline(libs, gen, use)

    if args.prefill is not None:
        for arch in args.prefill or ["gemma2-2b"]:
            time_prefill(arch, [*extra, "kernel"], use, args.turns)
    C.log(card)


if __name__ == "__main__":
    main()
