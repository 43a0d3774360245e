#!/usr/bin/env python3
"""The port's dry run against the reference's compiled program, cell by cell.

For each cell (arch x shape x mesh) this tool

  1. compiles the reference's step in a subprocess, as its own dry run does
     (``repro.launch.dryrun.lower_cell(...).compile()``), on a mesh of Auto
     axes of the production shape ((16, 16) or (2, 16, 16)) over 512 host
     devices, and reads XLA's memory analysis and ``hlo_analysis.analyze``
     of the compiled HLO. ``repro.launch.mesh.make_production_mesh`` is not
     used: on jax 0.9 ``jax.make_mesh`` gives Explicit axes, on which the
     reference's sharding constraints raise;
  2. counts the port's same cell (``repro_torch.launch.dryrun``: rank 0 of
     a fake group, meta tensors);
  3. prints both sides and the port's share of the reference's figures.

``--write`` stores both sides' figures in
``src/repro_torch/launch/reference_cells.json``, the port's copy of the
reference's numbers (the card's machine has no JAX): ``run_cell`` adds a
``reference`` block to every cell that the file holds, and
``chip_smoke.py`` holds the card's torch against the port's records there.
``--ops N`` also prints each side's N largest products, collectives and
buffers live at the peak (the reference's from XLA's buffer assignment),
by op and source, and splits gemma2-2b's and the zoo's figures into the
named terms (``terms_for``, their patterns naming each arch's widths from
its config) that ``PERF.md`` quotes and the file keeps; writing those
cells needs it.

All figures are arithmetic on shapes, not measurements. Needs jax and
torch (CPU) and ``PYTHONPATH=src``:

  PYTHONPATH=src python tools/dryrun_vs_ref.py                 # gemma2-2b's six cells
  PYTHONPATH=src python tools/dryrun_vs_ref.py --ops 10 --write
  PYTHONPATH=src python tools/dryrun_vs_ref.py --cells mamba2-2.7b:decode_32k:single --ops 12
  PYTHONPATH=src python tools/dryrun_vs_ref.py --ops 10 --write --cells zoo   # the zoo's twelve
  PYTHONPATH=src python tools/dryrun_vs_ref.py --ops 10 --write --cells all   # all eighteen
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GEMMA2_CELLS = [("gemma2-2b", s, m) for s in ("train_4k", "prefill_32k", "decode_32k")
                for m in ("single", "multi")]
# the figures both sides report, and the ones held side by side
SUMMARY_KEYS = ("flops_per_device", "bytes_per_device", "collective_bytes_effective",
                "collective_total_effective", "collective_num_ops", "memory_analysis")


def cell_key(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


# ------------------------------------------------------------ the reference
# Run by ``reference_cells`` in a subprocess (``python -c``; this tool itself
# imports neither JAX nor the reference): compile the reference's cell and
# print its figures as one JSON line. ``repro.launch.dryrun`` is imported
# first: it asks for 512 host devices before JAX starts.
_REFERENCE_SCRIPT = r"""
import collections, json, os, re, shutil, sys, tempfile
from pathlib import Path
ops, cells = int(sys.argv[1]), [c.split(":") for c in sys.argv[2:]]
dump = tempfile.mkdtemp(prefix="xla_dump_") if ops else None
if ops:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={dump}"
                               + " --xla_dump_hlo_module_re=.*(train_step|prefill_fn|decode_fn).*")
import repro.launch.dryrun as RD
import jax
from jax.sharding import AxisType
from repro.configs import ALL_SHAPES, get_config
from repro.configs.base import RunConfig
from repro.launch import hlo_analysis as H


def op_name(rest):
    m = re.search(r'op_name="([^"]*)"', rest)
    return re.sub(r"jit\([^)]*\)/", "", m.group(1)) if m else "?"


def breakdown(text, assignment):
    # products and collectives (times their loops' trip counts) by result
    # and op name; the buffers live at the peak of XLA's buffer assignment
    # and their sum, the heap simulator's peak
    comps, entry = H.parse_module(text)
    mult = H._multipliers(comps, entry)
    flops, colls, by_name = collections.Counter(), collections.Counter(), {}
    for cname, comp in comps.items():
        for op in comp.ops:
            by_name[op.name] = op
            m = mult.get(cname)
            kind = op.kind[:-6] if op.kind.endswith("-start") else op.kind
            if m is None:
                continue
            if kind in ("dot", "convolution"):
                flops[f"{op.shape_txt.split('{')[0]} {op_name(op.rest)}"] += m * H._dot_flops(op, comp)
            elif kind in H.COLLECTIVE_KINDS and H._group_size(op.rest) > 1:
                k = H._group_size(op.rest)
                colls[f"{kind} K={k} {op.shape_txt.split('{')[0][:80]} {op_name(op.rest)}"] += (
                    m * H._shape_elems_bytes(op.shape_txt)[1] * H.COLL_FACTORS[kind](k))
    live = collections.Counter()
    lines = assignment.read_text().splitlines()
    start = next(i for i, line in enumerate(lines) if "(peak):" in line)
    for line in lines[start + 1:]:
        m = re.match(r"\s+([\w.\-]+)\{[0-9,]*\}: (\d+) bytes", line)
        if not m:
            break
        op = by_name.get(m.group(1))
        what = (f"{op.kind} {op.shape_txt.split('{')[0][:60]} {op_name(op.rest)}"
                if op is not None else m.group(1))
        live[what] += int(m.group(2))
    return {"flops": flops.most_common(), "collectives": colls.most_common(),
            "peak_live": live.most_common(), "heap_peak": sum(live.values())}


for arch, shape, mesh in cells:
    dims, names = (((2, 16, 16), ("pod", "data", "model")) if mesh == "multi"
                   else ((16, 16), ("data", "model")))
    jmesh = jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
    seen = set(Path(dump).iterdir()) if ops else set()
    lowered, _ = RD.lower_cell(get_config(arch), ALL_SHAPES[shape], jmesh, RunConfig())
    compiled = lowered.compile()
    text = compiled.as_text()
    hlo = H.analyze(text)
    out = {"cell": f"{arch}__{shape}__{mesh}", "flops_per_device": hlo["flops"],
           "bytes_per_device": hlo["bytes"],
           "collective_bytes_effective": hlo["collective_bytes_effective"],
           "collective_total_effective": hlo["collective_total_effective"],
           "collective_num_ops": hlo["collective_num_ops"],
           "memory_analysis": RD._mem_analysis_dict(compiled)}
    if ops:
        new = [f for f in Path(dump).iterdir() if f not in seen
               and f.name.endswith("after_optimizations-buffer-assignment.txt")]
        out["ops"] = breakdown(text, max(new, key=lambda f: f.stat().st_mtime))
    print(json.dumps(out), flush=True)
if ops:
    shutil.rmtree(dump)
"""


def reference_cells(cells, ops: int = 0):
    """{cell key: the reference's figures} for (arch, shape, mesh) cells,
    compiled one after another in one subprocess (the 512 host devices must
    be asked for before JAX starts); with ``ops``, each with its breakdown
    by op (``"ops"``)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_SCRIPT, str(ops),
                           *(":".join(c) for c in cells)],
                          capture_output=True, text=True, env=env, timeout=1800)
    if proc.returncode:
        raise SystemExit(f"the reference's cells {cells} failed:\n{proc.stderr[-3000:]}")
    out = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {rec.pop("cell"): rec for rec in out}


# ----------------------------------------------------------------- the port
def _where(depth: int = 4) -> str:
    """The innermost ``depth`` functions (file:function) of the port's model
    code that led to the op (a checkpoint's recomputation marked "remat");
    in a backward formula, those that made its forward (autograd's anomaly
    mode keeps them on each node), marked "bwd"."""
    import torch
    f, frames = sys._getframe(2), []
    while f is not None and len(frames) < depth:
        name = f.f_code.co_filename
        if "repro_torch" in name and "/launch/" not in name and "/train/" not in name:
            frames.append(f"{name.split('repro_torch/')[-1]}:{f.f_code.co_name}")
        f = f.f_back
    node = torch._C._current_autograd_node()
    if frames and not (node is not None and all(f.endswith(":backward") for f in frames)):
        # model code run inside a backward is a checkpoint's recomputation
        # (a custom Function's own backward is labelled by its forward)
        return ("remat " if node is not None else "") + " < ".join(frames)
    if node is None:
        return ""
    trace = "".join(node.metadata.get("traceback_") or [])
    frames = [f"{f}:{fn}" for f, fn in
              re.findall(r'repro_torch/([\w/]+\.py)", line \d+, in (\w+)', trace)
              if not f.startswith(("launch/", "train/"))]
    return "bwd " + " < ".join(frames[::-1][:depth])


def _breakdown_classes():
    import torch
    from repro_torch.launch.op_analysis import MemoryTracker, OpCounter

    class Counter(OpCounter):
        """Products and collectives by op, result and source function."""

        def __init__(self):
            super().__init__()
            self.by_flops, self.by_coll = collections.Counter(), collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f0, c0 = self.flops, sum(self.coll_eff.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            c1 = sum(self.coll_eff.values())
            if out is not NotImplemented and (self.flops != f0 or c1 != c0):
                res = f"{out.dtype} {tuple(out.shape)}" if isinstance(out, torch.Tensor) else ""
                key = f"{func.__name__} {res} {_where()}"
                if c1 != c0:
                    self.by_coll[key] += c1 - c0
                else:
                    self.by_flops[key] += self.flops - f0
            return out

    class Tracker(MemoryTracker):
        """Each storage's creating op, and those live at the peak."""

        def __init__(self):
            super().__init__()
            self.label, self.path, self.born, self.at_peak = "argument", "", {}, {}

        def track_named(self, leaves):
            """Track {path: tensor}, each argument labelled by its path."""
            for self.path, t in leaves.items():
                self.track(t)
            self.path = ""

        def _add(self, t):
            key = t.untyped_storage()._cdata
            if key in self._held:
                return
            before = self.peak
            super()._add(t)
            self.born[key] = f"{self.label} {t.dtype} {tuple(t.shape)}" + (
                f" {self.path}" if self.path else "")
            if self.peak > before:
                self.at_peak = {k: (self.born[k], n) for k, n in self._held.items() if n}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.label = f"{func.__name__} {_where()}"
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Counter, Tracker


def port_cell(arch: str, shape: str, mesh: str, ops: int = 0):
    """The port's figures for the cell, as ``repro_torch.launch.dryrun``'s
    ``count_cell`` counts them (rank 0 of a fake group, meta tensors); with
    ``ops``, also its products, collectives and storages live at the peak
    by op and source (the counter and tracker subclassed here)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.shapes import ALL_SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import MemoryTracker, OpCounter
    from repro_torch.models import layers as L
    from repro_torch.train.tree import flatten_with_paths, tree_leaves
    mshape = make_production_mesh(multi_pod=mesh == "multi")
    counter_cls, tracker_cls = _breakdown_classes() if ops else (OpCounter, MemoryTracker)
    cell = ALL_SHAPES[shape]
    with D.fake_group(math.prod(mshape.shape_tuple)), \
            torch.autograd.set_detect_anomaly(bool(ops), check_nan=False):
        dmesh = init_device_mesh("cpu", mshape.shape_tuple, mesh_dim_names=mshape.axis_names)
        step, _, args = D.lower_cell(get_config(arch), cell, dmesh, RunConfig())
        L.rope_freq.cache_clear()
        tracker = tracker_cls()
        if ops:
            tracker.track_named({path: t for path, t in flatten_with_paths(args).items()
                                 if isinstance(t, torch.Tensor)})
        else:
            tracker.track(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        with torch.no_grad() if cell.mode != "train" else contextlib.nullcontext():
            with tracker, counter_cls() as counter:
                result = step()
        memory = D.memory_analysis(args, result, tracker.peak)
    res = counter.summary()
    out = {"flops_per_device": res["flops"], "bytes_per_device": res["bytes"],
           **{k: res[k] for k in SUMMARY_KEYS if k.startswith("collective")},
           "memory_analysis": memory}
    if ops:
        live = collections.Counter()
        for what, n in tracker.at_peak.values():
            live[what] += n
        out["ops"] = {"flops": counter.by_flops.most_common(),
                      "collectives": counter.by_coll.most_common(),
                      "peak_live": live.most_common()}
    return out


# ----------------------------------------------------------- named terms
# A cell's figures split into named terms, op by op on both sides: a
# product, collective or buffer (by result, op name or source function; see
# ``--ops``) goes to the first term of its arch, mode and metric whose
# pattern matches it, and what no term matches is the remainder, "rest".
# The patterns name each arch's widths, taken from its config (``widths``;
# "<d>" in a pattern is d_model, ...). A term's relation says how the two
# sides' amounts compare:
#   same         equal amounts;
#   f32          the reference moves or holds in f32 what the port does in
#                bf16 (XLA's CPU backend runs a bf16 product in f32, and the
#                collective on its operand or result carries the f32):
#                reference = 2 x port;
#   3 copies     reference = 3 x port;
#   slots whole  the reference keeps whole the slots the port splits over
#                ``model``: reference = model x port;
#   split:model  the reference splits over ``model`` a product that every
#                model rank of the port repeats: reference x model = port;
#   moe:model    the reference's TP MoE runs every expert's whole ff on each
#                model rank and sums ``model`` copies of the output (its own
#                fault, ROADMAP F7), where the port runs each rank's ff
#                slice: reference = model x port; "f32, moe:model" for its
#                expert weights' gathers, in f32: reference = 2 x model x port;
#   ref only / port only   one side has none;
#   plan         the two sides take different plans for the same work
#                (the tests hold the port's side to the file, and the port's
#                side of gemma2-2b's peak terms to closed forms).
# The reference's peak (XLA's total_hbm_bytes, a sum of allocations) has one
# more term, not matched but derived: its allocations beyond the buffers live
# at its heap simulator's peak.
MODEL = 16                      # the production meshes' ``model`` axis
RATIOS = {"same": 1.0, "f32": 2.0, "3 copies": 3.0, "slots whole": float(MODEL),
          "split:model": 1.0 / MODEL, "moe:model": float(MODEL), "2 copies": 2.0,
          "f32, moe:model": 2.0 * MODEL}
BEYOND_HEAP = ("XLA's allocations beyond the buffers live at its heap simulator's peak "
               "(buffers in allocations of their own, fragmentation)")
ZOO = ("granite-moe-3b-a800m", "mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium")
ZOO_CELLS = [(a, s, "single") for a in ZOO for s in ("train_4k", "prefill_32k", "decode_32k")]
G, M, R, S = ZOO


def widths(arch: str):
    """The widths the terms' patterns name, from the arch's config: d, its
    slice over ``model`` (d16), the vocab V and its slice (V16, rounded up
    as DTensor splits it), q and kv widths (qd, kvd), heads (hq, hkv), the
    head dim (dh, half of it), the MLP's ff slice (ff16), the experts (E)
    and their ff (mff) and its slice (mff16), the SSD's d_inner (di), the RG-LRU's width (rw),
    the layer pattern's repeats (reps) and the query heads a kv head times
    train_4k's 4,096 tokens (gs4k: the rows of a training step's scores)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n = MODEL
    return {"d": cfg.d_model, "d16": cfg.d_model // n, "V": cfg.vocab_size,
            "V16": -(-cfg.vocab_size // n), "qd": cfg.num_heads * cfg.head_dim,
            "kvd": cfg.num_kv_heads * cfg.head_dim, "hq": cfg.num_heads,
            "hkv": cfg.num_kv_heads, "dh": cfg.head_dim, "half": cfg.head_dim // 2,
            "ff16": cfg.d_ff // n, "E": cfg.num_experts, "mff": cfg.moe_d_ff,
            "mff16": cfg.moe_d_ff // n, "k": cfg.num_experts_per_tok, "q": cfg.ssm_chunk,
            "B": 128, "b16": 128 // n, "rw16": cfg.rglru_width // n,
            "di": cfg.d_inner, "rw": cfg.rglru_width,
            "reps": cfg.num_layers // len(cfg.pattern),
            "gs4k": (cfg.num_heads // max(cfg.num_kv_heads, 1)) * 4096}


# a decode step's products (F6): the reference's plans and the port's
_DECODE_PRODUCTS = ("products of a decode step: the reference gathers each weight over data "
                    "(FSDP) in f32, or all-reduces partial products; the port brings the "
                    "step's rows to the weight, sums the partial products over data in f32 "
                    "and hands the rows back (F6)")
_ROWS_MOVED = (r"rows_product|rows_to_slices|slices_to_rows|models/attention.py:_heads"
               r"|models/layers.py:unembed|models/ssd.py:ssd_step|models/ssd.py:_parts")

# (modes, metric, name, relation, reference pattern, port pattern), gemma2-2b's
_GEMMA2 = [
    # ---- products (flops)
    (("decode",), "flops", "q/k/v projections: GSPMD moves the decode batch onto model, the "
     "port splits the weights' columns over it (F6)", "same", r"bsd,dhk->bshk", r"_heads"),
    (("train",), "flops", "q/k/v weight gradients", "split:model",
     r"^f32\[\d+,<d16>\] transpose.*bsd,dhk->bshk", r"\(<d>, \d+\) bwd .*_heads"),
    (("train",), "flops", "o weight gradient", "split:model",
     r"^f32\[<d16>,\d+\] transpose.*bshk,hkd->bsd", r"\(<qd>, <d>\) bwd .*output_proj"),
    (("train", "prefill"), "flops", "q/k/v projections and their input gradients", "same",
     r"bsd,dhk->bshk", r"_heads"),
    ((), "flops", "o projection and its input gradient", "same", r"bshk,hkd->bsd", r"output_proj"),
    ((), "flops", "attention (scores and values; K2, K3 or the chunked softmax)", "same",
     r"bqkgd|bkgqc|bkgd,bskd|bkgs,bskd|^f32\[(\d+,){2,}\d+\] \?$",
     r"flash_attention|decode_attention|attention_chunked"),
    (("train",), "flops", "remat: the reference recomputes the w_out product of a repeat's "
     "first layer, the port's checkpoint stops before it", "ref only",
     r"f32\[\d+,<d>\] .*rematted_computation/dot_general$", r"$^"),
    (("prefill",), "flops", "logits of the last position (the reference's multi-pod compile "
     "fuses the product, and its hlo_analysis counts no fused product)", "plan",
     r"^f32\S+ ((jvp\(\)/|transpose\(jvp\(\)\)/)?dot_general|\?)$", r"unembed"),
    ((), "flops", "logits (the tied unembedding) and their gradients", "same",
     r"^f32\S+ ((jvp\(\)/|transpose\(jvp\(\)\)/)?dot_general|\?)$", r"unembed"),
    ((), "flops", "MLP products and their gradients", "same", r"dot_general$", r"mlp_apply"),
    # ---- collectives
    (("decode",), "collectives", "cache write: the reference gathers every row's new k/v to "
     "write its slots, the port writes each rank's own", "ref only", r"scatter$", r"$^"),
    (("decode",), "collectives", "attention over the slots split on model: the outputs, "
     "maxima and sums all-reduced", "plan",
     r"bkgs,bskd->bkgd|reduce_sum$|reduce_max$", r"merge_shards"),
    (("decode",), "collectives", _DECODE_PRODUCTS, "plan", r"dot_general$", _ROWS_MOVED),
    (("train",), "collectives", "remat weight gathers: each side gathers the weights again "
     "for its recomputation (the reference half of its w_out gathers in the backward proper)",
     "f32", r"^all-gather .*(rematted_computation|transpose\(jvp\(\)\).*checkpoint/dot_general$)",
     r"^all_gather\S* .* remat .*fsdp_gathered"),
    (("train", "prefill"), "collectives", "FSDP weight gathers", "f32",
     r"^all-gather K=\d+ f32\S+ (jvp\(\)/)?(while/body/closed_call/)?(bsd,dhk->bshk/|bshk,hkd->bsd/)?dot_general$",
     r"^all_gather\S* torch.bfloat16 .*fsdp_gathered"),
    (("train", "prefill"), "collectives", "the MLP output's all-reduce over model", "f32",
     r"^all-reduce K=\d+ f32\[\d+,\d+,<d>\] (jvp\(\)/)?while/body/closed_call/dot_general$",
     r"^all_reduce\S* torch.bfloat16 \S+ \S+ \S+ parallel/sharding.py:forward < .*mlp_apply"),
    (("train",), "collectives", "the residual stream's gradient all-reduced over model (the "
     "reference: the MLP input's two partial gradients; the port: at the attention and MLP "
     "outputs)", "f32",
     r"^all-reduce K=\d+ \(f32\[\d+,\d+,<d>\] transpose\(jvp\(\)\)/while/body/closed_call/checkpoint/dot_general$",
     r"bwd parallel/sharding.py:constrain .*(output_proj|mlp_apply)"),
    (("train",), "collectives", "remat: the reference recomputes a repeat's first MLP output "
     "and its all-reduce", "ref only", r"^all-reduce .*rematted_computation/dot_general$", r"$^"),
    (("train",), "collectives", "the logits' input gradient all-reduced over model (the port "
     "leaves it to the residual's)", "ref only",
     r"^all-reduce K=\d+ \(?f32\[\d+,\d+,<d>\] transpose\(jvp\(\)\)/dot_general$", r"$^"),
    (("train",), "collectives", "loss and norms: log-sum-exp's maximum and sum, the gold "
     "logit, the loss's and the gradients' global norm's sums", "plan",
     r"take_along_axis|reduce_max$|jvp\(\)/reduce_sum$|K=\d+ f32\[\] reduce_sum$"
     r"|K=\d+ \((f32\[\],? ?(/\*index=\d+\*/)?)+\)? reduce_sum$",
     r"parallel/sharding.py:reduced < models/model.py|^all_reduce\S* torch.float32 \(\) "),
    ((), "collectives", "embedding lookup and its gradient (the reference gathers every row "
     "over d-slices; the port gathers the table's d and sums its vocab slice's rows)", "plan",
     r"gather$|scatter-add$", r"embed_lookup|_sharded_rows|_rows_at_table"),
    (("train",), "collectives", "weight-gradient reductions (the reference all-reduces, over "
     "model, weight gradients it split by batch there; the port reduce-scatters each over "
     "data, FSDP, and all-reduces the replicated norm scales')", "plan",
     r"transpose\(jvp\(\)\)|f32\[<V16>,<d>\]", r"bwd parallel/sharding.py:fsdp_gathered|placed_like"),
    # ---- memory at the peak (XLA's buffer assignment at its heap peak; the
    # port's storages live at its peak)
    ((), "peak", "arguments: parameters, optimizer state, inputs (not the decode cache, not "
     "the optimizer's int32 scalars)", "same",
     r"^parameter [^(]", r"^argument (?!torch.bfloat16 \(\d+, \d+, <hkv>, <dh>\)|torch.int32 \(\))"),
    (("decode",), "peak", "the KV cache: the reference's layer loop holds f32 copies of k and v "
     "and two bf16 copies of one; the port updates its argument in place", "3 copies",
     r"\[<reps>,\d+,\d+,<hkv>,<dh>\]", r"^argument torch.bfloat16 \(\d+, \d+, <hkv>, <dh>\)"),
    (("prefill",), "peak", "the KV cache being filled: the reference's split over the batch, "
     "the port's over the batch and the slots", "slots whole",
     r"\[<reps>,\d+,\d+,<hkv>,<dh>\]", r"init_cache"),
    (("decode",), "peak", "the unembedding: the reference's table gathered over data in f32; "
     "the port's f32 partial logits of the rows it brings to the table (F6)",
     "plan", r"f32\[<d>,<V16>\]",
     r"rows_product < (parallel/sharding.py:product < )?models/layers.py:unembed"),
    (("prefill",), "peak", "the unembedding table gathered over data in f32 (the port's peak "
     "comes before it gathers the table)", "ref only",
     r"f32\[<d>,<V16>\]", r"fsdp_gathered < models/layers.py:unembed"),
    ((), "peak", "weights for products: the reference's f32 copies of bf16 weights (XLA's CPU "
     "backend converts before a product) and f32 weight gradients; the port's weights "
     "gathered over data (FSDP)", "plan",
     r"f32\[(<reps>,)?(<d16>|<ff16>|<d>|<qd>|<kvd>|<hq>|<V16>|<V>),(<d16>|<ff16>|<d>|<qd>|<kvd>|<hq>|<hkv>|<dh>|<V16>)[,\]]",
     r"fsdp_gathered"),
    ((), "peak", "attention: q, k, v, the scores and the online softmax's state (the reference's "
     "jnp attention; the port's chunked softmax in training, K2 and K3 keeping theirs on chip), "
     "the output and its projection, the RoPE tables", "plan",
     r"\[(\d+,){4,}\d+\]|\[(\d+,)?<hkv>,|<gs4k>,1024\]|^parameter \(s32\[\], f32|1,<half>\]",
     r"attention_chunked|flash_attention|_mask_block|decode_attention|_decode_shards|"
     r"merge_shards|project_qkv|_heads|output_proj"),
    ((), "peak", "activations: the residual stream, the norms, the MLP and the loss (train: the "
     "checkpointed layer inputs), indices, masks and scalars", "plan",
     r",<d>\]|,<ff16>\]|,<d16>\]|\[<d>,\d+\]|,1\]|(pred|s32|u32)\[|f32\[\d*\] |^parameter \(s32\[\], bf16",
     r"models/(model|layers)\.py|^ones_like\.default  |^argument torch.int32 \(\)"),
]


# (archs, modes, metric, name, relation, reference pattern, port pattern), the zoo's
_ZOO = [
    # ---- products (flops): granite's three cells, mamba2's and seamless's train_4k
    ((G,), (), "flops", "the TP MoE's expert products: the reference runs every expert's whole "
     "ff on each model rank (F7, its own fault), the port its ff slice", "moe:model",
     r"shard_map/ec\w,e\w\w->ec\w/", r"^bmm\.default .*models/moe.py"),
    ((G,), (), "flops", "attention: scores and values (K2, K3 or the chunked softmax)", "same",
     r"bqkgd|bkgqc|bkgd,bskd|bkgs,bskd|^f32\[(\d+,){2,}\d+\] \?$",
     r"flash_attention|decode_attention|attention_chunked"),
    ((S,), ("train",), "flops", "attention: scores and values (K2, K3 or the chunked softmax)", "same",
     r"bqkgd|bkgqc|bkgd,bskd|bkgs,bskd|^f32\[(\d+,){2,}\d+\] \?$",
     r"flash_attention|decode_attention|attention_chunked"),
    ((G,), (), "flops", "attention projections (q, k, v, o) and their input gradients", "same",
     r"^f32\[(?!(<d>|<d16>|<qd>|<kvd>),)\d+,\d+\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/"
     r"closed_call/(checkpoint/)?(rematted_computation/)?(bsd,dhk->bshk|bshk,hkd->bsd)/dot_general$",
     r"^mm\.\w+ \S+ \((?!(<d>|<d16>|<qd>|<kvd>), )\d+, \d+\) .*models/attention.py:_rows_times"),
    ((S,), ("train",), "flops", "attention projections (q, k, v, o) and their input gradients", "same",
     r"^f32\[(?!(<d>|<d16>|<qd>|<kvd>),)\d+,\d+\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/"
     r"closed_call/(checkpoint/)?(rematted_computation/)?(bsd,dhk->bshk|bshk,hkd->bsd)/dot_general$",
     r"^mm\.\w+ \S+ \((?!(<d>|<d16>|<qd>|<kvd>), )\d+, \d+\) .*models/attention.py:_rows_times"),
    ((G,), ("train",), "flops", "attention projections' weight gradients: GSPMD splits their batch "
     "over model (24 heads do not divide it), every model rank of the port runs them whole",
     "split:model", r"^f32\[(<d>|<d16>|<qd>|<kvd>),\d+\] transpose\(jvp\(\)\)/.*"
     r"(bsd,dhk->bshk|bshk,hkd->bsd)/dot_general$",
     r"^mm\.\w+ \S+ \((<d>|<qd>|<kvd>), \d+\) bwd .*models/attention.py:_rows_times"),
    ((S,), ("train",), "flops", "attention projections' weight gradients (the heads split over "
     "model on both sides)", "same", r"^f32\[(<d>|<d16>|<qd>|<kvd>),\d+\] transpose\(jvp\(\)\)/.*"
     r"(bsd,dhk->bshk|bshk,hkd->bsd)/dot_general$",
     r"^mm\.\w+ \S+ \((<d>|<d16>|<qd>|<kvd>), \d+\) bwd .*models/attention.py:_rows_times"),
    ((G, M, S), ("train",), "flops", "logits (the tied unembedding) and their input gradient",
     "same", r"^f32\[\d+,(<V>|<d>)\] (jvp\(\)|transpose\(jvp\(\)\))/dot_general$",
     r"^mm\.\w+ \S+ \((?!<V>,)\d+, (<V>|<d>)\) (bwd )?parallel/sharding.py:product < "
     r"models/layers.py:unembed"),
    ((G, M, S), ("train",), "flops", "the tied table's gradient: GSPMD splits its product over the "
     "model axis the vocab leaves idle, every model rank of the port runs it whole", "split:model",
     r"^f32\[<V>,<d16>\] transpose\(jvp\(\)\)/dot_general$",
     r"^mm\.\w+ \S+ \(<V>, <d>\) bwd parallel/sharding.py:product < models/layers.py:unembed"),
    ((G,), ("prefill",), "flops", "logits of the last position: GSPMD splits their contraction over "
     "the model axis the vocab leaves idle, every model rank of the port runs it whole",
     "split:model", r"^f32\[\d+,<V>\] dot_general$",
     r"^mm\.\w+ \S+ \(\d+, <V>\) parallel/sharding.py:product < models/layers.py:unembed"),
    ((G,), ("decode",), "flops", "logits: the reference's rows (B/16) against the whole vocab and "
     "d/16 (its contraction split over model); the port's B rows brought to the table's "
     "(d/16, V/16) slice (F6)", "plan", r"^f32\[\d+,<V>\] dot_general$",
     r"^mm\.\w+ \S+ \(\d+, <V16>\) .*rows_product < parallel/sharding.py:product < "
     r"models/layers.py:unembed"),
    ((G,), ("decode",), "flops", "the router's product: GSPMD splits its contraction over model, "
     "every model rank of the port runs it whole", "split:model",
     r"^f32\[\d+,<E>\] while/body/closed_call/dot_general$",
     r"^mm\.\w+ \S+ \(\d+, <E>\) .*models/moe.py:route"),
    ((G,), ("train", "prefill"), "flops", "the router's product and its input gradient", "same",
     r"^f32\[(?!<E>,)\d+,\d+\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/closed_call/"
     r"(checkpoint/)?(rematted_computation/)?dot_general$",
     r"^mm\.\w+ \S+ \((?!<d>,)\d+, \d+\) .*models/moe.py:route"),
    ((G,), ("train",), "flops", "the router's weight gradient: GSPMD splits its batch over model, "
     "every model rank of the port runs it whole", "split:model",
     r"^f32\[<E>,<d16>\] transpose", r"^mm\.\w+ \S+ \(<d>, <E>\) bwd .*models/moe.py:route"),
    ((M,), ("train",), "flops", "the SSD's input projection (the fused w_in; the port's by part) "
     "and output projection, and their gradients", "same",
     r"^f32\[\d+,\d+\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/closed_call/(checkpoint/)?"
     r"(rematted_computation/)?dot_general$",
     r"^mm\.\w+ .*models/ssd.py:(_parts|ssd_forward)"),
    ((M,), ("train",), "flops", "the SSD's chunked scan on 5 heads a rank (C·Bᵀ: the reference "
     "splits its contraction over model, the port runs it whole on every model rank)", "plan",
     r"bcijh|bcjh,|bcin,|bin,bih|bh,bn|bn,bhpn", r"^bmm\.default .*models/ssd.py:_scan"),
    ((S,), ("train",), "flops", "the MLP's products and their gradients", "same",
     r"^f32\[\d+,\d+\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/closed_call/(checkpoint/)?"
     r"(rematted_computation/)?dot_general$", r"^mm\.\w+ .*models/layers.py:mlp_apply"),
    # ---- collectives: every zoo cell's but seamless prefill_32k's
    # the TP MoE (granite)
    ((G,), (), "collectives", "the TP MoE's expert weights gathered over data (and again for "
     "the recomputation): the reference gathers every expert's whole ff in f32 on each model "
     "rank (F7), the port its ff slice in bf16", "f32, moe:model",
     r"^all-gather K=\d+ f32\[(1,)?<E>,(<d>,<mff>|<mff>,<d>)\] ",
     r"^all_gather\S* torch.bfloat16 \(\d+, (<d16>, <mff16>|<mff16>, <d16>)\) (remat )?"
     r"models/moe.py:gathered"),
    ((G,), (), "collectives", "the TP MoE's output summed over model, the reference's in f32",
     "f32", r"^all-reduce K=\d+ f32\[\d+,\d+,<d>\] (jvp\(\)/)?while/body/closed_call/shard_map/psum$",
     r"^all_reduce\S* torch.bfloat16 \(\d+, \d+, <d>\) models/moe.py:_moe_sharded"),
    ((G,), ("train",), "collectives", "the TP MoE's input and gates' gradients summed over "
     "model (the reference's in f32, and its input's twice)", "plan",
     r"^all-reduce K=\d+ \(?f32\[\d+,\d+,(<d>|<k>)\] transpose\(jvp\(\)\)/while/body/closed_call/"
     r"checkpoint/shard_map/psum$",
     r"^all_reduce\S* \S+ \(\d+, \d+, (<d>|<k>)\) bwd (parallel/sharding.py:constrain < )?"
     r"models/moe.py:_moe_sharded"),
    ((G,), ("train",), "collectives", "the TP MoE's expert weights' gradients: the reference "
     "all-reduces every expert's whole-ff gradient over data and model in f32, the port reduces "
     "its ff slice's over data", "plan", r"^all-reduce K=256 \(f32\[<E>,",
     r"^(reduce_scatter|all_gather)\S* torch.bfloat16 \([\d, ]*\) bwd models/moe.py:gathered"),
    ((G,), ("train", "prefill"), "collectives", "the router's weight gathered over data (and "
     "again for the recomputation)", "same", r"^all-gather K=\d+ f32\[<d>,<E>\] ",
     r"^all_gather\S* torch.float32 \(<d>, <E>\) (remat )?models/moe.py:_moe_sharded"),
    ((G,), ("train", "prefill"), "collectives", "the router's top-k: the reference gathers every "
     "row's router logits over data, the port routes its own rows", "ref only",
     r"^all-gather K=\d+ f32\[\d+,\d+,<E>\] .*top_k$", r"$^"),
    ((G,), ("decode",), "collectives", "the router at a decode step: the reference splits its "
     "contraction over model (partial logits all-reduced) and gathers every row's top-k, the "
     "port gathers its weight over data", "plan",
     r"^all-(gather|reduce) K=\d+ f32\[\d+,1,<E>\] while/body/closed_call/(top_k|dot_general)$",
     r"^all_gather\S* torch.float32 \(<d>, <E>\) models/moe.py:_moe_sharded"),
    # training and prefill: the FSDP gathers and the TP all-reduces
    ((G, M, S), ("train",), "collectives", "FSDP weight gathers, the reference's in f32: "
     "the forward's and the recomputation's (the reference's also in its backward proper), the "
     "tied table's for the logits included", "f32",
     r"^all-gather K=\d+ f32\[(?![\d,]*,<E>\])[\d,]+\] (?!.*(bcin|bin,|bcjh|bh,bn|bn,bhpn))"
     r"(jvp\(\)|transpose\(jvp\(\)\))/"
     r".*dot_general$",
     r"^all_gather\S* torch.bfloat16 \([\d, ]*\) (remat )?parallel/sharding.py:fsdp_gathered"),
    ((R,), ("train",), "collectives", "FSDP weight gathers, the reference's in f32: "
     "the forward's and the recomputation's (the reference's also in its backward proper), the "
     "tied table's for the logits included; the reference gathers less again for its "
     "recomputation than the port", "plan",
     r"^all-gather K=\d+ f32\[(?![\d,]*,<E>\])[\d,]+\] (?!.*(bcin|bin,|bcjh|bh,bn|bn,bhpn))"
     r"(jvp\(\)|transpose\(jvp\(\)\))/"
     r".*dot_general$",
     r"^all_gather\S* torch.bfloat16 \([\d, ]*\) (remat )?parallel/sharding.py:fsdp_gathered"),
    ((G, M), ("prefill",), "collectives", "FSDP weight gathers, the reference's in f32", "f32",
     r"^all-gather K=\d+ f32\[(?![\d,]*,<E>\])[\d,]+\] (while/body/closed_call/)?"
     r"((bsd,dhk->bshk|bshk,hkd->bsd)/)?dot_general$",
     r"^all_gather\S* torch.bfloat16 \([\d, ]*\) parallel/sharding.py:fsdp_gathered < "
     r"parallel/sharding.py:product < models/(?!layers.py:unembed)"),
    ((R,), ("prefill",), "collectives", "FSDP weight gathers, the reference's in f32 (the tied "
     "table's for the logits of the last position included)", "f32",
     r"^all-gather K=\d+ f32\[[\d,]+\] (while/body/closed_call/)?"
     r"((bsd,dhk->bshk|bshk,hkd->bsd)/)?dot_general$",
     r"^all_gather\S* torch.bfloat16 \([\d, ]*\) parallel/sharding.py:fsdp_gathered"),
    ((G, M), ("prefill",), "collectives", "the logits of the prompt's last position: the "
     "reference all-reduces partial logits over model, the port gathers the table's d over data",
     "plan", r"^all-reduce K=\d+ f32\[\d+,1,<V>\] dot_general$",
     r"^all_gather\S* torch.bfloat16 \([\d, ]*\) parallel/sharding.py:fsdp_gathered < "
     r"parallel/sharding.py:product < models/layers.py:unembed"),
    ((M, R), ("prefill",), "collectives", "the TP products' outputs all-reduced over model (the "
     "SSD's, the RG-LRU's, the MLP's and the attention's output projections), the reference's "
     "in f32", "f32",
     r"^all-reduce K=\d+ f32\[\d+,\d+,<d>\] (while/body/closed_call/)?(bshk,hkd->bsd/)?dot_general$",
     r"^all_reduce\S* torch.bfloat16 \(\d+, \d+, <d>\) parallel/sharding.py:forward < "),
    ((M, R, S), ("train",), "collectives", "the TP products' outputs (forward and recomputation) "
     "and the residual stream's gradient all-reduced over model: the reference's in f32, and at "
     "more points of its backward", "plan",
     r"^all-reduce K=\d+ \(?f32\[\d+,\d+,<d>\] (jvp\(\)|transpose\(jvp\(\)\))/.*dot_general$",
     r"^all_reduce\S* torch.bfloat16 \(\d+, \d+, <d>\) (remat |bwd )?parallel/sharding.py:"
     r"\w+ < (parallel/sharding.py:\w+ < )*models/(?!layers.py:embed_lookup)"),
    ((G, M, R, S), ("train",), "collectives", "weight-gradient reductions: the reference "
     "all-reduces each weight's gradient where GSPMD left it partial, the port reduce-scatters "
     "each over data (FSDP) and all-reduces the replicated scales and the local maps' weights",
     "plan", r"^all-reduce K=\d+ \((?!f32\[\d+,\d+,<d>\] )(?!.*bqkgd)f32\[\d+(,\d+)+\] transpose\(jvp\(\)\)/"
     r".*dot_general$|^all-reduce K=\d+ \((f32\[\], (/\*index=\d+\*/)?)+f32\[\d[^ ]* reduce_sum$"
     r"|^all-reduce K=\d+ \(f32\[(1,)?<d16>\] |^all-reduce K=\d+ \(f32\[<d>\] ",
     r"^reduce_scatter\S* torch.bfloat16 \([\d, ]*\) bwd parallel/sharding.py:fsdp_gathered|"
     r"placed_like|bwd models/(layers.py:conv1d_apply|ssd.py:_on_heads|rglru.py:_gates)|"
     r"^reduce_scatter\S* torch.float32 \(<d16>, <E>\) bwd models/moe.py"),
    ((G, M, R, S), ("train",), "collectives", "the loss and the gradients' norm: log-sum-exp's "
     "maximum and sum, the gold logit, the loss's and the global norm's sums", "plan",
     r"^all-reduce K=\d+ (f32\[\d+(,\d+)?\] jvp\(\)/(reduce_max|reduce_sum)|f32\[\d+,\d+,1\] "
     r"jvp\(jit\(take_along_axis\)\)/gather|f32\[\] (jvp\(\)/)?reduce_sum|\((f32\[\],? ?"
     r"(/\*index=\d+\*/)?)+\)? reduce_sum)$",
     r"parallel/sharding.py:reduced < models/model.py|^all_reduce\S* torch.float32 \(\) "),
    # the embedding lookup
    ((G, M, R), (), "collectives", "embedding lookup and its "
     "gradient (the reference gathers every row over d-slices; the port gathers the table's d, "
     "or at a decode step the tokens, and sums its vocab slice's rows)", "plan",
     r"^(?!.*take_along_axis)all-\S+ K=\d+ \(?[fs]32\[[\d,]+\] (jvp\(jit\(_take\)\)/|"
     r"transpose\(jvp\(jit\(_take\)\)\)/)?(gather|scatter-add)$",
     r"models/layers.py:(embed_lookup|_sharded_rows|_rows_at_table)"),
    ((S,), ("train", "decode"), "collectives", "embedding lookup and its "
     "gradient (the reference gathers every row over d-slices; the port gathers the table's d, "
     "or at a decode step the tokens, and sums its vocab slice's rows)", "plan",
     r"^(?!.*take_along_axis)all-\S+ K=\d+ \(?[fs]32\[[\d,]+\] (jvp\(jit\(_take\)\)/|"
     r"transpose\(jvp\(jit\(_take\)\)\)/)?(gather|scatter-add)$",
     r"models/layers.py:(embed_lookup|_sharded_rows|_rows_at_table)"),
    # mamba2's SSD
    ((M,), (), "collectives", "the SSD's parts regrouped over model (w_in's and the conv's "
     "columns, the conv state): the port's all-to-alls; the reference's collective-permutes, "
     "which its hlo_analysis does not count", "port only", r"$^", r"_move_columns"),
    ((M,), ("prefill", "decode"), "collectives", "the SSD's gated norm: the mean of squares "
     "all-reduced over the split of d_inner", "same",
     r"^all-reduce K=\d+ f32\[\d+(,\d+)?\] while/body/closed_call/reduce_sum$",
     r"^all_reduce\S* torch.float32 \([\d, ]*\) parallel/sharding.py:reduced < models/ssd.py:_gated_norm"),
    ((M,), ("train",), "collectives", "the SSD's gated norm and its gradient: the mean of squares "
     "all-reduced over the split of d_inner (the port's gradient reduce-scattered back to it)",
     "plan", r"^all-reduce K=\d+ \(?f32\[\d+,\d+\] (jvp\(\)|transpose\(jvp\(\)\))/while/body/"
     r"closed_call/(checkpoint/rematted_computation/)?reduce_sum$",
     r"models/ssd.py:_gated_norm"),
    ((M,), ("train", "prefill", "decode"), "collectives", "the SSD's B and C: the reference splits "
     "them over model (C·Bᵀ's partial sums all-reduced, B and C gathered in f32 for the state's "
     "products), the port gathers B‖C after its conv in bf16", "plan",
     r"bcin,bcjn|bin,bih,bhpn|bcjh,bcjn|bh,bn,bhp|bn,bhpn|/pad$|^all-reduce K=\d+ \(f32\[\d+,\d+,<q>,<q>\] ",
     r"^(all_gather|reduce_scatter)\S* torch.bfloat16 \([\d, ]*\) (remat |bwd )?parallel/sharding.py:"
     r"constrain < parallel/sharding.py:constrain < models/ssd.py:(ssd_forward|ssd_step)"),
    # a decode step
    ((G, M, R, S), ("decode",), "collectives", _DECODE_PRODUCTS, "plan",
     r"^all-(gather|reduce) K=\d+ \(?f32\[(?![\d,]*,<E>\])[\d,]+\] (while/body/closed_call/)?"
     r"((bsd,dhk->bshk|bshk,hkd->bsd)/)?dot_general$",
     r"^(?!.*_rows_at_table).*parallel/sharding.py:(rows_product|rows_to_slices|slices_to_rows)|"
     r"parallel/sharding.py:constrain < models/layers.py:unembed"),
    ((G, R, S), ("decode",), "collectives", "attention over the slots split on model: the "
     "outputs, maxima and sums all-reduced; q (and the port's heads that do not divide model, "
     "the MQA input, seamless's output bias) gathered", "plan",
     r"bkgs,bskd->bkgd|bkgd,bskd->bkgs|closed_call/reduce_sum$|closed_call/reduce_max$"
     r"|closed_call/convert_element_type$|^all-gather K=\d+ f32\[\d+,\d+,\d+,\d+\] while/body/closed_call/add$",
     r"merge_shards|_decode_shards|rows_like|^all_gather\S* torch.\w+ \([\d, ]*\) models/attention.py:"
     r"_heads < |constrain < models/attention.py:project_qkv"),
    ((G, R, S), ("decode",), "collectives", "cache write: the reference gathers every row's new "
     "k/v to write its slots, the port writes each rank's own", "ref only", r"scatter$", r"$^"),
    ((S,), ("train", "decode"), "collectives", "the attention output's bias gathered over "
     "model, the reference's in f32", "f32",
     r"^all-gather K=\d+ f32\[(1,)?<d>\] (jvp\(\)/|transpose\(jvp\(\)\)/)?while/body/closed_call/"
     r"(checkpoint/rematted_computation/)?add$",
     r"^all_gather\S* torch.bfloat16 \(<d>,\) (remat )?models/attention.py:output_proj"),
    ((R,), ("train",), "collectives", "the MQA's k and v gradients summed over model (one kv "
     "head, whole on every model rank), the reference's in f32", "plan",
     r"^all-reduce K=\d+ \(f32\[\d+,1,\d+,<dh>\] transpose\(jvp\(\)\)/.*bqkgd,bckd->bkgqc/dot_general$",
     r"^all_reduce\S* torch.bfloat16 \(\d+, \d+, 1, <dh>\) bwd models/attention.py:_attend_shards"),
    # ---- memory at the peak (XLA's buffer assignment at its heap peak; the port's storages
    # live at its peak): the decode cells' and seamless train_4k's
    ((G, M, R, S), ("decode",), "peak", "arguments: the parameters and the step's token and "
     "positions (the reference's that its step reads; the port's all)", "plan",
     r"^parameter (?!.*cache\[)", r"^argument (?!torch.\w+ \([\d, ]*\) 1/cache/)"),
    ((R,), ("decode",), "peak", "the KV cache of the attention layers: the reference's layer "
     "loop holds an f32 copy and a bf16 copy beside its argument; the port updates its argument "
     "in place", "3 copies", r"^(parameter|fusion|copy) (f32|bf16)\[<reps>,<b16>,\d+,<hkv>,<dh>\]",
     r"^argument torch.\w+ \([\d, ]*\) 1/cache/\d+/(k|v)$"),
    ((R,), ("decode",), "peak", "the RG-LRU's state and the conv's window: the reference's layer "
     "loop holds f32 copies beside its arguments; the port updates its arguments in place", "plan",
     r"^(parameter|fusion|copy) (f32|bf16)\[<reps>,<b16>,(\d+,)?<rw16>\]|cache\[",
     r"^argument torch.\w+ \([\d, ]*\) 1/cache/\d+/(h|conv)$"),
    ((G, S), ("decode",), "peak", "the KV cache: the reference's layer loop holds an f32 copy "
     "and a bf16 copy beside its argument; the port updates its argument in place", "3 copies",
     r"^(parameter|fusion|copy) (f32|bf16)\[<reps>,<b16>,|cache\[",
     r"^argument torch.\w+ \([\d, ]*\) 1/cache/"),
    ((M,), ("decode",), "peak", "the recurrent state and the conv's window: the reference's "
     "layer loop holds an f32 copy beside its argument; the port updates its argument in place",
     "2 copies", r"^(parameter|fusion|copy) (f32|bf16)\[<reps>,<b16>,|cache\[",
     r"^argument torch.\w+ \([\d, ]*\) 1/cache/"),
    ((G, M, R, S), ("decode",), "peak", "the unembedding: the reference's f32 copy of the tied "
     "table (its d/16 or, gathered over data, its V/16); the port's f32 partial logits of the "
     "rows it brings to the table (F6)", "plan",
     r"^(fusion|collective-permute) f32\[(<d16>,<V>|<d>,<V16>|<V>,<d16>)\] (\?|dot_general)$",
     r"parallel/sharding.py:rows_product < .*models/layers.py:unembed"),
    ((M, R, S), ("decode",), "peak", "the reference's f32 copies of its bf16 weights and the "
     "weights it gathers over data in f32 for the products (the port reads its weights in "
     "place and moves the rows, F6)", "ref only",
     r"^(fusion|copy|all-gather) f32\[(?!(<b16>|<B>),)(?!<reps>,<b16>,)(?!(<d16>,<V>|<d>,<V16>|"
     r"<V>,<d16>)\])\d+(,\d+)+\] (\?|dot_general|convert_element_type|params\S*)$|"
     r"^fusion f32\[<rw16>\] log1p$|^all-gather f32\[1,<d>\] while/body/closed_call/add$", r"$^"),
    ((G,), ("decode",), "peak", "weights for products: the reference's f32 copies of its bf16 "
     "weights (every layer's whole-ff experts); the port's layer's expert slice gathered over "
     "data and its f32 copy for the product", "plan",
     r"^(fusion|copy|all-gather) f32\[(?!(<b16>|<B>),)(?!<reps>,<b16>,)(?!(<d16>,<V>|<d>,<V16>|"
     r"<V>,<d16>)\])\d+(,\d+)+\] (\?|dot_general)$",
     r"^(cat|_to_copy)\.default models/moe.py:(gathered|forward) .* torch.\w+ \(<E>, "
     r"(<d>, <mff16>|<mff16>, <d>)\)$"),
    ((G, M, R, S), ("decode",), "peak", "the step's activations and temporaries: the residual "
     "stream and its norm, q and the RoPE tables, the recurrent blocks' and the MoE's "
     "temporaries (the reference's also the attention's f32 K and V of a layer), masks, indices "
     "and scalars", "plan",
     r"^(fusion|copy|dot|constant|partition-id|all-gather|collective-permute) "
     r"(pred|s32|u32|f32|bf16)\[((<b16>|<B>)(,\d+)*|\d{0,3})\] (?!log1p$)",
     r"^(?!argument )(?!(cat|_to_copy)\.default models/moe.py:(gathered|forward) .* torch.\w+ "
     r"\(<E>, (<d>, <mff16>|<mff16>, <d>)\)$)(?!.*rows_product < )\S+ (parallel/sharding.py:\w+ < )*"
     r"models/(model|layers|attention|ssd|moe)\.py:"),
]


def terms_for(arch: str):
    """[(modes, metric, name, relation, reference pattern, port pattern)]
    of the arch, its widths in the patterns (``widths``); () if it has
    none."""
    if arch == "gemma2-2b":
        rows = _GEMMA2
    elif arch in ZOO:
        rows = [t[1:] for t in _ZOO if arch in t[0]]
    else:
        return []
    w = widths(arch)
    sub = lambda p: re.sub(r"<(\w+)>", lambda m: str(w[m.group(1)]), p)  # noqa: E731
    return [(modes, metric, name, rel, sub(rp), sub(pp))
            for modes, metric, name, rel, rp, pp in rows]


def terms_of(arch: str, mode: str, metric: str, ref_ops, port_ops, ref_total: float,
             port_total: float, derived=()):
    """[name, relation, reference amount, port amount] for each term of the
    metric that either side has, then the ``derived`` terms (already
    reckoned), then the unmatched remainder, "rest", where there is one.
    With ``ref_ops`` None, the reference's amounts are 0."""
    rules = [(name, rel, re.compile(rp), re.compile(pp))
             for modes, m, name, rel, rp, pp in terms_for(arch)
             if m == metric and (not modes or mode in modes)]
    sums = {name: [0.0, 0.0] for name, *_ in rules}
    for side, ops in ((0, ref_ops or ()), (1, port_ops)):
        for label, value in ops:
            for name, _, rp, pp in rules:
                if (rp if side == 0 else pp).search(label):
                    sums[name][side] += value
                    break
    out = [[name, rel, sums[name][0], sums[name][1]] for name, rel, *_ in rules
           if sums[name][0] or sums[name][1]]
    out += [list(t) for t in derived]
    rest = [ref_total - sum(t[2] for t in out), port_total - sum(t[3] for t in out)]
    if any(abs(r) > 0.5 for r in rest):           # half a byte: float sums
        out.append(["rest", "plan", rest[0], rest[1]])
    return out


OPS_KEYS = {"flops": "flops", "collectives": "collectives", "peak": "peak_live"}


def has_terms(arch: str, mode: str, metric: str) -> bool:
    return any(m == metric and (not modes or mode in modes)
               for modes, m, *_ in terms_for(arch))


def named(arch: str, mode: str, ref, port):
    """{metric: terms} of a cell, from both sides' ``--ops`` breakdowns, for
    each metric the arch's terms name in the mode (the zoo's name only the
    figures outside their bands)."""
    beyond = [BEYOND_HEAP, "ref only", peak_of(ref) - ref["ops"]["heap_peak"], 0.0]
    return {metric: terms_of(arch, mode, metric, ref["ops"][key], port["ops"][key], rt, pt,
                             derived)
            for metric, key, rt, pt, derived in (
                ("flops", "flops", ref["flops_per_device"], port["flops_per_device"], ()),
                ("collectives", "collectives", ref["collective_total_effective"],
                 port["collective_total_effective"], ()),
                ("peak", "peak_live", peak_of(ref), peak_of(port), (beyond,)))
            if has_terms(arch, mode, metric)}


def overlaps(arch: str, mode: str, metric: str, ops, side: int):
    """[(label, [term names])] of the ops (one side's breakdown; side 0 the
    reference's, 1 the port's) that more than one term's pattern matches:
    none, where every term names its own ops."""
    rules = [(name, re.compile((rp, pp)[side])) for modes, m, name, rel, rp, pp in
             terms_for(arch) if m == metric and (not modes or mode in modes)]
    out = []
    for label, _ in ops:
        hits = [name for name, pat in rules if pat.search(label)]
        if len(hits) > 1:
            out.append((label, hits))
    return out


# -------------------------------------------------------------- comparison
def peak_of(side) -> float:
    """The reference's total_hbm_bytes (XLA: arguments + outputs + temps -
    aliases), the port's tracked peak."""
    mem = side["memory_analysis"]
    return float(mem.get("peak_bytes", mem.get("total_hbm_bytes", 0)))


def compared(ref, port):
    """{figure: (reference, port, port / reference)}."""
    rows = {"flops": (ref["flops_per_device"], port["flops_per_device"]),
            "bytes": (ref["bytes_per_device"], port["bytes_per_device"])}
    for kind in sorted(set(ref["collective_bytes_effective"]) | set(port["collective_bytes_effective"])):
        rows[f"coll {kind}"] = (ref["collective_bytes_effective"].get(kind, 0.0),
                                port["collective_bytes_effective"].get(kind, 0.0))
    rows["coll total"] = (ref["collective_total_effective"], port["collective_total_effective"])
    rows["argument bytes"] = (ref["memory_analysis"]["argument_size_in_bytes"],
                              port["memory_analysis"]["argument_size_in_bytes"])
    rows["output bytes"] = (ref["memory_analysis"]["output_size_in_bytes"],
                            port["memory_analysis"]["output_size_in_bytes"])
    rows["peak / total_hbm"] = (peak_of(ref), peak_of(port))
    return {k: (r, p, (p / r if r else float("nan"))) for k, (r, p) in rows.items()}


def print_cell(key, ref, port, ops, terms=None):
    print(f"== {key}  (reference: XLA's compiled program; port: the eager step; "
          f"arithmetic on shapes, per rank)")
    for name, (r, p, ratio) in compared(ref, port).items():
        print(f"   {name:18s} ref {r:14.6e}   port {p:14.6e}   port/ref {ratio:8.4f}")
    for metric, rows in (terms or {}).items():
        print(f"   -- named terms: {metric}")
        for name, rel, r, p in rows:
            print(f"      ref {r:12.5e}  port {p:12.5e}  [{rel}] {name}")
    if ops:
        for side, rec in (("reference", ref), ("port", port)):
            for what in ("flops", "collectives", "peak_live"):
                print(f"   -- {side} {what}")
                for name, v in rec["ops"][what][:ops]:
                    print(f"      {v:12.5e}  {name}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", default=None,
                    help="ARCH:SHAPE:MESH ..., 'zoo' (its twelve cells) or 'all' (the zoo's and "
                         "gemma2-2b's) (default: gemma2-2b's six cells)")
    ap.add_argument("--write", action="store_true",
                    help="store both sides in src/repro_torch/launch/reference_cells.json")
    ap.add_argument("--ops", type=int, default=0,
                    help="also print each side's N largest terms by op")
    ap.add_argument("--dump-ops", default="", metavar="DIR",
                    help="with --ops, write each cell's full breakdowns to DIR/<cell>.json")
    args = ap.parse_args()
    import logging
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    from repro_torch.configs.shapes import ALL_SHAPES
    from repro_torch.launch.dryrun import REFERENCE_CELLS
    named_sets = {"zoo": ZOO_CELLS, "all": GEMMA2_CELLS + ZOO_CELLS}
    cells = [c for name in (args.cells or []) for c in
             named_sets.get(name, [tuple(name.split(":"))])] or GEMMA2_CELLS
    if args.write and not args.ops and any(terms_for(arch) for arch, *_ in cells):
        ap.error("--write of cells with named terms needs --ops")
    book = json.loads(REFERENCE_CELLS.read_text()) if REFERENCE_CELLS.exists() else {"cells": {}}
    refs = reference_cells(cells, args.ops)
    for arch, shape, mesh in cells:
        key = cell_key(arch, shape, mesh)
        ref = refs[key]
        port = port_cell(arch, shape, mesh, args.ops)
        mode = ALL_SHAPES[shape].mode
        terms = named(arch, mode, ref, port) if args.ops and terms_for(arch) else None
        if terms and arch != "gemma2-2b":
            both = [o for metric in terms for side, rec in enumerate((ref, port))
                    for o in overlaps(arch, mode, metric, rec["ops"][OPS_KEYS[metric]], side)]
            if both:
                raise SystemExit(f"{key}: ops that two terms match: {both[:5]}")
        print_cell(key, ref, port, args.ops, terms)
        if args.dump_ops:
            Path(args.dump_ops).mkdir(parents=True, exist_ok=True)
            (Path(args.dump_ops) / f"{key}.json").write_text(
                json.dumps({"reference": ref.get("ops"), "port": port.get("ops")}, indent=0))
        entry = {"reference": {k: ref[k] for k in SUMMARY_KEYS},
                 "port": {k: port[k] for k in SUMMARY_KEYS}}
        if terms:
            entry["terms"] = terms
        book["cells"][key] = entry
    if args.write:
        import importlib.metadata
        import torch
        book["made_with"] = {"torch": torch.__version__,
                             "jax": importlib.metadata.version("jax")}
        book["about"] = ("Per-rank figures of dry-run cells, arithmetic on shapes: the reference's "
                         "compiled program (XLA's memory analysis, hlo_analysis.analyze) and the "
                         "port's eager step (op_analysis), written by tools/dryrun_vs_ref.py")
        book["cells"] = dict(sorted(book["cells"].items()))
        REFERENCE_CELLS.write_text(json.dumps(book, indent=1, sort_keys=True) + "\n")
        print(f"wrote {REFERENCE_CELLS.relative_to(ROOT)} ({len(book['cells'])} cells)")


if __name__ == "__main__":
    main()
