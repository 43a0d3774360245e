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
by op and source, and splits gemma2-2b's figures into the named terms
(``TERMS``) that ``PERF.md`` quotes and the file keeps; writing gemma2-2b's
cells needs it.

All figures are arithmetic on shapes, not measurements. Needs jax and
torch (CPU) and ``PYTHONPATH=src``:

  PYTHONPATH=src python tools/dryrun_vs_ref.py                 # gemma2-2b's six cells
  PYTHONPATH=src python tools/dryrun_vs_ref.py --ops 10 --write
  PYTHONPATH=src python tools/dryrun_vs_ref.py --cells mamba2-2.7b:decode_32k:single --ops 12
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
            self.label, self.born, self.at_peak = "argument", {}, {}

        def _add(self, t):
            key = t.untyped_storage()._cdata
            if key in self._held:
                return
            before = self.peak
            super()._add(t)
            self.born[key] = f"{self.label} {t.dtype} {tuple(t.shape)}"
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
    from repro_torch.train.tree import tree_leaves
    mshape = make_production_mesh(multi_pod=mesh == "multi")
    counter_cls, tracker_cls = _breakdown_classes() if ops else (OpCounter, MemoryTracker)
    cell = ALL_SHAPES[shape]
    with D.fake_group(math.prod(mshape.shape_tuple)), \
            torch.autograd.set_detect_anomaly(bool(ops), check_nan=False):
        dmesh = init_device_mesh("cpu", mshape.shape_tuple, mesh_dim_names=mshape.axis_names)
        step, _, args = D.lower_cell(get_config(arch), cell, dmesh, RunConfig())
        L.rope_freq.cache_clear()
        tracker = tracker_cls()
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
# gemma2-2b's figures split into named terms, op by op on both sides (the
# patterns name its widths; other archs have no terms yet): a product,
# collective or buffer (by result, op name or source function; see
# ``--ops``) goes to the first term whose pattern matches it, and what no
# term matches is the remainder, "rest". A term's relation says how the two
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
#   ref only / port only   one side has none;
#   plan         the two sides take different plans for the same work
#                (tests/test_torch_dryrun_reference.py holds the port's side
#                of each such peak term to its closed form).
# The reference's peak (XLA's total_hbm_bytes, a sum of allocations) has one
# more term, not matched but derived: its allocations beyond the buffers live
# at its heap simulator's peak.
MODEL = 16                      # the production meshes' ``model`` axis
RATIOS = {"same": 1.0, "f32": 2.0, "3 copies": 3.0, "slots whole": float(MODEL),
          "split:model": 1.0 / MODEL}
TERMS_ARCH = "gemma2-2b"
BEYOND_HEAP = ("XLA's allocations beyond the buffers live at its heap simulator's peak "
               "(buffers in allocations of their own, fragmentation)")
# (modes, metric, name, relation, reference pattern, port pattern)
TERMS = [
    # ---- products (flops)
    (("decode",), "flops", "q/k/v projections", "split:model",
     r"bsd,dhk->bshk", r"_heads"),
    (("train",), "flops", "q/k/v weight gradients", "split:model",
     r"^f32\[\d+,144\] transpose.*bsd,dhk->bshk", r"\(2304, \d+\) bwd .*_heads"),
    (("train",), "flops", "o weight gradient", "split:model",
     r"^f32\[144,\d+\] transpose.*bshk,hkd->bsd", r"\(2048, 2304\) bwd .*output_proj"),
    (("train", "prefill"), "flops", "q/k/v projections and their input gradients", "same",
     r"bsd,dhk->bshk", r"_heads"),
    ((), "flops", "o projection and its input gradient", "same", r"bshk,hkd->bsd", r"output_proj"),
    ((), "flops", "attention (scores and values; K2, K3 or the chunked softmax)", "same",
     r"bqkgd|bkgqc|bkgd,bskd|bkgs,bskd|^f32\[(\d+,){2,}\d+\] \?$",
     r"flash_attention|decode_attention|attention_chunked"),
    (("train",), "flops", "remat: the reference recomputes the w_out product of a repeat's "
     "first layer, the port's checkpoint stops before it", "ref only",
     r"f32\[\d+,2304\] .*rematted_computation/dot_general$", r"$^"),
    (("prefill",), "flops", "logits of the last position (the reference's multi-pod compile "
     "fuses the product, and its hlo_analysis counts no fused product)", "plan",
     r"^f32\S+ ((jvp\(\)/|transpose\(jvp\(\)\)/)?dot_general|\?)$", r"unembed"),
    ((), "flops", "logits (the tied unembedding) and their gradients", "same",
     r"^f32\S+ ((jvp\(\)/|transpose\(jvp\(\)\)/)?dot_general|\?)$", r"unembed"),
    ((), "flops", "MLP products and their gradients", "same", r"dot_general$", r"mlp_apply"),
    # ---- collectives
    (("decode",), "collectives", "q/k/v: the port gathers wq, wk, wv over data (FSDP); the "
     "reference moves the batch onto model and all-reduces partial q, k, v over data",
     "plan", r"^all-reduce .*bsd,dhk->bshk", r"fsdp_gathered < \S+_flat_weight < \S+_heads"),
    (("decode",), "collectives", "cache write: the reference gathers every row's new k/v to "
     "write its slots, the port writes each rank's own", "ref only", r"scatter$", r"$^"),
    (("decode",), "collectives", "attention over the slots split on model: the outputs, "
     "maxima and sums all-reduced", "plan",
     r"bkgs,bskd->bkgd|reduce_sum$|reduce_max$", r"merge_shards"),
    (("train",), "collectives", "remat weight gathers: each side gathers the weights again "
     "for its recomputation (the reference half of its w_out gathers in the backward proper)",
     "f32", r"^all-gather .*(rematted_computation|transpose\(jvp\(\)\).*checkpoint/dot_general$)",
     r"^all_gather\S* .* remat .*fsdp_gathered"),
    ((), "collectives", "FSDP weight gathers", "f32",
     r"^all-gather K=\d+ f32\S+ (jvp\(\)/)?(while/body/closed_call/)?(bsd,dhk->bshk/|bshk,hkd->bsd/)?dot_general$",
     r"^all_gather\S* torch.bfloat16 .*fsdp_gathered"),
    ((), "collectives", "the MLP output's all-reduce over model", "f32",
     r"^all-reduce K=\d+ f32\[\d+,\d+,2304\] (jvp\(\)/)?while/body/closed_call/dot_general$",
     r"^all_reduce\S* torch.bfloat16 \S+ \S+ \S+ parallel/sharding.py:forward < .*mlp_apply"),
    (("train",), "collectives", "the residual stream's gradient all-reduced over model (the "
     "reference: the MLP input's two partial gradients; the port: at the attention and MLP "
     "outputs)", "f32",
     r"^all-reduce K=\d+ \(f32\[\d+,\d+,2304\] transpose\(jvp\(\)\)/while/body/closed_call/checkpoint/dot_general$",
     r"bwd parallel/sharding.py:constrain .*(output_proj|mlp_apply)"),
    (("train",), "collectives", "remat: the reference recomputes a repeat's first MLP output "
     "and its all-reduce", "ref only", r"^all-reduce .*rematted_computation/dot_general$", r"$^"),
    (("train",), "collectives", "the logits' input gradient all-reduced over model (the port "
     "leaves it to the residual's)", "ref only",
     r"^all-reduce K=\d+ \(?f32\[\d+,\d+,2304\] transpose\(jvp\(\)\)/dot_general$", r"$^"),
    (("train",), "collectives", "loss and norms: log-sum-exp's maximum and sum, the gold "
     "logit, the loss's and the gradients' global norm's sums", "plan",
     r"take_along_axis|reduce_max$|jvp\(\)/reduce_sum$|K=\d+ f32\[\] reduce_sum$"
     r"|K=\d+ \((f32\[\],? ?(/\*index=\d+\*/)?)+\)? reduce_sum$",
     r"parallel/sharding.py:reduced < models/model.py|^all_reduce\S* torch.float32 \(\) "),
    ((), "collectives", "embedding lookup and its gradient (the reference gathers every row "
     "over d-slices; the port gathers the table's d and sums its vocab slice's rows)", "plan",
     r"gather$|scatter-add$", r"embed_lookup|_sharded_rows"),
    (("train",), "collectives", "weight-gradient reductions (the reference all-reduces, over "
     "model, weight gradients it split by batch there; the port reduce-scatters each over "
     "data, FSDP, and all-reduces the replicated norm scales')", "plan",
     r"transpose\(jvp\(\)\)|f32\[16000,2304\]", r"bwd parallel/sharding.py:fsdp_gathered|placed_like"),
    # ---- memory at the peak (XLA's buffer assignment at its heap peak; the
    # port's storages live at its peak)
    ((), "peak", "arguments: parameters, optimizer state, inputs (not the decode cache, not "
     "the optimizer's int32 scalars)", "same",
     r"^parameter [^(]", r"^argument (?!torch.bfloat16 \(\d+, \d+, 4, 256\)|torch.int32 \(\))"),
    (("decode",), "peak", "the KV cache: the reference's layer loop holds f32 copies of k and v "
     "and two bf16 copies of one; the port updates its argument in place", "3 copies",
     r"\[13,\d+,\d+,4,256\]", r"^argument torch.bfloat16 \(\d+, \d+, 4, 256\)"),
    (("prefill",), "peak", "the KV cache being filled: the reference's split over the batch, "
     "the port's over the batch and the slots", "slots whole",
     r"\[13,\d+,\d+,4,256\]", r"init_cache"),
    (("decode",), "peak", "the unembedding table gathered over data: the reference's in f32, "
     "the port's in bf16 twice (the all-gather's buffer and its concatenation)", "same",
     r"f32\[2304,16000\]", r"fsdp_gathered < models/layers.py:unembed"),
    (("prefill",), "peak", "the unembedding table gathered over data in f32 (the port's peak "
     "comes before it gathers the table)", "ref only",
     r"f32\[2304,16000\]", r"fsdp_gathered < models/layers.py:unembed"),
    ((), "peak", "weights for products: the reference's f32 copies of bf16 weights (XLA's CPU "
     "backend converts before a product) and f32 weight gradients; the port's weights "
     "gathered over data (FSDP)", "plan",
     r"f32\[(13,)?(144|576|2304|2048|1024|8|16000|256000),(144|576|2304|2048|1024|8|4|256|16000)[,\]]",
     r"fsdp_gathered"),
    ((), "peak", "attention: q, k, v, the scores and the online softmax's state (the reference's "
     "jnp attention; the port's chunked softmax in training, K2 and K3 keeping theirs on chip), "
     "the output and its projection, the RoPE tables", "plan",
     r"\[(\d+,){4,}\d+\]|\[(\d+,)?4,|8192,1024\]|^parameter \(s32\[\], f32|1,128\]",
     r"attention_chunked|flash_attention|_mask_block|decode_attention|_decode_shards|"
     r"merge_shards|project_qkv|_heads|output_proj"),
    ((), "peak", "activations: the residual stream, the norms, the MLP and the loss (train: the "
     "checkpointed layer inputs), indices, masks and scalars", "plan",
     r",2304\]|,576\]|,144\]|\[2304,\d+\]|,1\]|(pred|s32|u32)\[|f32\[\d*\] |^parameter \(s32\[\], bf16",
     r"models/(model|layers)\.py|^ones_like\.default  |^argument torch.int32 \(\)"),
]


def terms_of(mode: str, metric: str, ref_ops, port_ops, ref_total: float, port_total: float,
             derived=()):
    """[name, relation, reference amount, port amount] for each term of the
    metric that either side has, then the ``derived`` terms (already
    reckoned), then the unmatched remainder, "rest", where there is one."""
    rules = [(name, rel, re.compile(rp), re.compile(pp))
             for modes, m, name, rel, rp, pp in TERMS if m == metric and (not modes or mode in modes)]
    sums = {name: [0.0, 0.0] for name, *_ in rules}
    for side, ops in ((0, ref_ops), (1, port_ops)):
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


def named(mode: str, ref, port):
    """{metric: terms} of a gemma2-2b cell, from both sides' ``--ops``
    breakdowns."""
    beyond = [BEYOND_HEAP, "ref only", peak_of(ref) - ref["ops"]["heap_peak"], 0.0]
    return {metric: terms_of(mode, metric, ref["ops"][key], port["ops"][key], rt, pt, derived)
            for metric, key, rt, pt, derived in (
                ("flops", "flops", ref["flops_per_device"], port["flops_per_device"], ()),
                ("collectives", "collectives", ref["collective_total_effective"],
                 port["collective_total_effective"], ()),
                ("peak", "peak_live", peak_of(ref), peak_of(port), (beyond,)))}


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
                    help="ARCH:SHAPE:MESH ... (default: gemma2-2b's six cells)")
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
    cells = ([tuple(c.split(":")) for c in args.cells] if args.cells else GEMMA2_CELLS)
    if args.write and not args.ops and any(arch == TERMS_ARCH for arch, *_ in cells):
        ap.error(f"--write of {TERMS_ARCH}'s cells needs --ops (their named terms)")
    book = json.loads(REFERENCE_CELLS.read_text()) if REFERENCE_CELLS.exists() else {"cells": {}}
    refs = reference_cells(cells, args.ops)
    for arch, shape, mesh in cells:
        key = cell_key(arch, shape, mesh)
        ref = refs[key]
        port = port_cell(arch, shape, mesh, args.ops)
        terms = (named(ALL_SHAPES[shape].mode, ref, port)
                 if args.ops and arch == TERMS_ARCH else None)
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
