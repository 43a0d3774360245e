"""The zoo's dry-run cells against the reference's compiled program, through
``launch/reference_cells.json`` (written by ``tools/dryrun_vs_ref.py``), and
the faults the comparison found.

* Both sides of the twelve zoo cells (granite-moe-3b-a800m, mamba2-2.7b,
  recurrentgemma-9b and seamless-m4t-medium x train_4k, prefill_32k and
  decode_32k on (16, 16)) are recomputed here op by op: the reference's
  compiled programs in one subprocess (XLA's memory analysis,
  ``hlo_analysis.analyze`` and the buffer assignment's peak), the port's
  steps in three (rank 0 of a fake 256-rank group, meta tensors; the fake
  group is process-global). Their figures, and the named terms the tool
  splits each figure outside its band into, equal the file's.
* The bounds: argument bytes equal the reference's, less those ``jax.jit``
  drops (arguments a step never reads); FLOPs within 2%, effective
  collective bytes within 0.8-1.25x and the peak within 0.5-1.25x of XLA's
  total_hbm_bytes, or else the figure's terms sum to both totals with no
  remainder ("rest"), each term's relation holds exactly, no op is matched
  by two terms' patterns, and the port's side of each "plan" term has its
  closed form from the config.
* F5: mamba2's SSD projects each part of its fused input projection
  against its own columns; no op of ``ssd.py`` gathers the projection over
  ``model``, and the scan's tiles hold nh / 16 heads a rank.
* F6: a decode step brings its rows to the weights; seamless's moves no
  gather of its 256,206-row table, and every zoo decode cell moves fewer
  collective bytes than before the repair.
* F7: the reference's TP MoE (granite) sums ``model`` copies of its output,
  the port's equals the dense oracle.
* F8 (repaired): seamless train_4k's peak holds two whole-vocab f32 logits
  tensors, as the reference does (the parent's loss held four).
"""
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import dryrun_vs_ref as T  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.shapes import ALL_SHAPES  # noqa: E402
from repro_torch.launch.dryrun import REFERENCE_CELLS  # noqa: E402

BOOK = json.loads(REFERENCE_CELLS.read_text())
CELLS = [T.cell_key(*c) for c in T.ZOO_CELLS]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
# argument bytes ``jax.jit`` drops from the reference's program: mamba2's
# decode ``pos`` (the SSD never reads it; 8 int32), seamless's decode
# encoder and cross-attention K/V weights (a step reads the cached K/V)
DROPPED = {"mamba2-2.7b__decode_32k__single": 32,
           "seamless-m4t-medium__decode_32k__single": 1_487_872}
# the decode cells' collective bytes before the repair of F6 (the parent's
# reference_cells.json)
BEFORE_F6 = {"granite-moe-3b-a800m": 1026403200.0, "mamba2-2.7b": 834912000.0,
             "recurrentgemma-9b": 1179056640.0, "seamless-m4t-medium": 1007884800.0}
# three subprocesses of about equal work
GROUPS = (("mamba2-2.7b:train_4k", "granite-moe-3b-a800m:decode_32k",
           "seamless-m4t-medium:decode_32k", "recurrentgemma-9b:decode_32k"),
          ("mamba2-2.7b:prefill_32k", "recurrentgemma-9b:train_4k", "mamba2-2.7b:decode_32k"),
          ("granite-moe-3b-a800m:train_4k", "granite-moe-3b-a800m:prefill_32k",
           "seamless-m4t-medium:train_4k", "seamless-m4t-medium:prefill_32k",
           "recurrentgemma-9b:prefill_32k"))

_PORT_SCRIPT = textwrap.dedent("""
    import json, logging, sys
    sys.path.insert(0, sys.argv[1])
    import dryrun_vs_ref as T
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    out = {}
    for cell in sys.argv[2:]:
        arch, shape = cell.split(":")
        out[T.cell_key(arch, shape, "single")] = T.port_cell(arch, shape, "single", ops=1)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def live():
    """Both sides of the twelve cells with their breakdowns by op (the
    reference's compiles in one subprocess, the port's steps in three, side
    by side), and the named terms made from them."""
    ref = subprocess.Popen([sys.executable, "-c", T._REFERENCE_SCRIPT, "1",
                            *(":".join(c) for c in T.ZOO_CELLS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env={**ENV, "JAX_PLATFORMS": "cpu"})
    ports = [subprocess.Popen([sys.executable, "-c", _PORT_SCRIPT, str(ROOT / "tools"), *group],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
             for group in GROUPS]
    out = {"port": {}}
    for proc in ports:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr[-3000:]
        out["port"].update(json.loads(stdout.strip().splitlines()[-1]))
    stdout, stderr = ref.communicate(timeout=900)
    assert ref.returncode == 0, stderr[-3000:]
    refs = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    out["reference"] = {rec.pop("cell"): rec for rec in refs}
    out["terms"] = {cell: T.named(cell.split("__")[0], _mode(cell), out["reference"][cell],
                                  out["port"][cell]) for cell in CELLS}
    return out


def _mode(cell):
    return ALL_SHAPES[cell.split("__")[1]].mode


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, str):
        return a == b
    return a == b or math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_figures_equal_a_live_compile(live, cell):
    for key in T.SUMMARY_KEYS:
        assert _equal(live["reference"][cell][key], BOOK["cells"][cell]["reference"][key]), key


@pytest.mark.parametrize("cell", CELLS)
def test_port_records_equal_the_file(live, cell):
    rec = live["port"][cell]
    for key in T.SUMMARY_KEYS:
        assert _equal(rec[key], BOOK["cells"][cell]["port"][key]), key


@pytest.mark.parametrize("cell", CELLS)
def test_named_terms_equal_the_file(live, cell):
    """Each figure's terms, both sides matched op by op here, are the
    file's."""
    mine, theirs = live["terms"][cell], BOOK["cells"][cell].get("terms", {})
    assert set(mine) == set(theirs)
    for metric in mine:
        assert [t[:2] for t in mine[metric]] == [t[:2] for t in theirs[metric]], metric
        assert _equal([t[2:] for t in mine[metric]], [t[2:] for t in theirs[metric]]), metric


@pytest.mark.parametrize("cell", CELLS)
def test_port_term_amounts_equal_the_file(live, cell):
    """Each named term's port amount, matched op by op here, is the file's."""
    for metric, terms in BOOK["cells"][cell].get("terms", {}).items():
        mine = {t[0]: t[3] for t in live["terms"][cell][metric]}
        for name, rel, ref_amount, port_amount in terms:
            assert _equal(mine.get(name, 0.0), port_amount), (metric, name)


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(live, cell):
    port = live["port"][cell]["memory_analysis"]["argument_size_in_bytes"]
    ref = live["reference"][cell]["memory_analysis"]["argument_size_in_bytes"]
    assert port - DROPPED.get(cell, 0) == ref


def _relation_holds(rel, ref, port):
    close = lambda a, b: math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)  # noqa: E731
    if rel in T.RATIOS:
        return close(ref, T.RATIOS[rel] * port)
    return {"ref only": port == 0, "port only": ref == 0, "plan": True}[rel]


BANDS = {"flops": (0.98, 1.02), "collectives": (0.8, 1.25), "peak": (0.5, 1.25)}


def _totals(rec, metric):
    if metric == "flops":
        return rec["flops_per_device"]
    if metric == "collectives":
        return rec["collective_total_effective"]
    return T.peak_of(rec)


@pytest.mark.parametrize("metric", list(BANDS))
@pytest.mark.parametrize("cell", CELLS)
def test_within_band_or_named(live, cell, metric):
    """The port's figure within its band of the reference's, or the live
    terms sum to both totals, none is the unnamed remainder, and each
    relation holds ("plan": its closed form, below)."""
    ref, port = live["reference"][cell], live["port"][cell]
    ref_total, port_total = _totals(ref, metric), _totals(port, metric)
    low, high = BANDS[metric]
    if low <= port_total / ref_total <= high:
        return
    terms = live["terms"][cell][metric]
    assert sum(t[2] for t in terms) == pytest.approx(ref_total, rel=1e-9)
    assert sum(t[3] for t in terms) == pytest.approx(port_total, rel=1e-9)
    assert not [t for t in terms if t[0] == "rest"], "a part of the gap is not named"
    broken = [t for t in terms if not _relation_holds(t[1], t[2], t[3])]
    assert not broken, broken


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_op_is_named_once(live, cell, side):
    """No term's pattern is a catch-all: on each side every op of a named
    figure is matched by one term's pattern, never by two, whatever the
    terms' order."""
    arch, mode = cell.split("__")[0], _mode(cell)
    rec = (live["reference"], live["port"])[side][cell]
    for metric in live["terms"][cell]:
        both = T.overlaps(arch, mode, metric, rec["ops"][T.OPS_KEYS[metric]], side)
        assert not both, (metric, both[:3])


def test_no_term_pattern_is_a_catch_all():
    """Every pattern of every term names something: none matches a label
    of plain words."""
    for arch in (*T.ZOO, "gemma2-2b"):
        for modes, metric, name, rel, rp, pp in T.terms_for(arch):
            for pattern in (rp, pp):
                assert not re.search(pattern, "a label of plain words"), (arch, name, pattern)


# ------------------------------------------------- closed forms of the plans
RING = 15 / 16          # an all-gather, reduce-scatter or all-to-all over 16 ranks
AR = 2 * RING           # an all-reduce over 16 ranks
BF, F32 = 2, 4


def _port_closed(cell, args):
    """{term name's start: the port's amount} of the cell's "plan" and "port
    only" terms (and the decode cache's), from the arch's config and shape:
    (16, 16), B/16 rows a rank; ``args`` the port's argument bytes."""
    arch, shape, mesh = cell.split("__")
    cfg, sh = get_config(arch), ALL_SHAPES[shape]
    d, V = cfg.d_model, cfg.vocab_size
    d16, V16 = d // 16, -(-V // 16)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers
    B = sh.global_batch // (2 if mesh == "multi" else 1)      # a pod's rows
    b = B // 16
    out = {}
    if sh.mode == "decode":
        def rows_k(k, n):
            """a product whose K (d) data splits: the step's rows to the K slices
            (an all-to-all in bf16), the f32 partial sums reduce-scattered back"""
            return B * (k // 16) * BF * RING + b * n * F32 * RING

        def rows_n(kx, n, summed):
            """a product whose N data splits: the rows gathered (kx wide), the f32
            partial sums over model all-reduced where model splits K, each rank's
            columns handed back in bf16"""
            return B * kx * BF * RING + (B * n * F32 * AR if summed else 0) + B * n * BF * RING

        logits = rows_k(d, V16) + (B * V16 * BF * RING if V % 16 else 0)
        lookup = B * 4 * RING + B * d16 * BF * RING + (B * d16 * BF * AR if V % 16 == 0 else 0)
        out["embedding lookup"] = lookup
        # the partial logits of the rows brought to the table and their sum; the
        # peaks of granite (its MoE) and mamba2 (its SSD step) come before them
        out["the unembedding"] = (0 if arch in ("granite-moe-3b-a800m", "mamba2-2.7b")
                                  else B * V16 * F32 + b * V16 * F32)
        kv, state = _cache(cfg, sh)
        # the record's argument bytes (held to the reference's) less the cache or state
        out["arguments"] = args - kv - state
        out["the KV cache"], out["the recurrent state"] = kv, state
        if arch == "gemma2-2b":
            qd, kvd, ff16 = hq * dh, hkv * dh, cfg.d_ff // 16
            out["products of a decode step"] = L * (
                rows_k(d, qd // 16) + 2 * rows_k(d, kvd // 16) + rows_n(qd, d16, False)
                + 2 * rows_k(d, ff16) + rows_n(ff16, d16, True)) + logits
            out["attention over the slots"] = L * (b * qd * F32 * AR + 2 * b * hq * F32 * AR
                                                   + B * (qd // 16) * BF * RING
                                                   + 2 * B * (kvd // 16) * BF * RING)
        if arch == "granite-moe-3b-a800m":
            qd, kvd = hq * dh, hkv * dh
            out["products of a decode step"] = L * (rows_k(d, qd // 16) + 2 * rows_k(d, kvd // 16)
                                                    + rows_n(qd, d16, False)) + logits
            out["attention over the slots"] = L * (b * qd * F32 * AR + 2 * b * hq * F32 * AR
                                                   + B * (qd // 16) * BF * RING
                                                   + 2 * B * (kvd // 16) * BF * RING)
            out["the router at a decode step"] = L * d * cfg.num_experts * F32 * RING
            out["logits"] = 2 * B * V16 * d16
            E, mff16, k = cfg.num_experts, cfg.moe_d_ff // 16, cfg.num_experts_per_tok
            cap = 8                                 # an expert's slots for B/16 tokens (factor 2)
            # w_in and w_gate gathered over data (bf16) and the f32 copy of one for
            # its product; w_out gathered
            out["weights for products"] = E * d * mff16 * (2 * BF + F32) + E * mff16 * d * BF
            # the dispatched rows in f32 and their bf16 buffer (a drop slot beside),
            # two f32 expert products; the residual stream, its two norms, q and
            # the attention's output (bf16), k and v's heads; routing's top-k, sort
            # and slots (int64) and weights; the RoPE frequencies
            out["the step's activations"] = (E * cap * d * F32 + (E * cap + 1) * d * BF
                                             + 2 * E * cap * mff16 * F32 + 4 * b * d * BF
                                             + 2 * b * hq * dh * BF + 2 * b * hkv * dh * BF
                                             + 4 * b * k * 8 + b * k * F32 + dh // 2 * F32
                                             + b * k)
        if arch == "mamba2-2.7b":
            di, n2, nh = cfg.d_inner, 2 * cfg.ssm_state_dim, cfg.ssm_num_heads
            out["products of a decode step"] = L * (2 * rows_k(d, di // 16) + rows_k(d, n2 // 16)
                                                    + rows_k(d, nh // 16)
                                                    + rows_n(di // 16, d16, True)) + logits
            out["the SSD's B and C"] = L * B * (n2 // 16) * BF * RING
            conv, hl, P, N, cw = (di + n2) // 16, nh // 16, cfg.ssm_head_dim, cfg.ssm_state_dim, \
                cfg.conv_width
            out["the SSD's parts regrouped"] = L * ((2 * di + n2 + nh) // 16 * d16 * BF
                                                    + b * (cw - 1) * conv * (F32 + BF)
                                                    + conv * cw * BF + conv * BF) * RING
            # the state update's three f32 (B/16, nh/16, P, N) tensors; the residual and
            # its norm; the conv window regrouped (f32 in, bf16 out) and the parts'
            # windows and outputs; x, B, C, dt in f32 and the head vectors
            out["the step's activations"] = (3 * b * hl * P * N * F32 + 2 * b * d * BF
                                             + b * (cw - 1) * conv * (F32 + BF)
                                             + b * cw * (di // 16 + n2 // 16) * BF
                                             + b * hl * P * F32 + 2 * b * N * F32
                                             + 2 * b * (di // 16) * BF + b * n2 * BF
                                             + 2 * b * hl * F32 + 3 * hl * F32)
        if arch == "recurrentgemma-9b":
            ff16, rw16 = cfg.d_ff // 16, cfg.rglru_width // 16
            rec = sum(k == "rglru" for k in cfg.layer_kinds())
            att = L - rec
            out["products of a decode step"] = (
                L * (2 * rows_k(d, ff16) + rows_n(ff16, d16, True))
                + rec * (2 * rows_k(d, rw16) + rows_n(rw16, d16, True))
                + att * (rows_k(d, hq * dh // 16) + 2 * rows_k(d, hkv * dh // 16)
                         + rows_n(hq * dh, d16, True)) + logits)
            out["attention over the slots"] = att * (b * hq * dh * F32 * AR + 2 * b * hq * F32 * AR
                                                     + B * hkv * dh * BF * RING
                                                     + 2 * B * (hkv * dh // 16) * BF * RING)
            out["the RG-LRU's state"] = state
            out["the step's activations"] = b * d * BF + dh // 2 * F32   # the final norm; RoPE
        if arch == "seamless-m4t-medium":
            ff16 = cfg.d_ff // 16
            h16 = hq // 16
            out["attention over the slots"] = L * (2 * b * hq * dh * F32 * AR + 4 * b * hq * F32 * AR
                                                   + 4 * B * h16 * dh * BF * RING)
            out["the step's activations"] = b * d * BF + dh // 2 * F32   # the final norm; RoPE
            out["products of a decode step"] = L * (4 * rows_k(d, hq * dh // 16)
                                                    + 2 * rows_n(hq * dh, d16, True)
                                                    + rows_k(d, ff16) + rows_n(ff16, d16, True)) + logits
    if sh.mode in ("train", "prefill"):
        t = B * sh.seq_len // 16                    # the rows of a rank (its batch's tokens)
        vl = V // 16 if V % 16 == 0 else V          # the table's rows a rank holds
        table = 16 * vl * d16 * BF * RING           # the table's d gathered over data
        leaves = [x for x in _leaves(cfg) if "/moe/w_" not in x[0]]
        if sh.mode == "prefill":
            out["the logits of the prompt's last position"] = table
            out["embedding lookup"] = table + (t * d * BF * AR if V % 16 == 0 else 0)
        else:
            out["embedding lookup"] = (table + vl * d16 * BF * RING
                                       + {"granite-moe-3b-a800m": 0, "mamba2-2.7b": 1,
                                          "recurrentgemma-9b": 2}.get(arch, 0) * t * d * BF * AR)
            if arch == "seamless-m4t-medium":       # the decoder's rows: S / 4 target tokens
                out["embedding lookup"] += t // 4 * d * BF * AR
            out["weight-gradient reductions"] = sum(
                _local(shape, nb, dsp, msp) * (RING if dsp else AR)
                for path, shape, nb, dsp, msp in leaves)
            # a norm's scale gradient is all-reduced over model too where the norm feeds
            # a product that splits its columns over model (its input's gradient a sum
            # pending there): mamba2's ln1 (w_in), recurrentgemma's MLP and RG-LRU norms
            # and its final norm (the vocab split), seamless's norms before q (16 heads
            # split), the MLP and the cross-attention's k/v (the encoder's final norm)
            partial = {"mamba2-2.7b": L,
                       "recurrentgemma-9b": L + sum(k == "rglru" for k in cfg.layer_kinds()) + 1,
                       "seamless-m4t-medium": 3 * L + 2 * cfg.num_encoder_layers + 1}.get(arch, 0)
            out["weight-gradient reductions"] += partial * d * F32 * AR
            out["the loss and the gradients' norm"] = 6 * F32 * AR + (
                3 * t * F32 * AR if V % 16 == 0 else 0)
        if arch == "granite-moe-3b-a800m" and sh.mode == "train":
            E, mff, k = cfg.num_experts, cfg.moe_d_ff, cfg.num_experts_per_tok
            out["the TP MoE's input and gates' gradients"] = L * (t * d * BF + t * k * F32) * AR
            out["the TP MoE's expert weights' gradients"] = 3 * L * (
                16 * E * d * (mff // 16) + E * d16 * mff) * BF * RING
            out["the loss and the gradients' norm"] = 3 * F32 * AR
        if arch == "mamba2-2.7b":
            di, n2, nh, cw = cfg.d_inner, 2 * cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.conv_width
            parts = (2 * di + n2 + nh) // 16        # w_in's columns a rank holds
            conv = (di + n2) // 16                  # the conv's channels a rank holds
            passes = 3 if sh.mode == "train" else 1  # forward, recomputation, backward
            state = (b * (cw - 1)) * conv * BF * RING * (2 if sh.mode == "train" else 1)
            out["the SSD's parts regrouped"] = L * (passes * (parts * d16 + conv * cw + conv)
                                                    * BF * RING) + L * state
            out["the SSD's B and C"] = L * 16 * t * (n2 // 16) * BF * RING * (
                2 if sh.mode == "train" else 1) + (L * t * (n2 // 16) * BF * RING
                                                  if sh.mode == "train" else 0)
            if sh.mode == "train":
                q, nc, hl, P, N = cfg.ssm_chunk, sh.seq_len // cfg.ssm_chunk, nh // 16, \
                    cfg.ssm_head_dim, cfg.ssm_state_dim
                intra = b * nc * hl * 2 * q * q * P         # (q x q)(q x P) a chunk and head
                cb = b * nc * 2 * q * q * N                  # C·Bᵀ, whole on every model rank
                s_in = b * nc * 2 * hl * P * N * q           # the chunks' states
                inter = b * nc * 2 * q * hl * P * N          # the states' outputs
                # forward and recomputation; the backward two products a product, the
                # first chunk's incoming state needing no gradient
                out["the SSD's chunked scan"] = L * (2 * (intra + cb + s_in + inter)
                                                     + 2 * (intra + cb + s_in)
                                                     + inter * (2 * nc - 1) // nc)
                out["the TP products' outputs"] = (2 * L - 1) * t * d * BF * AR
                out["weight-gradient reductions"] += 3 * L * nh * F32 * RING
                out["the SSD's gated norm and its gradient"] = (L * t * (di // 16) * F32 * RING
                                                                + 2 * L * t * F32 * AR)
        if arch == "seamless-m4t-medium" and sh.mode == "train":
            le, td = cfg.num_encoder_layers, t // 4
            # the encoder's attention output (forward, recomputation, backward) and
            # MLP output (forward, backward); the decoder's self- and cross-attention
            # outputs (the same three each) and MLP output (its first layer's gradient
            # at the lookup)
            out["the TP products' outputs"] = (5 * le * t + (6 * L + 2 * L - 1) * td) * d * BF * AR
        if arch == "recurrentgemma-9b" and sh.mode == "train":
            rec = sum(k == "rglru" for k in cfg.layer_kinds())
            att = L - rec
            out["the TP products' outputs"] = (2 * L + 3 * rec + 4 * att) * t * d * BF * AR
            out["FSDP weight gathers"] = table + 2 * sum(
                _local(shape, nb, False, msp) * RING for path, shape, nb, dsp, msp in leaves
                if dsp and "embed" not in path)
            out["the MQA's k and v gradients"] = 2 * att * t * hkv * dh * BF * AR
    return out


def _cache(cfg, sh):
    """(the KV cache's bytes, the recurrent state's) a rank holds at a decode
    step: k and v (and seamless's cross-attention ck and cv) in bf16 of every
    attention layer, the slots split over model (recurrentgemma's local
    window's); the SSD's state (B/16, nh/16, P, N) and the conv's window, the
    RG-LRU's state and window, in f32."""
    b, kinds = sh.global_batch // 16, cfg.layer_kinds()
    kv = 2 * b * cfg.num_kv_heads * cfg.head_dim * BF
    if cfg.name.startswith("mamba2"):
        conv = (cfg.d_inner + 2 * cfg.ssm_state_dim) // 16
        return 0, len(kinds) * b * (cfg.ssm_num_heads // 16 * cfg.ssm_head_dim
                                    * cfg.ssm_state_dim + (cfg.conv_width - 1) * conv) * F32
    if cfg.name.startswith("recurrentgemma"):
        rec = sum(k == "rglru" for k in kinds)
        return ((len(kinds) - rec) * kv * cfg.local_window // 16,
                rec * b * cfg.conv_width * (cfg.rglru_width // 16) * F32)
    return len(kinds) * kv * sh.seq_len // 16 * (2 if cfg.is_encoder_decoder else 1), 0


def _leaves(cfg, mode="train"):
    """[(path, global shape, dtype bytes, data-split, model-split)] of the
    arch's parameters on (data 16, model 16) under the mode's rules."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import MeshShape, make_env
    env = make_env(MeshShape((16, 16), ("data", "model")), mode)
    out = []

    def walk(shape, spec, path):
        if isinstance(shape, dict):
            for k in shape:
                walk(shape[k], spec[k], f"{path}/{k}")
        elif isinstance(shape, (list, tuple)) and not hasattr(shape, "shape"):
            for i, (a, s) in enumerate(zip(shape, spec)):
                walk(a, s, f"{path}/{i}")
        else:
            axes = [a if isinstance(a, tuple) else ((a,) if a else ()) for a in
                    env.pspec(*spec, shape=tuple(shape.shape))]
            flat = [a for t in axes for a in t]
            out.append((path, tuple(shape.shape), torch.finfo(shape.dtype).bits // 8,
                        "data" in flat, "model" in flat))
    walk(M.param_shapes(cfg), M.param_specs(cfg), "")
    return out


def _local(shape, nbytes, data, model):
    return math.prod(shape) * nbytes // ((16 if data else 1) * (16 if model else 1))


@pytest.mark.parametrize("cell", CELLS)
def test_plan_terms_have_their_closed_forms(live, cell):
    """Every "plan" and "port only" term's port amount equals its closed form
    from the config (``_port_closed``), so a term the two sides split by
    different plans still holds an amount."""
    want = _port_closed(cell, live["port"][cell]["memory_analysis"]["argument_size_in_bytes"])
    for metric, terms in live["terms"][cell].items():
        for name, rel, ref_amount, port_amount in terms:
            if rel in ("plan", "port only"):
                key = next((k for k in want if name.startswith(k)), None)
                assert key is not None, (metric, name)
                assert math.isclose(port_amount, want[key], rel_tol=1e-12, abs_tol=1e-6), \
                    (metric, name, port_amount, want[key])


def _shape(label):
    m = re.search(r"torch\.\w+ \(([\d, ]*)\)", label)
    return tuple(int(x) for x in m.group(1).split(",") if x.strip()) if m else ()


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_f5_the_ssd_gathers_no_projection(live, shape):
    """mamba2: of the collectives that ``ssd.py`` causes, the only gather of
    activations is B‖C's after its conv (2N columns, 1/16 of them a rank,
    gathered over ``model``); the weights' parts are regrouped (one
    all-to-all) and gathered over ``data`` (FSDP), or the decode step's rows
    come to them (F6). The scan's f32 products run on nh / 16 heads a rank:
    the intra-chunk product is a batch of B/16 · nc · nh/16 (q x q)·(q x P)
    products."""
    cfg = get_config("mamba2-2.7b")
    rec = live["port"][f"mamba2-2.7b__{shape}__single"]
    gathers = [(label, v) for label, v in rec["ops"]["collectives"]
               if "models/ssd.py" in label and label.startswith("all_gather")
               and "fsdp_gathered" not in label and "rows_product" not in label]
    assert gathers, "B‖C's gather"
    for label, _ in gathers:
        assert _shape(label)[-1] == 2 * cfg.ssm_state_dim // T.MODEL, label
    assert not [label for label, _ in rec["ops"]["collectives"] if "_split_proj" in label]
    if shape == "prefill_32k":
        b, s = ALL_SHAPES[shape].global_batch // 16, ALL_SHAPES[shape].seq_len
        q = cfg.ssm_chunk
        batch = b * (s // q) * cfg.ssm_num_heads // T.MODEL
        intra = [label for label, _ in rec["ops"]["flops"] if "ssd.py:_scan" in label
                 and _shape(label) == (batch, q, cfg.ssm_head_dim)]
        assert intra, "the intra-chunk product on nh / 16 heads"
        assert rec["flops_per_device"] / BOOK["cells"][f"mamba2-2.7b__{shape}__single"][
            "reference"]["flops_per_device"] == pytest.approx(1.0, abs=0.02)


def test_f6_seamless_decode_gathers_no_table(live):
    """seamless decode_32k: neither the lookup nor the unembedding gathers
    the 256,206 x 1,024 table; the step's collective bytes are within
    1.25x of the reference's, and its unembedding runs the reference's
    FLOPs: 2 · B · V · d / 16 (the model axis splits the vocab the rules
    leave whole)."""
    cfg = get_config("seamless-m4t-medium")
    cell = "seamless-m4t-medium__decode_32k__single"
    rec = live["port"][cell]
    for label, _ in rec["ops"]["collectives"]:
        assert "fsdp_gathered" not in label and "_sharded_rows" not in label, label
        assert cfg.vocab_size * cfg.d_model // 16 > math.prod(_shape(label)), label
    assert rec["collective_total_effective"] <= 1.25 * BOOK["cells"][cell]["reference"][
        "collective_total_effective"]
    unembed = sum(v for label, v in rec["ops"]["flops"] if "unembed" in label)
    b = ALL_SHAPES["decode_32k"].global_batch
    assert unembed == 2 * b * math.ceil(cfg.vocab_size / T.MODEL) * (cfg.d_model // 16)


@pytest.mark.parametrize("arch", list(BEFORE_F6))
def test_f6_decode_moves_fewer_bytes(live, arch):
    rec = live["port"][f"{arch}__decode_32k__single"]
    assert rec["collective_total_effective"] < BEFORE_F6[arch]


_F7_SCRIPT = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import reduced_config
    from repro.models import moe as RMOE
    from repro.parallel.sharding import make_env
    cfg = reduced_config("granite-moe-3b-a800m")
    params, _ = RMOE.moe_init(cfg, jax.random.PRNGKey(0), jnp.float32)
    x = jnp.asarray(0.5 * np.random.default_rng(1).standard_normal((4, 16, cfg.d_model),
                                                                   np.float32))
    out = {"oracle": np.asarray(RMOE.moe_ref(cfg, params, x)).tolist()}
    for dims in ((1, 1), (2, 2), (1, 4)):
        mesh = jax.make_mesh(dims, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:dims[0] * dims[1]])
        env = make_env(mesh, "train")
        fn = jax.jit(lambda p, x: RMOE.moe_apply(env, cfg, p, x, capacity_factor=8.0))
        out["x".join(map(str, dims))] = np.asarray(fn(params, x)).tolist()
    np.save(os.environ["F7_PARAMS"], {k: np.asarray(v) for k, v in params.items()},
            allow_pickle=True)
    print(json.dumps(out))
""")


def test_f7_the_reference_tp_moe_sums_model_copies(tmp_path):
    """F7 (the reference's fault): granite's TP MoE under the reference's
    ``moe_apply`` on Auto-axis host meshes (data, model) of (1, 1), (2, 2)
    and (1, 4), reduced granite, f32, capacity factor 8 (nothing dropped):
    every model rank holds every expert's whole ff ("p_expert_ff" maps to
    no mesh axis) and the body's ``psum`` over ``model`` adds ``model``
    copies, so the output is ``model`` x the dense oracle ``moe_ref``. The
    port's ``moe_apply`` on the same parameters is 1x the oracle."""
    from repro_torch.models import moe as MOE
    params_file = tmp_path / "params.npy"
    proc = subprocess.run([sys.executable, "-c", _F7_SCRIPT], capture_output=True, text=True,
                          timeout=300, env={**ENV, "JAX_PLATFORMS": "cpu",
                                            "F7_PARAMS": str(params_file)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    oracle = np.asarray(out["oracle"], np.float32)
    assert np.abs(oracle).max() > 0.1
    for mesh, model in (("1x1", 1), ("2x2", 2), ("1x4", 4)):
        np.testing.assert_allclose(np.asarray(out[mesh], np.float32), model * oracle,
                                   rtol=0, atol=1e-6 * model)
    cfg = reduced_config("granite-moe-3b-a800m")
    params = {k: torch.from_numpy(v) for k, v in np.load(params_file, allow_pickle=True)
              .item().items()}
    x = torch.from_numpy(0.5 * np.random.default_rng(1).standard_normal((4, 16, cfg.d_model),
                                                                        np.float32))
    port = MOE.moe_apply(cfg, params, x, capacity_factor=8.0)
    np.testing.assert_allclose(port.numpy(), oracle, rtol=0, atol=1e-5)
    np.testing.assert_allclose(MOE.moe_ref(cfg, params, x).numpy(), oracle, rtol=0, atol=1e-5)


def test_f8_seamless_train_peak_holds_four_whole_vocab_logits(live):
    """F8 (repaired, ROADMAP.md; the name is the fault's): seamless's
    256,206-token vocab does not divide ``model``, so every model rank holds
    the whole vocab of its rows' logits. The parent's loss kept four f32
    (B/16, S/4, V) tensors live at the train_4k peak (the f32 logits, the
    log-sum-exp's exponent, the gold logit's zeroed gradient and its
    scatter_add copy), 1.257x the reference's total_hbm_bytes; ``_LseGold``
    keeps two (the saved logits and their gradient), as the reference
    does, and the peak is inside the 0.5-1.25x band."""
    cfg = get_config("seamless-m4t-medium")
    cell = "seamless-m4t-medium__train_4k__single"
    rec = live["port"][cell]
    shape = ALL_SHAPES["train_4k"]
    logits = (shape.global_batch // 16, shape.seq_len // 4, cfg.vocab_size)
    live_logits = [label for label, _ in rec["ops"]["peak_live"]
                   if "torch.float32" in label and _shape(label) == logits]
    assert len(live_logits) == 2, live_logits
    ref = BOOK["cells"][cell]["reference"]["memory_analysis"]["total_hbm_bytes"]
    assert 0.5 * ref <= rec["memory_analysis"]["peak_bytes"] <= 1.25 * ref
