"""The port's dry run (``launch/dryrun.py``) against the reference's compiled
program, through ``launch/reference_cells.json`` (written by
``tools/dryrun_vs_ref.py``), and the port's memory tracker.

* Both sides of gemma2-2b's six cells (train_4k, prefill_32k, decode_32k on
  (16, 16) and (2, 16, 16)) are recomputed here, op by op: the reference's
  compiled programs (XLA's memory analysis, ``hlo_analysis.analyze`` and
  the buffer assignment's peak) and the port's eager steps. Their figures,
  and the named terms the tool splits each figure into, equal the file's.
  Both run in subprocesses: the reference's dry run asks for 512 host
  devices before JAX starts, and the port's fake process group is
  process-global.
* The bounds: argument bytes equal the reference's; FLOPs within 2% of the
  reference's, effective collective bytes within 0.8-1.25x and the peak
  within 0.5-1.25x of XLA's total_hbm_bytes, or else the figure's terms sum
  to both totals with no remainder ("rest"), and each term's relation holds
  exactly (``tools/dryrun_vs_ref.py`` ``terms_for``: "f32", the reference
  moving in f32 what the port moves in bf16; "split:model", a product the
  reference splits over ``model`` and every model rank of the port
  repeats; ...).
* Closed forms from the config: the largest FLOPs terms on both sides,
  every peak term on the port's side (the port's storages live at its
  peak: arguments, the KV cache, gathered weights, attention, activations)
  and decode's "plan" collective terms on the port's side (the zoo's
  ``_port_closed``).
* ``MemoryTracker``: the peak of three DTensor programs on a fake 8-rank
  group, reckoned by hand in local bytes.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import dryrun_vs_ref as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ALL_SHAPES  # noqa: E402
from repro_torch.launch.dryrun import REFERENCE_CELLS  # noqa: E402
from test_torch_dryrun_zoo import BF, RING, _port_closed  # noqa: E402

BOOK = json.loads(REFERENCE_CELLS.read_text())
CELLS = [T.cell_key(*c) for c in T.GEMMA2_CELLS]
MODEL = T.MODEL                 # the production meshes' ``model`` axis
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

_PORT_SCRIPT = textwrap.dedent("""
    import json, logging, sys
    sys.path.insert(0, sys.argv[1])
    import dryrun_vs_ref as T
    from repro_torch.launch import dryrun as D
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    out = {T.cell_key(*c): T.port_cell(*c, ops=1) for c in T.GEMMA2_CELLS}
    rec = D.run_cell("gemma2-2b", "decode_32k", "single", save=False, verbose=False)
    out["run_cell"] = {"summary": {k: (rec["collectives"][k] if k.startswith("collective")
                                       else rec[k]) for k in T.SUMMARY_KEYS},
                       "reference": rec.get("reference")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def recomputed():
    """Both sides of the six cells with their breakdowns by op (the
    reference's compiles and the port's steps in two subprocesses, side by
    side), and the named terms made from them."""
    ref = subprocess.Popen([sys.executable, "-c", T._REFERENCE_SCRIPT, "1",
                            *(":".join(c) for c in T.GEMMA2_CELLS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env={**ENV, "JAX_PLATFORMS": "cpu"})
    port = subprocess.Popen([sys.executable, "-c", _PORT_SCRIPT, str(ROOT / "tools")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
    out = {}
    for name, proc in (("reference", ref), ("port", port)):
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = stdout
    refs = [json.loads(line) for line in out["reference"].splitlines() if line.startswith("{")]
    out["reference"] = {rec.pop("cell"): rec for rec in refs}
    out["port"] = json.loads(out["port"].strip().splitlines()[-1])
    out["terms"] = {cell: T.named("gemma2-2b", ALL_SHAPES[cell.split("__")[1]].mode,
                                  out["reference"][cell], out["port"][cell]) for cell in CELLS}
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, str):
        return a == b
    return a == b or math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_figures_equal_a_live_compile(recomputed, cell):
    live = recomputed["reference"][cell]
    mine = BOOK["cells"][cell]["reference"]
    for key in T.SUMMARY_KEYS:
        assert _equal(live[key], mine[key]), (key, live[key], mine[key])


@pytest.mark.parametrize("cell", CELLS)
def test_port_records_equal_the_file(recomputed, cell):
    rec = recomputed["port"][cell]
    for key in T.SUMMARY_KEYS:
        assert _equal(rec[key], BOOK["cells"][cell]["port"][key]), key


@pytest.mark.parametrize("cell", CELLS)
def test_named_terms_equal_the_file(recomputed, cell):
    """The terms PERF.md quotes, both sides op by op, as recomputed here."""
    live, mine = recomputed["terms"][cell], BOOK["cells"][cell]["terms"]
    assert set(live) == set(mine)
    for metric in live:
        assert [t[:2] for t in live[metric]] == [t[:2] for t in mine[metric]], metric
        assert _equal([t[2:] for t in live[metric]], [t[2:] for t in mine[metric]]), metric


def test_run_cell_counts_as_the_tool(recomputed):
    """``run_cell`` (what the CLI and chip_smoke.py run) counts as the tool's
    ``port_cell``, and its reference block is the file's with the port's
    share of each figure."""
    cell = "gemma2-2b__decode_32k__single"
    rec = recomputed["port"]["run_cell"]
    for key in T.SUMMARY_KEYS:
        assert _equal(rec["summary"][key], recomputed["port"][cell][key]), key
    block, ref = rec["reference"], BOOK["cells"][cell]["reference"]
    assert block["flops_per_device"] == ref["flops_per_device"]
    assert block["port_over_reference"]["flops"] == pytest.approx(
        rec["summary"]["flops_per_device"] / ref["flops_per_device"], rel=1e-12)
    assert block["port_over_reference"]["peak_to_total_hbm"] == pytest.approx(
        rec["summary"]["memory_analysis"]["peak_bytes"]
        / ref["memory_analysis"]["total_hbm_bytes"], rel=1e-12)


# --------------------------------------------------------- the bounds
def _relation_holds(rel, ref, port):
    close = lambda a, b: math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)  # noqa: E731
    if rel in T.RATIOS:
        return close(ref, T.RATIOS[rel] * port)
    return {"ref only": port == 0, "port only": ref == 0, "plan": True}[rel]


def _held_or_named(terms, metric, ref_total, port_total, low, high):
    """``port_total`` within [low, high] x ``ref_total``, or the cell's terms
    for the metric sum to both totals, none is the unnamed remainder, and
    each relation holds."""
    if low <= port_total / ref_total <= high:
        return
    terms = terms[metric]
    assert sum(t[2] for t in terms) == pytest.approx(ref_total, rel=1e-9)
    assert sum(t[3] for t in terms) == pytest.approx(port_total, rel=1e-9)
    assert not [t for t in terms if t[0] == "rest"], "a part of the gap is not named"
    broken = [t for t in terms if not _relation_holds(t[1], t[2], t[3])]
    assert not broken, broken


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(recomputed, cell):
    assert recomputed["port"][cell]["memory_analysis"]["argument_size_in_bytes"] == \
        recomputed["reference"][cell]["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_flops_within_two_percent_or_named(recomputed, cell):
    ref, port = recomputed["reference"][cell], recomputed["port"][cell]
    _held_or_named(recomputed["terms"][cell], "flops", ref["flops_per_device"],
                   port["flops_per_device"], 0.98, 1.02)


@pytest.mark.parametrize("cell", CELLS)
def test_collective_bytes_within_band_or_named(recomputed, cell):
    ref, port = recomputed["reference"][cell], recomputed["port"][cell]
    _held_or_named(recomputed["terms"][cell], "collectives", ref["collective_total_effective"],
                   port["collective_total_effective"], 0.8, 1.25)


@pytest.mark.parametrize("cell", CELLS)
def test_peak_within_band_or_named(recomputed, cell):
    ref, port = recomputed["reference"][cell], recomputed["port"][cell]
    _held_or_named(recomputed["terms"][cell], "peak", ref["memory_analysis"]["total_hbm_bytes"],
                   port["memory_analysis"]["peak_bytes"], 0.5, 1.25)


def _term(terms, metric, start):
    return next(t for t in terms[metric] if t[0].startswith(start))


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_named_flops_terms_have_their_closed_forms(recomputed, mesh):
    """Decode: the q/k/v products are 2·(B/dp)·d·(Hq+2Hkv)·Dh / model a
    layer on both sides (GSPMD moves the batch onto ``model``; the port
    brings the step's rows to the weights and splits their columns over
    it, the heads not dividing it). Train: the
    q/k/v and o weight gradients are 2·(B·S/dp)·d·(Hq+2Hkv)·Dh and
    2·(B·S/dp)·Hq·Dh·d a layer on the port, a sixteenth on the reference, and
    the reference recomputes one w_out product, 2·(B·S/dp)·(ff/16)·d, a repeat
    of the pattern."""
    cfg = get_config("gemma2-2b")
    dp = 16 * (2 if mesh == "multi" else 1)
    d, dh, hq, hkv, layers = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, \
        cfg.num_layers
    qkv = d * (hq + 2 * hkv) * dh
    terms = recomputed["terms"]
    ref, port = _term(terms[f"gemma2-2b__decode_32k__{mesh}"], "flops", "q/k/v projections")[2:]
    assert port == 2 * (128 // dp) * qkv * layers // MODEL and ref == port
    tokens = 256 * 4096 // dp
    cell = terms[f"gemma2-2b__train_4k__{mesh}"]
    ref, port = _term(cell, "flops", "q/k/v weight gradients")[2:]
    assert port == 2 * tokens * qkv * layers and ref * MODEL == port
    ref, port = _term(cell, "flops", "o weight gradient")[2:]
    assert port == 2 * tokens * hq * dh * d * layers and ref * MODEL == port
    ref, port = _term(cell, "flops", "remat")[2:]
    assert ref == 2 * tokens * (cfg.d_ff // MODEL) * d * (layers // len(cfg.pattern))
    assert port == 0


@pytest.mark.parametrize("cell", [c for c in CELLS if "decode" not in c])
def test_f32_collectives_are_twice_the_ports_bf16(recomputed, cell):
    """The reference's CPU compile runs a bf16 product in f32: its weight
    gathers and the MLP output's all-reduce carry f32, twice the port's
    bf16 bytes, to the byte."""
    for start in ("FSDP weight gathers", "the MLP output's all-reduce"):
        ref, port = _term(recomputed["terms"][cell], "collectives", start)[2:]
        assert port > 0 and ref == 2 * port


def _port_peak(cell: str, memory) -> dict:
    """The port's storages live at its peak, by term (the names' first
    words), reckoned from gemma2-2b's config for one rank: B rows of S
    tokens (the batch split over pod and data), d, Hq/Hkv heads of Dh, L
    layers alternating local (a window of W slots) and global, vocab V."""
    _, shape_name, mesh = cell.split("__")
    cfg, shape = get_config("gemma2-2b"), ALL_SHAPES[shape_name]
    b = shape.global_batch // (32 if mesh == "multi" else 16)
    s, d, hq, hkv, dh = shape.seq_len, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers, v, f = cfg.num_layers, cfg.vocab_size, cfg.head_dim // 2
    # k and v in bf16 of every layer, the slots split over model
    cache = 2 * b * hkv * dh * 2 * (layers // 2) * (s + min(cfg.local_window, s)) // MODEL
    args = memory["argument_size_in_bytes"]
    if shape.mode == "decode":
        # the logits' product over the rows brought to the table (F6): the
        # pod's rows' f32 partial logits against the table's (d/data, V/model)
        # slice (the operands read in bf16) and their sum reduce-scattered back
        rows = shape.global_batch // (2 if mesh == "multi" else 1)
        return {"arguments": args - cache, "the KV cache": cache,
                "the unembedding": 4 * rows * (v // MODEL) + 4 * (rows // 16) * (v // MODEL),
                "attention": f * 4,                 # the RoPE frequencies (K2 keeps the rest)
                "activations": b * d * 2}           # the final norm's output
    if shape.mode == "prefill":
        # at a layer's MLP norm: q and k after RoPE, k's projection and K3's
        # output, all bf16, the o projection's output; the norm's two f32
        # (B, S, d) buffers and four bf16 ones, the positions and the norm's
        # mean
        return {"arguments": args, "the KV cache": cache,
                "attention": b * s * 2 * (2 * hq * dh + 2 * hkv * dh + d) + f * 4,
                "activations": b * s * d * (2 * 4 + 4 * 2) + s * 8 + b * s * 4}
    # train, in a layer's recomputation for its backward: the chunked
    # softmax's f32 tensors for each of n KV chunks of c keys (the softcapped
    # and masked scores, their exponent and the cast probabilities; each
    # chunk's accumulator, k and v in f32, and row statistics; the mask) and
    # the attention output's clone; 25 layers' checkpointed inputs in bf16,
    # eight f32 and two bf16 (B, S, d) buffers of the norms' forward and
    # backward, the token rows' indices, scalars
    c, rows = 1024, b * hq * s
    n = s // c
    attention = (4 * rows * s * 4 + (n + 2) * rows * dh * 4 + 2 * b * hkv * s * dh * 4
                 + b * s * hq * dh * 2 + n * s * c + (4 * n + 2) * rows * 4 + 4 * s * f * 4
                 + f * 4)
    activations = (b * s * d * (2 * (layers - 1) + 8 * 4 + 2 * 2) + b * s * (4 + 4 + 1)
                   + 3 * d * 4 + s * 8 + 8 + 8)
    return {"arguments": args - 8, "weights for products": hq * dh * d * 2,  # wo, gathered
            "attention": attention, "activations": activations}


@pytest.mark.parametrize("cell", CELLS)
def test_port_peak_terms_have_their_closed_forms(recomputed, cell):
    """Every peak term's port side equals its closed form (and the terms
    the form does not name are the port's zeros), so a "plan" term holds
    an amount too."""
    port = recomputed["port"][cell]
    want = _port_peak(cell, port["memory_analysis"])
    got = {}
    for name, rel, ref_amount, port_amount in recomputed["terms"][cell]["peak"]:
        key = next((k for k in want if name.startswith(k)), None)
        if key is None:
            assert port_amount == 0, (name, port_amount)
        else:
            got[key] = port_amount
    assert got == want
    assert sum(want.values()) == port["memory_analysis"]["peak_bytes"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_collective_terms_have_their_closed_forms(recomputed, mesh):
    """decode_32k's "plan" collective terms, the port's side, equal the
    closed forms the zoo's cells are held to (``_port_closed``: the step's
    rows brought to each weight, the attention's merges, the tokens brought
    to the table), a pod's B rows; gemma2-2b's terms count the gathers of
    q/k/v's heads (8 and 4 heads do not divide ``model``) and the lookup's
    rows handed back among the decode products."""
    cell = f"gemma2-2b__decode_32k__{mesh}"
    cfg = get_config("gemma2-2b")
    rows = 128 // (2 if mesh == "multi" else 1)
    heads = cfg.num_layers * rows * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
        // MODEL * BF * RING
    back = rows * (cfg.d_model // 16) * BF * RING
    want = _port_closed(cell, 0)
    want = {"products of a decode step": want["products of a decode step"] + heads + back,
            "attention over the slots": want["attention over the slots"] - heads,
            "embedding lookup": want["embedding lookup"] - back}
    plans = [t for t in recomputed["terms"][cell]["collectives"] if t[1] == "plan"]
    assert len(plans) == 3
    for name, rel, ref_amount, port_amount in plans:
        key = next(k for k in want if name.startswith(k))
        assert math.isclose(port_amount, want[key], rel_tol=1e-12), (name, port_amount, want[key])


# ------------------------------------------------------ the memory tracker
_TRACKER_SCRIPT = textwrap.dedent("""
    import json, logging, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.op_analysis import MemoryTracker
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    def place(shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl, src_data_rank=None)
    def peak(fn, *args):
        t = MemoryTracker()
        t.track(*args)
        with t:
            fn(*args)
        return t.peak
    x = place((64, 32), [Shard(0), Replicate()])
    a = place((64, 32), [Replicate(), Shard(1)])
    b = place((32, 16), [Replicate(), Shard(0)])
    out = {"local": peak(lambda x: (x * 2).sum(), x),
           "gather": peak(lambda x: x.redistribute(mesh, [Replicate(), Replicate()]), x),
           "partial": peak(lambda a, b: (a @ b).redistribute(mesh, [Replicate()] * 2), a, b)}
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_memory_tracker_peaks_are_exact():
    """Rank 0 of a (data 2, model 4) mesh, f32 meta tensors:
    * x (64, 32) split over data (a (32, 32) shard, 4096 B), then x * 2
      (4096 B) and its sum (4 B): 8196 B;
    * x gathered whole (the all-gather's (64, 32) result, 8192 B) beside
      x's shard: 12288 B (the collective's wrap for autograd adds nothing);
    * a (64, 32) split over model by columns (2048 B) times b (32, 16) by
      rows (512 B): a partial (64, 16) product (4096 B) and its all-reduced
      copy (4096 B): 10752 B."""
    proc = subprocess.run([sys.executable, "-c", _TRACKER_SCRIPT], capture_output=True,
                          text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {"local": 8196, "gather": 12288, "partial": 10752}
