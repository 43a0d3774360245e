"""ctypes loader for the batched engine's C stepper.

Compiles ``_cstep.c`` on first use with the system C compiler (``$CC``,
``cc``, or ``gcc`` — no Python headers needed; the kernel is driven
through ``ctypes`` over the engine's stacked numpy arrays) and caches
the shared object under the repository's ignored ``build/cstep/``, keyed
by a hash of the C source. Everything degrades gracefully:
:func:`available` returns False when there is no compiler, compilation
fails, or ``$REPRO_NO_CSTEP`` is set, and the batched engine falls back
to its pure-numpy lockstep stepper.

The :class:`Params` field order mirrors the ``Params`` struct in
``_cstep.c`` exactly — change both together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from repro_torch.core import faults

_c_i64 = ctypes.c_longlong
_c_f64 = ctypes.c_double
_p_i64 = ctypes.POINTER(ctypes.c_longlong)
_p_i8 = ctypes.POINTER(ctypes.c_byte)
_p_u64 = ctypes.POINTER(ctypes.c_uint64)
_p_f64 = ctypes.POINTER(ctypes.c_double)


class Params(ctypes.Structure):
    _fields_ = [
        # dimensions
        ("B", _c_i64), ("n", _c_i64), ("L", _c_i64), ("P", _c_i64),
        ("nf", _c_i64), ("l1_sets", _c_i64), ("l1_ways", _c_i64),
        ("vnf", _c_i64), ("v_sets", _c_i64), ("v_k", _c_i64),
        ("l2nf", _c_i64), ("l2_sets", _c_i64), ("l2_ways", _c_i64),
        ("nrb", _c_i64), ("dram_channels", _c_i64),
        ("nw", _c_i64), ("list_entries", _c_i64), ("sat_max", _c_i64),
        # config scalars (shape-class constants)
        ("xor_hash", _c_i64), ("reuse_filter", _c_i64),
        ("max_mlp", _c_i64), ("line_shift", _c_i64),
        # per-row config planes (knobs varying within a shape class)
        ("lat_l1", _p_i64), ("lat_smem", _p_i64), ("lat_migrate", _p_i64),
        ("lat_l2", _p_i64), ("lat_dram", _p_i64), ("dram_gap", _p_i64),
        ("low_epoch", _p_i64),
        # per-warp planes
        ("ready", _p_i64), ("toks", _p_i64), ("op_idx", _p_i64),
        ("n_ops", _p_i64), ("pend", _p_i64),
        ("done", _p_i8), ("avail", _p_i8), ("iso", _p_i8),
        ("byp", _p_i8), ("live", _p_i8), ("runnable", _p_i8),
        ("u_of", _p_i64), ("n_of", _p_i64), ("region_blocks", _p_i64),
        ("mem_of", _p_i64), ("until", _p_i64),
        # per-row scalars
        ("cycle", _p_i64), ("instr", _p_i64), ("li", _p_i64),
        ("next_epoch", _p_i64), ("window_mark", _p_i64),
        ("last_wid", _p_i64), ("tick", _p_i64), ("l2_tick", _p_i64),
        # cache planes
        ("l1_tags", _p_i64), ("l1_owners", _p_i64), ("l1_stamp", _p_i64),
        ("l1_reused", _p_i8),
        ("smem_tags", _p_i64), ("smem_owner", _p_i64),
        ("v_addr", _p_i64), ("v_evic", _p_i64), ("v_head", _p_i64),
        ("v_count", _p_i64), ("v_inserts", _p_i64),
        ("l2_tags", _p_i64), ("l2_stamp", _p_i64),
        ("l2_hits", _p_i64), ("l2_misses", _p_i64),
        ("dram_free", _p_i64), ("dram_requests", _p_i64),
        # event counters
        ("cnt_l1_hit", _p_i64), ("cnt_l1_miss", _p_i64),
        ("cnt_smem_hit", _p_i64), ("cnt_smem_miss", _p_i64),
        ("cnt_smem_migrate", _p_i64), ("cnt_bypass", _p_i64),
        ("cnt_evictions", _p_i64), ("cnt_smem_evictions", _p_i64),
        ("cnt_vta_hits", _p_i64), ("vta_hit_events", _p_i64),
        ("cnt_dram_reqs", _p_i64),
        # control
        ("pause", _p_i64), ("last_done_wid", _p_i64),
        # detector hooks
        ("det_ptrs", _p_u64), ("score_ptrs", _p_u64),
        ("score_bump", _p_i64), ("pair_dense", _p_i64),
        # in-stepper epoch / warp-done / timeline servicing
        ("timeline_every", _c_i64), ("tl_cap", _c_i64),
        ("high_epoch", _p_i64), ("aging_high", _p_i64),
        ("stride_ok", _p_i64),
        ("low_cutoff", _p_f64), ("high_cutoff", _p_f64),
        ("fam", _p_i8), ("mode_p", _p_i8), ("mode_t", _p_i8),
        ("allowed_pl", _p_i8), ("isolated_pl", _p_i8),
        ("bypass_pl", _p_i8),
        ("sp_bypass", _p_i8), ("sp_base", _p_i8),
        ("sp_thresh", _p_f64),
        ("det_inst_total", _p_i64), ("det_irs_inst", _p_i64),
        ("irs_off", _p_i64),
        ("low_idx", _p_i64), ("high_idx", _p_i64),
        ("low_base_inst", _p_i64), ("high_base_inst", _p_i64),
        ("high_crossings", _p_i64),
        ("low_base_hits", _p_i64), ("high_base_hits", _p_i64),
        ("low_snap_hits", _p_i64), ("high_snap_hits", _p_i64),
        ("low_snap_win", _p_i64), ("high_snap_win", _p_i64),
        ("low_snap_act", _p_i64), ("high_snap_act", _p_i64),
        ("pair_list", _p_i64), ("wid_sets", _p_i64),
        ("ccws_base", _p_i64), ("ccws_budget", _p_i64),
        ("ciao_stall", _p_i64), ("ciao_iso", _p_i64),
        ("stall_len", _p_i64), ("iso_len", _p_i64),
        ("wd_kind", _p_i64), ("swl_next", _p_i64),
        ("remaining", _p_i64),
        ("tl_cycle", _p_i64), ("tl_act", _p_i64), ("tl_n", _p_i64),
        ("tl_last_instr", _p_i64), ("tl_last_cycle", _p_i64),
        ("tl_dipc", _p_f64),
    ]


_lib = None
_err: Optional[str] = None
# compile-and-load is not reentrant (mkstemp + subprocess + os.replace
# + CDLL): serialise it so parallel chunk workers racing on first use
# build the .so once. The cross-*process* race stays handled by the
# atomic os.replace into the hash-keyed cache path.
_LOAD_LOCK = threading.Lock()
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "cstep"


def _compiler() -> Optional[str]:
    return os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")


def _load() -> None:
    global _lib, _err
    if _lib is not None or _err is not None:
        return
    with _LOAD_LOCK:
        if _lib is not None or _err is not None:
            return
        _load_locked()


def _load_locked() -> None:
    global _lib, _err
    if os.environ.get("REPRO_NO_CSTEP"):
        _err = "disabled via REPRO_NO_CSTEP"
        return
    try:
        src_path = pathlib.Path(__file__).with_name("_cstep.c")
        src = src_path.read_bytes()
        tag = hashlib.sha256(src).hexdigest()[:16]
        cache_dir = BUILD_DIR
        cache_dir.mkdir(parents=True, exist_ok=True)
        so = cache_dir / f"repro_cstep_{tag}.so"
        if not so.exists():
            cc = _compiler()
            if not cc:
                _err = "no C compiler on PATH (cc/gcc/$CC)"
                return
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(cache_dir))
            os.close(fd)
            try:
                # -ffp-contract=off: the fixed-point decision compares
                # must perform exactly one rounding per side (no FMA),
                # bit-matching numpy/XLA (gcc defaults to =fast at -O2)
                subprocess.run(
                    [cc, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                     "-o", tmp, str(src_path)],
                    check=True, capture_output=True)
                os.replace(tmp, so)  # atomic: concurrent builders race-safe
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        lib.step_cells.argtypes = [ctypes.POINTER(Params)]
        lib.step_cells.restype = None
        _lib = lib
    except Exception as exc:  # compile/load failure -> numpy fallback
        _err = f"{type(exc).__name__}: {exc}"


def available() -> bool:
    _load()
    return _lib is not None


def unavailable_reason() -> str:
    _load()
    return _err or "available"


def _i64(a):
    return a.ctypes.data_as(_p_i64)


def _i8(a):
    return a.ctypes.data_as(_p_i8)


def _f64(a):
    return a.ctypes.data_as(_p_f64)


def bind(eng, det_ptrs, score_ptrs, bumps) -> Params:
    """Build the Params view over the engine's stacked arrays. The
    returned struct holds only *borrowed* pointers — ``_keep`` pins the
    pointer tables; the engine itself owns everything else."""
    p = Params()
    p.B, p.n, p.L, p.P = eng.B, eng.n_warps, eng.L, eng.P
    p.nf, p.l1_sets, p.l1_ways = eng.nf, eng.l1_sets, eng.l1_ways
    p.vnf, p.v_sets, p.v_k = eng.vnf, eng.v_sets, eng.v_k
    p.l2nf, p.l2_sets, p.l2_ways = eng.l2nf, eng.l2_sets, eng.l2_ways
    p.nrb, p.dram_channels = eng.nrb, eng.dram_channels
    p.nw, p.list_entries, p.sat_max = eng.nw, eng.list_entries, eng.sat_max
    p.xor_hash = int(eng.xor_hash)
    p.reuse_filter = int(eng.reuse_filter)
    p.max_mlp = eng.max_mlp
    # per-row config planes (heterogeneous knobs within a shape class)
    p.lat_l1, p.lat_smem, p.lat_migrate = \
        _i64(eng.lat_l1), _i64(eng.lat_smem), _i64(eng.lat_migrate)
    p.lat_l2, p.lat_dram, p.dram_gap = \
        _i64(eng.lat_l2), _i64(eng.lat_dram), _i64(eng.dram_gap)
    p.low_epoch = _i64(eng.low_epoch)
    from repro_torch.workloads.tokens import TOKEN_LINE_SHIFT
    p.line_shift = TOKEN_LINE_SHIFT
    p.ready, p.toks = _i64(eng.ready), _i64(eng.toks)
    p.op_idx, p.n_ops, p.pend = \
        _i64(eng.op_idx), _i64(eng.n_ops), _i64(eng.pend)
    p.done, p.avail = _i8(eng.done), _i8(eng.avail)
    p.iso, p.byp, p.live = _i8(eng.iso), _i8(eng.byp), _i8(eng.live)
    p.runnable = _i8(eng.runnable)
    p.u_of, p.n_of = _i64(eng.u_of), _i64(eng.n_of)
    p.region_blocks = _i64(eng.region_blocks)
    p.mem_of, p.until = _i64(eng.mem_of), _i64(eng.until)
    p.cycle, p.instr, p.li = \
        _i64(eng.cycle), _i64(eng.instr), _i64(eng.li)
    p.next_epoch, p.window_mark = \
        _i64(eng.next_epoch), _i64(eng.window_mark)
    p.last_wid, p.tick, p.l2_tick = \
        _i64(eng.last_wid), _i64(eng.tick), _i64(eng.l2_tick)
    p.l1_tags, p.l1_owners, p.l1_stamp = \
        _i64(eng.l1_tags), _i64(eng.l1_owners), _i64(eng.l1_stamp)
    p.l1_reused = _i8(eng.l1_reused)
    p.smem_tags, p.smem_owner = \
        _i64(eng.smem_tags), _i64(eng.smem_owner)
    p.v_addr, p.v_evic = _i64(eng.v_addr), _i64(eng.v_evic)
    p.v_head, p.v_count = _i64(eng.v_head), _i64(eng.v_count)
    p.v_inserts = _i64(eng.v_inserts)
    p.l2_tags, p.l2_stamp = _i64(eng.l2_tags), _i64(eng.l2_stamp)
    p.l2_hits, p.l2_misses = _i64(eng.l2_hits), _i64(eng.l2_misses)
    p.dram_free, p.dram_requests = \
        _i64(eng.dram_free), _i64(eng.dram_requests)
    for name in ("l1_hit", "l1_miss", "smem_hit", "smem_miss",
                 "smem_migrate", "bypass", "evictions", "smem_evictions",
                 "vta_hits"):
        setattr(p, "cnt_" + name, _i64(getattr(eng, "cnt_" + name)))
    p.vta_hit_events = _i64(eng.vta_hit_events)
    p.cnt_dram_reqs = _i64(eng.cnt_dram_reqs)
    p.pause, p.last_done_wid = _i64(eng.pause), _i64(eng.last_done_wid)
    p.det_ptrs = det_ptrs.ctypes.data_as(_p_u64)
    p.score_ptrs = score_ptrs.ctypes.data_as(_p_u64)
    p.score_bump = _i64(bumps)
    p.pair_dense = _i64(eng.pair_dense)
    # in-stepper epoch / warp-done / timeline servicing; the detector
    # knob columns live in the engine's DetPlanes (per-row planes)
    p.high_epoch = _i64(eng.high_epoch)
    p.aging_high = _i64(eng.det_pl.aging_high)
    stride_i64 = eng._stride_ok.astype(np.int64)
    p.stride_ok = _i64(stride_i64)
    p.timeline_every = eng.timeline_every
    p.tl_cap = eng.tl_cap
    p.low_cutoff = _f64(eng.det_pl.low_cutoff)
    p.high_cutoff = _f64(eng.det_pl.high_cutoff)
    p.fam = _i8(eng.fam)
    p.mode_p, p.mode_t = _i8(eng.mode_p), _i8(eng.mode_t)
    p.allowed_pl = _i8(eng.allowed_pl)
    p.isolated_pl = _i8(eng.isolated_pl)
    p.bypass_pl = _i8(eng.bypass_pl)
    p.sp_bypass, p.sp_base = _i8(eng.sp_bypass), _i8(eng.sp_base)
    p.sp_thresh = _f64(eng.sp_thresh)
    pl = eng.det_pl
    p.det_inst_total = _i64(pl.inst_total)
    p.det_irs_inst = _i64(pl.irs_inst)
    p.irs_off = _i64(eng.irs_off)
    p.low_idx, p.high_idx = _i64(pl.low_idx), _i64(pl.high_idx)
    p.low_base_inst = _i64(pl.low_base_inst)
    p.high_base_inst = _i64(pl.high_base_inst)
    p.high_crossings = _i64(pl.high_crossings)
    p.low_base_hits = _i64(pl.low_base_hits)
    p.high_base_hits = _i64(pl.high_base_hits)
    p.low_snap_hits = _i64(pl.low_snap_hits)
    p.high_snap_hits = _i64(pl.high_snap_hits)
    p.low_snap_win = _i64(pl.low_snap_win)
    p.high_snap_win = _i64(pl.high_snap_win)
    p.low_snap_act = _i64(pl.low_snap_act)
    p.high_snap_act = _i64(pl.high_snap_act)
    p.pair_list = _i64(pl.pair_list)
    p.wid_sets = _i64(pl.wid_sets)
    p.ccws_base = _i64(eng.ccws_base)
    p.ccws_budget = _i64(eng.ccws_budget)
    p.ciao_stall, p.ciao_iso = _i64(eng.ciao_stall), _i64(eng.ciao_iso)
    p.stall_len, p.iso_len = _i64(eng.stall_len), _i64(eng.iso_len)
    p.wd_kind, p.swl_next = _i64(eng.wd_kind), _i64(eng.swl_next)
    p.remaining = _i64(eng.remaining)
    p.tl_cycle, p.tl_act = _i64(eng.tl_cycle), _i64(eng.tl_act)
    p.tl_n = _i64(eng.tl_n)
    p.tl_last_instr = _i64(eng.last_instr)
    p.tl_last_cycle = _i64(eng.last_cycle)
    p.tl_dipc = _f64(eng.tl_dipc)
    p._keep = (det_ptrs, score_ptrs, bumps, stride_i64, eng)
    return p


def step(params: Params) -> None:
    # fault-injection site for the resilience tests/chaos smoke: lets a
    # FaultPlan fail or stall individual stepper rounds deterministically
    # (zero-cost None check when no plan is installed)
    faults.fire("stepper.step")
    _lib.step_cells(ctypes.byref(params))
