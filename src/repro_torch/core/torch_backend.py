"""Lockstep torch stepper for the batched engine: the counterpart of the
reference's jitted ``core/jax_backend.py``.

The engine's stacked state becomes a dict of torch tensors with a leading
batch axis (int64 counters, bool masks, float64 where the engine keeps
float64), on one explicit device. One lockstep iteration dispatches at
most one warp-op per live row, with the full per-access chain (scheduler
pick, L1 way scan, smem migration, VTA FIFO probe/insert with the
interference list, L2 tags, DRAM queue, MLP pending queues) plus the
epoch / warp-retirement / timeline servicing the C stepper runs
in-stepper. Results are written back into the engine's numpy arrays and
``BatchedSMEngine._finalize`` assembles the ``SimResult``s, as for the
numpy and C steppers.

**Bit-exactness contract** (the reference's): every counter is int64,
every cutoff decision is the single-rounding float64 compare
``hits*act <=> cutoff*win`` with operands far below 2**53, sorts are
stable, and arg-reductions break ties on the first index
(``torch.argmax``/``argmin`` return the first extremal index).

**Gating.** The rare per-dispatch events (epoch boundaries, warp
retirement, timeline samples, fully-throttled stretches) act only on their
flagged rows (``where(mask, new, old)`` throughout), so a branch whose mask
is all false is a no-op. On the CPU a branch runs only when a row is
flagged; on CUDA every branch runs, masked, so an iteration never waits on
the host. The run loop tests liveness once every ``chunk`` iterations; an
iteration over rows that are all dead changes nothing. On CUDA one chunk is
captured as a CUDA graph, cached by the static config and the arrays'
shapes, and replayed (the counterpart of ``jax.jit(lax.while_loop)``);
``run_loop(..., graph=False)`` runs the same chunk eagerly instead.

One restructuring against the reference's iteration: a fully-throttled
row's epoch service is merged into the end-of-iteration epoch service.
A throttled row dispatches nothing in that iteration, so nothing between
the two points reads or writes its state, and the two services act on
disjoint rows.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.batched import (F_CCWS, F_CIAO, F_OBJECT, F_STATP,
                                      WD_OBJECT, WD_STATP, WD_SWL)
from repro_torch.core.epoch import _DEAD_KEY, NO_WARP
from repro_torch.core.policies import CCWSPolicy
from repro_torch.core.simulator import _HUGE
from repro_torch.device import resolve_device
from repro_torch.workloads import tokens as _tokens

_SHIFT = _tokens.TOKEN_LINE_SHIFT
_DEAD = int(_DEAD_KEY)
# iterations between two liveness tests (one host sync each); at most
# CHUNK - 1 no-op iterations run past the end
CHUNK = 64


def supports_engine(eng) -> str:
    """Empty string when the engine can run on the torch stepper, else the
    human-readable reason it cannot."""
    if eng.gpu is not None:
        return "multi-SM batches are not supported by the torch stepper " \
               "yet (shared post-L1 planes need phase interleaving); use " \
               "backend='auto'"
    if (eng.fam == F_OBJECT).any() or (eng.wd_kind == WD_OBJECT).any():
        return "batch contains custom policy objects (F_OBJECT/" \
               "WD_OBJECT rows need per-cell Python)"
    return ""


class _Static(NamedTuple):
    """Hashable static config: with the arrays' shapes, the key of the
    CUDA-graph cache."""
    n: int
    L: int
    P: int
    l1_sets: int
    l1_ways: int
    xor_hash: bool
    reuse_filter: bool
    nrb: int
    v_sets: int
    v_k: int
    nw: int
    le: int
    sat_max: int
    l2_sets: int
    l2_ways: int
    dram_channels: int
    max_mlp: int
    timeline_every: int
    tl_cap: int


def _static_of(eng) -> _Static:
    return _Static(
        n=eng.n_warps, L=eng.L, P=eng.P,
        l1_sets=eng.l1_sets, l1_ways=eng.l1_ways,
        xor_hash=bool(eng.xor_hash), reuse_filter=bool(eng.reuse_filter),
        nrb=eng.nrb, v_sets=eng.v_sets, v_k=eng.v_k,
        nw=eng.nw, le=eng.list_entries, sat_max=eng.sat_max,
        l2_sets=eng.l2_sets, l2_ways=eng.l2_ways,
        dram_channels=eng.dram_channels,
        max_mlp=eng.max_mlp,
        timeline_every=eng.timeline_every, tl_cap=eng.tl_cap)


# mutable state: engine attributes; detector planes below with a d_ prefix
_STATE_ATTRS = (
    "ready", "done", "avail", "iso", "byp", "op_idx", "pend",
    "cycle", "instr", "li", "irs_off", "last_wid", "window_mark",
    "last_instr", "last_cycle", "tick",
    "l1_tags", "l1_owners", "l1_reused", "l1_stamp",
    "smem_tags", "smem_owner",
    "v_addr", "v_evic", "v_head", "v_count", "v_inserts",
    "l2_tags", "l2_stamp", "l2_tick", "l2_hits", "l2_misses",
    "dram_free", "dram_requests", "cnt_dram_reqs",
    "cnt_l1_hit", "cnt_l1_miss", "cnt_smem_hit", "cnt_smem_miss",
    "cnt_smem_migrate", "cnt_bypass", "cnt_evictions",
    "cnt_smem_evictions", "cnt_vta_hits", "vta_hit_events",
    "pair_dense", "next_epoch", "remaining",
    "allowed_pl", "isolated_pl", "bypass_pl", "score_pl",
    "sp_bypass", "sp_base", "swl_next",
    "ciao_stall", "ciao_iso", "stall_len", "iso_len",
    "tl_cycle", "tl_dipc", "tl_act", "tl_n",
)
_DET_FIELDS = (
    "inst_total", "irs_inst", "low_idx", "high_idx",
    "low_base_inst", "high_base_inst", "high_crossings",
    "irs_hits", "low_base_hits", "high_base_hits",
    "low_snap_hits", "high_snap_hits", "low_snap_win", "high_snap_win",
    "low_snap_act", "high_snap_act",
    "vta_hits", "interfering", "sat", "pair_list",
)


def _arrays_of(eng):
    """(state, consts) as numpy arrays. Multi-dimensional planes are
    flattened to (B, -1), so every per-row access is one gather or
    scatter along axis 1."""
    B = eng.B
    state = {k: getattr(eng, k) for k in _STATE_ATTRS}
    for f in _DET_FIELDS:
        state["d_" + f] = getattr(eng.det_pl, f)
    state = {k: v.reshape(B, -1) if v.ndim > 2 else v
             for k, v in state.items()}
    state["n_iter"] = np.zeros(1, np.int64)
    bump = np.zeros(B, np.int64)
    for b, pol in enumerate(eng.policies):
        if isinstance(pol, CCWSPolicy):
            bump[b] = pol.bump
    n, L = eng.n_warps, eng.L
    fam = eng.fam.astype(np.int64)
    consts = {
        "toks": eng.toks.reshape(-1), "tok_base": eng.u_of * (n * L),
        "n_ops": eng.n_ops, "region_blocks": eng.region_blocks,
        "is_ccws": fam == F_CCWS, "is_statp": fam == F_STATP,
        "is_ciao": fam == F_CIAO,
        "wd_swl": eng.wd_kind == WD_SWL, "wd_statp": eng.wd_kind == WD_STATP,
        "mode_p": eng.mode_p, "mode_t": eng.mode_t,
        "ccws_base": eng.ccws_base, "ccws_budget": eng.ccws_budget,
        "sp_thresh": eng.sp_thresh, "bump": bump,
        # per-row config planes: knobs that vary within a shape class
        # stay (B,) tensors, so heterogeneous sweeps run as one batch
        "lat_l1": eng.lat_l1, "lat_smem": eng.lat_smem,
        "lat_migrate": eng.lat_migrate, "lat_l2": eng.lat_l2,
        "lat_dram": eng.lat_dram, "dram_gap": eng.dram_gap,
        "max_cycles": eng.max_cycles,
        "low_epoch": eng.low_epoch, "high_epoch": eng.high_epoch,
        "stride_ok": eng._stride_ok,
        "aging": eng.det_pl.aging_high,
        "low_cutoff": eng.det_pl.low_cutoff,
        "high_cutoff": eng.det_pl.high_cutoff,
        # index constants
        "ar_ways": np.arange(eng.l1_ways, dtype=np.int64),
        "ar_l2w": np.arange(eng.l2_ways, dtype=np.int64),
        "ar_vk": np.arange(eng.v_k, dtype=np.int64),
        "ar_P": np.arange(eng.P, dtype=np.int64),
        # 0-dim constants: a Python scalar in torch.where becomes a tensor
        # made on the device at every call, one more kernel each time
        "zero": np.int64(0), "no_warp": np.int64(NO_WARP),
        "huge": np.int64(_HUGE), "dead": np.int64(_DEAD),
    }
    return state, consts


def _write_back(eng, out) -> None:
    for k in _STATE_ATTRS:
        dst = getattr(eng, k)
        np.copyto(dst, out[k].reshape(dst.shape))
    for f in _DET_FIELDS:
        dst = getattr(eng.det_pl, f)
        np.copyto(dst, out["d_" + f].reshape(dst.shape))


# ------------------------------------------------------------- helpers
def _col(plane, col):
    """``plane[arB, col]`` for a (B, W) plane and a (B,) column index."""
    return plane.gather(1, col.unsqueeze(1)).squeeze(1)


def _set(plane, col, val):
    """``plane[arB, col] = val``, in place (one column a row, so the
    writes never collide)."""
    plane.scatter_(1, col.unsqueeze(1), val.unsqueeze(1))


def _wrap_cols(plane, m):
    """``plane[:, arange(m) % W]`` for a (B, W) plane: a view when m <= W
    (the default configs have m == W)."""
    w = plane.shape[1]
    if m <= w:
        return plane[:, :m]
    return plane.index_select(1, torch.arange(m, device=plane.device) % w)


def _f64(a):
    return a.to(torch.float64)


def _i64(a):
    return a.to(torch.int64)


def _gated(gate, mask, fn):
    """Run ``fn()``, or skip it when ``gate`` is set and no row is
    flagged (the CPU's form of the reference's ``lax.cond``)."""
    if gate and not bool(mask.any()):
        return
    fn()


# ---------------------------------------------------------- family ticks
# Transliterations of jax_backend's kernels; each mutates ``st`` (a dict
# of tensors) and acts only on the rows its mask flags.

def _ccws_tick(S, c, st, m):
    s0 = st["score_pl"]
    s = torch.maximum(s0 - torch.clamp(s0 // 8, min=1),
                      c["ccws_base"][:, None])
    st["score_pl"] = torch.where(m[:, None], s, s0)
    alive = ~st["done"]
    key = torch.where(alive, -s, c["dead"])
    order = torch.argsort(key, dim=1, stable=True)
    s_sorted = s.gather(1, order)
    a_sorted = alive.gather(1, order)
    csum = torch.cumsum(s_sorted * a_sorted, dim=1)
    blk = a_sorted & (csum > c["ccws_budget"][:, None])
    blk[:, 0] = False                  # the top-score warp always runs
    blocked = torch.zeros_like(blk).scatter_(1, order, blk)
    st["allowed_pl"] = torch.where(m[:, None], ~blocked, st["allowed_pl"])


def _statp_tick(S, c, st, m):
    cyc = st["cycle"]
    # single-SM: the chip-wide request counter is the row's own
    reqs = st["dram_requests"]
    util = torch.where(
        cyc > 0,
        _f64(reqs * c["dram_gap"])
        / _f64(torch.clamp(S.dram_channels * cyc, min=1)), 0.0)
    util = torch.clamp(util, max=1.0)
    new = util < c["sp_thresh"]
    ch = m & (new != st["sp_bypass"])
    bm = st["sp_base"]
    st["sp_bypass"] = torch.where(ch, new, st["sp_bypass"])
    st["allowed_pl"] = torch.where(ch[:, None], new[:, None] | bm,
                                   st["allowed_pl"])
    st["bypass_pl"] = torch.where(ch[:, None], new[:, None] & ~bm,
                                  st["bypass_pl"])


def _irs_cum_leq(S, c, st, wid, act):
    """Single-rounding cumulative-IRS cutoff (epoch.irs_cum_leq)."""
    inst = st["d_irs_inst"]
    hits = _col(st["d_irs_hits"], wid % S.nw)
    bad = (inst <= 0) | (act <= 0)
    return bad | (_f64(hits * act) <= c["low_cutoff"] * _f64(inst))


def _ciao_low(S, c, st, m, act):
    """epoch.ciao_low_tick: pop at most one stalled and one isolated warp
    per flagged cell, newest first. ``d_pair_list`` is (B, le * 2)."""
    le = S.le
    pl = st["d_pair_list"]
    sl = st["stall_len"]
    has = m & (sl > 0)
    top = _col(st["ciao_stall"], torch.clamp(sl - 1, min=0))
    topc = top * has
    p1 = (topc % le) * 2 + 1
    k1 = _col(pl, p1)
    kc = k1.clamp(min=0)
    pop = has & ((k1 == NO_WARP) | _col(st["done"], kc)
                 | _irs_cum_leq(S, c, st, kc, act))
    st["stall_len"] = sl - _i64(pop)
    _set(st["allowed_pl"], topc, _col(st["allowed_pl"], topc) | pop)
    _set(pl, p1, torch.where(pop, c["no_warp"], k1))
    # isolated pops read `allowed` after the stall pops (scalar order)
    il = st["iso_len"]
    hasi = m & (il > 0)
    topi = _col(st["ciao_iso"], torch.clamp(il - 1, min=0))
    tic = topi * hasi
    ok = hasi & _col(st["allowed_pl"], tic)
    p0 = (tic % le) * 2
    k2 = _col(pl, p0)
    k2c = k2.clamp(min=0)
    pop2 = ok & ((k2 == NO_WARP) | _col(st["done"], k2c)
                 | _irs_cum_leq(S, c, st, k2c, act))
    st["iso_len"] = il - _i64(pop2)
    _set(st["isolated_pl"], tic, _col(st["isolated_pl"], tic) & ~pop2)
    _set(pl, p0, torch.where(pop2, c["no_warp"], k2))


def _ciao_high(S, c, st, m):
    """epoch.ciao_high_tick: the batched descending-IRS walk and the one
    isolate/stall action per flagged cell."""
    n, le = S.n, S.le
    alive = st["allowed_pl"] & ~st["done"]
    act = st["d_high_snap_act"][:, None]
    win = st["d_high_snap_win"][:, None]
    hits = _wrap_cols(st["d_high_snap_hits"], n)
    over = _f64(hits * act) > c["high_cutoff"][:, None] * _f64(win)
    cand = m[:, None] & alive & over \
        & (alive.sum(1) > 1)[:, None]
    order = torch.argsort(torch.where(cand, -hits, c["dead"]), dim=1,
                          stable=True)
    cand_s = cand.gather(1, order)
    j = st["d_interfering"].gather(1, order % le)
    jc = j.clamp(min=0)
    valid = cand_s & (j != NO_WARP) & (j != order) \
        & ~st["done"].gather(1, jc)
    iso_j = st["isolated_pl"].gather(1, jc)
    alw_j = st["allowed_pl"].gather(1, jc)
    mp = c["mode_p"][:, None]
    mt = c["mode_t"][:, None]
    p_ok = valid & mp & ~iso_j & alw_j
    t_ok = valid & mt & alw_j & (iso_j | ~mp)
    hit = p_ok | t_ok
    changed = hit.any(1)
    pos = hit.to(torch.uint8).argmax(1)        # first actionable walk pos
    take_p = changed & _col(p_ok, pos)
    take_t = changed & ~take_p
    jj = _col(j, pos) * changed                   # the victim warp
    ii = _col(order, pos)                          # the interferer
    pl = st["d_pair_list"]
    q0 = (jj % le) * 2
    ilc = torch.clamp(st["iso_len"], max=n - 1)
    _set(st["isolated_pl"], jj, _col(st["isolated_pl"], jj) | take_p)
    _set(pl, q0, torch.where(take_p, ii, _col(pl, q0)))
    _set(st["ciao_iso"], ilc, torch.where(take_p, jj, _col(st["ciao_iso"], ilc)))
    st["iso_len"] = st["iso_len"] + take_p
    slc = torch.clamp(st["stall_len"], max=n - 1)
    _set(st["allowed_pl"], jj, _col(st["allowed_pl"], jj) & ~take_t)
    _set(pl, q0 + 1, torch.where(take_t, ii, _col(pl, q0 + 1)))
    _set(st["ciao_stall"], slc,
         torch.where(take_t, jj, _col(st["ciao_stall"], slc)))
    st["stall_len"] = st["stall_len"] + take_t


def _ciao_tick(S, c, st, m, gate):
    """epoch.poll_epochs (snapshots + aging) then the low/high ticks."""
    n_act = torch.clamp((st["allowed_pl"] & ~st["done"]).sum(1), min=1)
    it = st["d_inst_total"]
    cur = _wrap_cols(st["d_vta_hits"], S.nw)
    lo, hi = c["low_epoch"], c["high_epoch"]
    w = torch.where
    lowm = m & ((it // lo) != st["d_low_idx"])
    win = torch.clamp(it - st["d_low_base_inst"], min=1)
    lm = lowm[:, None]
    st["d_low_idx"] = w(lowm, it // lo, st["d_low_idx"])
    st["d_low_snap_hits"] = w(lm, cur - st["d_low_base_hits"],
                              st["d_low_snap_hits"])
    st["d_low_snap_win"] = w(lowm, win, st["d_low_snap_win"])
    st["d_low_snap_act"] = w(lowm, n_act, st["d_low_snap_act"])
    st["d_low_base_hits"] = w(lm, cur, st["d_low_base_hits"])
    st["d_low_base_inst"] = w(lowm, it, st["d_low_base_inst"])
    highm = m & ((it // hi) != st["d_high_idx"])
    winh = torch.clamp(it - st["d_high_base_inst"], min=1)
    hm = highm[:, None]
    st["d_high_idx"] = w(highm, it // hi, st["d_high_idx"])
    st["d_high_snap_hits"] = w(hm, cur - st["d_high_base_hits"],
                               st["d_high_snap_hits"])
    st["d_high_snap_win"] = w(highm, winh, st["d_high_snap_win"])
    st["d_high_snap_act"] = w(highm, n_act, st["d_high_snap_act"])
    st["d_high_base_hits"] = w(hm, cur, st["d_high_base_hits"])
    st["d_high_base_inst"] = w(highm, it, st["d_high_base_inst"])
    st["d_high_crossings"] = st["d_high_crossings"] + highm
    ag = c["aging"]
    aged = highm & (ag > 0) \
        & (st["d_high_crossings"] % torch.clamp(ag, min=1) == 0)
    st["d_irs_inst"] = w(aged, st["d_irs_inst"] // 2, st["d_irs_inst"])
    st["d_irs_hits"] = w(aged[:, None], st["d_irs_hits"] // 2,
                         st["d_irs_hits"])
    _gated(gate, lowm, lambda: _ciao_low(S, c, st, lowm, n_act))
    _gated(gate, highm, lambda: _ciao_high(S, c, st, highm))


def _epoch_service(S, c, st, mask, anchor, gate):
    """BatchedSMEngine._epoch_batch: snapshot the IRS denominators, run
    the family ticks, refresh the dispatch masks, advance the anchors."""
    li = st["li"]
    st["d_inst_total"] = torch.where(mask, li, st["d_inst_total"])
    st["d_irs_inst"] = torch.where(mask, li - st["irs_off"],
                                   st["d_irs_inst"])
    mc = mask & c["is_ccws"]
    _gated(gate, mc, lambda: _ccws_tick(S, c, st, mc))
    ms = mask & c["is_statp"]
    _gated(gate, ms, lambda: _statp_tick(S, c, st, ms))
    mi = mask & c["is_ciao"]
    _gated(gate, mi, lambda: _ciao_tick(S, c, st, mi, gate))
    st["irs_off"] = torch.where(mask, li - st["d_irs_inst"],
                                st["irs_off"])            # aging moves it
    mk = mask[:, None]
    st["avail"] = torch.where(mk, st["allowed_pl"] & ~st["done"], st["avail"])
    st["iso"] = torch.where(mk, st["isolated_pl"], st["iso"])
    st["byp"] = torch.where(mk, st["bypass_pl"], st["byp"])
    lo, hi = c["low_epoch"], c["high_epoch"]
    nxt = (li // lo + 1) * lo
    skip = c["stride_ok"] & c["is_ciao"] \
        & (st["stall_len"] + st["iso_len"] == 0)
    nxt = torch.where(skip, (li // hi + 1) * hi, nxt)
    st["next_epoch"] = torch.where(anchor, nxt, st["next_epoch"])


def _warp_done(S, c, st, fin, widc):
    """BatchedSMEngine._warp_done_rows minus the remaining-decrement
    (done by the caller): Best-SWL / statPCAL released-set rotation."""
    n = S.n
    for kind, key in ((WD_SWL, "allowed_pl"), (WD_STATP, "sp_base")):
        km = fin & (c["wd_swl"] if kind == WD_SWL else c["wd_statp"])
        mask_pl = st[key]
        cur = _col(mask_pl, widc)
        in_set = km & cur
        _set(mask_pl, widc, cur & ~in_set)
        nx = st["swl_next"]
        can = in_set & (nx < n)
        nxc = torch.clamp(nx, max=n - 1)
        _set(mask_pl, nxc, _col(mask_pl, nxc) | can)
        st["swl_next"] = torch.where(can, nx + 1, nx)
        ins = in_set[:, None]
        if kind == WD_STATP:
            sb = st["sp_bypass"][:, None]
            st["allowed_pl"] = torch.where(ins, sb | mask_pl,
                                           st["allowed_pl"])
            st["bypass_pl"] = torch.where(ins, sb & ~mask_pl,
                                          st["bypass_pl"])
        st["avail"] = torch.where(ins, st["allowed_pl"] & ~st["done"],
                                  st["avail"])
        st["byp"] = torch.where(ins, st["bypass_pl"], st["byp"])


def _timeline(S, st, m):
    """BatchedSMEngine._timeline_rows."""
    act = st["allowed_pl"].sum(1)
    k = st["tl_n"]
    kc = torch.clamp(k, max=S.tl_cap - 1)       # capacity is proven ample
    cyc, ins = st["cycle"], st["instr"]
    dc = torch.clamp(cyc - st["last_cycle"], min=1)
    dipc = _f64(ins - st["last_instr"]) / _f64(dc)
    _set(st["tl_cycle"], kc, torch.where(m, cyc, _col(st["tl_cycle"], kc)))
    _set(st["tl_dipc"], kc, torch.where(m, dipc, _col(st["tl_dipc"], kc)))
    _set(st["tl_act"], kc, torch.where(m, act, _col(st["tl_act"], kc)))
    st["tl_n"] = torch.where(m, k + 1, k)
    st["last_instr"] = torch.where(m, ins, st["last_instr"])
    st["last_cycle"] = torch.where(m, cyc, st["last_cycle"])
    st["window_mark"] = torch.where(m, st["window_mark"] + S.timeline_every,
                                    st["window_mark"])


# -------------------------------------------------------- the access chain
def _vta_insert(S, st, mask, owner, victim_line, evictor):
    """BatchedSMEngine._np_vta_insert (circular FIFO insert)."""
    v_k = S.v_k
    s = owner % S.v_sets
    h = _col(st["v_head"], s)
    cc = _col(st["v_count"], s)
    full = cc == v_k
    slot = s * v_k + torch.where(full, h, (h + cc) % v_k)
    _set(st["v_addr"], slot,
         torch.where(mask, victim_line, _col(st["v_addr"], slot)))
    _set(st["v_evic"], slot,
         torch.where(mask, evictor, _col(st["v_evic"], slot)))
    _set(st["v_head"], s, torch.where(mask & full, (h + 1) % v_k, h))
    _set(st["v_count"], s, torch.where(mask & ~full, cc + 1, cc))
    st["v_inserts"] = st["v_inserts"] + mask


def _vta_probe(S, c, st, pm, widc, line):
    """The probe + FIFO pop + detector bookkeeping, vectorized over the
    logical window (BatchedSMEngine._vta_probe_pop per flagged row)."""
    v_k = S.v_k
    s = widc % S.v_sets
    h = _col(st["v_head"], s)
    cc = _col(st["v_count"], s)
    ar_k = c["ar_vk"]
    phys = (s * v_k)[:, None] + (h[:, None] + ar_k) % v_k
    lvals = st["v_addr"].gather(1, phys)
    levic = st["v_evic"].gather(1, phys)
    eq = lvals == line[:, None]
    member = pm & eq.any(1)
    matchl = eq & (ar_k[None] < cc[:, None])
    found = member & matchl.any(1)
    jm = matchl.to(torch.uint8).argmax(1)       # oldest logical match
    evictor = torch.where(found, _col(levic, jm), c["no_warp"])
    shift = found[:, None] & (ar_k >= jm[:, None]) \
        & (ar_k < (cc - 1)[:, None])
    nl = torch.where(shift, torch.roll(lvals, -1, 1), lvals)
    ne = torch.where(shift, torch.roll(levic, -1, 1), levic)
    clear = found[:, None] & (ar_k == (cc - 1)[:, None])
    nl = torch.where(clear, c["no_warp"], nl)
    ne = torch.where(clear, c["no_warp"], ne)
    st["v_addr"].scatter_(1, phys, nl)
    st["v_evic"].scatter_(1, phys, ne)
    _set(st["v_count"], s, cc - _i64(found))
    _set(st["d_vta_hits"], s, _col(st["d_vta_hits"], s) + found)
    st["vta_hit_events"] = st["vta_hit_events"] + member
    st["cnt_vta_hits"] = st["cnt_vta_hits"] + member
    wn = widc % S.nw
    _set(st["d_irs_hits"], wn, _col(st["d_irs_hits"], wn) + member)
    pidx = (evictor + 1) * S.n + widc
    _set(st["pair_dense"], pidx, _col(st["pair_dense"], pidx) + member)
    # interference list (2-bit saturating replacement)
    i = widc % S.le
    interf = _col(st["d_interfering"], i)
    sat = _col(st["d_sat"], i)
    same = interf == evictor
    empty = interf == NO_WARP
    ni = torch.where(same, interf,
                     torch.where(empty | (sat == 0), evictor, interf))
    ns = torch.where(same, torch.clamp(sat + 1, max=S.sat_max),
                     torch.where(empty, c["zero"],
                                 torch.where(sat == 0, sat, sat - 1)))
    _set(st["d_interfering"], i, torch.where(member, ni, interf))
    _set(st["d_sat"], i, torch.where(member, ns, sat))
    # CCWS lost-locality bump (policy.on_mem_event(wid, "vta_hit"))
    _set(st["score_pl"], widc,
         _col(st["score_pl"], widc) + c["bump"] * member)


def _mem_chain(S, c, st, mem, tok, widc, cycle):
    """BatchedSMEngine._np_mem_chain: every state scatter of one access
    per row; returns the per-row access latency."""
    line = tok >> _SHIFT
    bypm = mem & _col(st["byp"], widc)
    isom = mem & _col(st["iso"], widc) & ~bypm
    norm = mem & ~bypm & ~isom
    st["cnt_bypass"] = st["cnt_bypass"] + bypm
    post = bypm
    lat = torch.zeros_like(cycle)

    # ---- L1 way scan (shared with the CIAO-P migration probe) ----
    s1 = line % S.l1_sets
    if S.xor_hash:
        s1 = (s1 ^ ((line // S.l1_sets) % S.l1_sets)) % S.l1_sets
    base1 = s1 * S.l1_ways
    way_idx = base1[:, None] + c["ar_ways"]
    tags = st["l1_tags"]
    eq = tags.gather(1, way_idx) == line[:, None]
    resident = eq.any(1)
    f_hit = base1 + eq.to(torch.uint8).argmax(1)

    hit = norm & resident
    miss = norm & ~resident
    st["cnt_l1_hit"] = st["cnt_l1_hit"] + hit
    st["cnt_l1_miss"] = st["cnt_l1_miss"] + miss
    reused, stamp = st["l1_reused"], st["l1_stamp"]
    _set(reused, f_hit, _col(reused, f_hit) | hit)
    _set(stamp, f_hit, torch.where(hit, st["tick"], _col(stamp, f_hit)))
    lat = torch.where(hit, c["lat_l1"], lat)

    # ---- CIAO-P smem region: evictions insert before the probe ----
    rb = c["region_blocks"]
    no_region = isom & (rb <= 0)
    post = post | no_region
    iso2 = isom & ~no_region
    sidx = line % torch.clamp(rb, min=1)
    sold = _col(st["smem_tags"], sidx)
    shit = iso2 & (sold == line)
    st["cnt_smem_hit"] = st["cnt_smem_hit"] + shit
    lat = torch.where(shit, c["lat_smem"], lat)
    smiss = iso2 & ~shit
    sevict = smiss & (sold >= 0)
    st["cnt_smem_evictions"] = st["cnt_smem_evictions"] + sevict
    sown = _col(st["smem_owner"], sidx)
    _vta_insert(S, st, sevict & (sown != widc), sown, sold, widc)

    # ---- VTA probe (after smem inserts, before L1-fill inserts) ----
    _vta_probe(S, c, st, miss | smiss, widc, line)

    # ---- L1 fill (miss path) ----
    vic = base1 + stamp.gather(1, way_idx).argmin(1)
    owners = st["l1_owners"]
    old = _col(tags, vic)
    oldown = _col(owners, vic)
    oldreu = _col(reused, vic)
    evict = miss & (old >= 0)
    st["cnt_evictions"] = st["cnt_evictions"] + evict
    ins = evict & (oldown != widc)
    if S.reuse_filter:
        ins = ins & oldreu
    _vta_insert(S, st, ins, oldown, old, widc)
    _set(tags, vic, torch.where(miss, line, old))
    _set(owners, vic, torch.where(miss, widc, oldown))
    _set(reused, vic, oldreu & ~miss)
    _set(stamp, vic, torch.where(miss, st["tick"], _col(stamp, vic)))
    post = post | miss

    # ---- smem migration / fill (after the probe, like the scalar) ----
    mig = smiss & resident
    _set(tags, f_hit, torch.where(mig, c["no_warp"], _col(tags, f_hit)))
    _set(owners, f_hit, torch.where(mig, c["no_warp"], _col(owners, f_hit)))
    st["cnt_smem_migrate"] = st["cnt_smem_migrate"] + mig
    lat = torch.where(mig, c["lat_migrate"], lat)
    smiss2 = smiss & ~mig
    st["cnt_smem_miss"] = st["cnt_smem_miss"] + smiss2
    post = post | smiss2
    _set(st["smem_tags"], sidx, torch.where(smiss, line, sold))
    _set(st["smem_owner"], sidx, torch.where(smiss, widc, sown))
    st["tick"] = st["tick"] + norm

    # ---- post-L1 stage: L2 tags + DRAM bandwidth queueing ----
    b2 = (line % S.l2_sets) * S.l2_ways
    wi2 = b2[:, None] + c["ar_l2w"]
    t2 = st["l2_tags"]
    eq2 = t2.gather(1, wi2) == line[:, None]
    l2res = eq2.any(1)
    h2 = post & l2res
    m2 = post & ~l2res
    st["l2_hits"] = st["l2_hits"] + h2
    lat = torch.where(h2, c["lat_l2"], lat)
    f2 = b2 + eq2.to(torch.uint8).argmax(1)
    vic2 = b2 + st["l2_stamp"].gather(1, wi2).argmin(1)
    _set(t2, vic2, torch.where(m2, line, _col(t2, vic2)))
    st["l2_misses"] = st["l2_misses"] + m2
    chn = (line >> 2) % S.dram_channels
    free = _col(st["dram_free"], chn)
    start = torch.maximum(cycle, free)
    _set(st["dram_free"], chn, torch.where(m2, start + c["dram_gap"], free))
    st["dram_requests"] = st["dram_requests"] + m2
    st["cnt_dram_reqs"] = st["cnt_dram_reqs"] + m2
    lat = torch.where(m2, c["lat_dram"] + start - cycle, lat)
    f2 = torch.where(m2, vic2, f2)
    _set(st["l2_stamp"], f2,
         torch.where(post, st["l2_tick"], _col(st["l2_stamp"], f2)))
    st["l2_tick"] = st["l2_tick"] + post
    return lat


def _iteration(S, c, st, gate):
    """One lockstep iteration (BatchedSMEngine._np_iteration for a
    single-SM batch that runs to the cycle cap), in place on ``st``."""
    cycle = st["cycle"]
    act = (st["remaining"] > 0) & (cycle < c["max_cycles"])
    st["n_iter"] = st["n_iter"] + act.any()

    # ---- warp selection (greedy-then-oldest + fused event skip) ----
    ready, avail = st["ready"], st["avail"]
    lw = st["last_wid"]
    lw_ok = lw >= 0
    lwc = lw.clamp(min=0)
    greedy = act & lw_ok & _col(avail, lwc) & (_col(ready, lwc) <= cycle)
    wid = torch.where(greedy, lw, c["no_warp"])
    need = act & ~greedy
    cand = (ready <= cycle[:, None]) & avail
    w = cand.to(torch.uint8).argmax(1)
    found = need & _col(cand, w)
    wid = torch.where(found, w, wid)
    lw = torch.where(found, w, lw)
    skip = need & ~found
    sched = torch.where(avail, ready, c["huge"])
    w2 = sched.argmin(1)
    thr = skip & ~_col(avail, w2)
    # everything throttled: advance to let epochs fire (no re-anchor);
    # the epoch service of these rows runs with the end-of-iteration one
    st["cycle"] = cycle = torch.where(thr, cycle + c["low_epoch"], cycle)
    st["li"] = torch.where(thr, st["li"] + c["low_epoch"], st["li"])
    sk = skip & ~thr
    best = _col(ready, w2)
    clamp = sk & (best >= c["max_cycles"])      # slice stop at the cap
    st["cycle"] = cycle = torch.where(
        clamp, c["max_cycles"], torch.where(sk & ~clamp, best, cycle))
    sk = sk & ~clamp
    lw_ok2 = lw >= 0
    lwc2 = lw.clamp(min=0)
    tie = sk & lw_ok2 & _col(avail, lwc2) & (_col(ready, lwc2) <= best)
    wid = torch.where(tie, lw, wid)
    w2sel = sk & ~tie
    wid = torch.where(w2sel, w2, wid)
    lw = torch.where(w2sel, w2, lw)
    st["last_wid"] = lw

    disp = act & (wid >= 0)
    widc = wid * disp

    # ---- token fetch (a finished warp's cursor may sit one past its
    # stream: clamp, as the reference's gather does) ----
    oi = _col(st["op_idx"], widc)
    tok = c["toks"][c["tok_base"] + widc * S.L + torch.clamp(oi, max=S.L - 1)]
    alu = disp & (tok < 0)
    mem = disp & ~alu
    adv = -tok * alu + mem

    new_ready = _col(ready, widc)
    lat = _mem_chain(S, c, st, mem, tok, widc, cycle)
    done_t = cycle + lat
    dep = mem & ((tok & 1) == 1)
    nondep = mem & ~dep
    new_ready = torch.where(dep, done_t, new_ready)
    P = S.P
    prow = st["pend"].gather(1, widc[:, None] * P + c["ar_P"])   # (B, P)
    slot = prow.argmin(1)                        # a stale (<=cycle) slot
    nv = torch.where(nondep, done_t, _col(prow, slot))
    _set(st["pend"], widc * P + slot, nv)
    _set(prow, slot, nv)
    valid = prow > cycle[:, None]
    outstanding = valid.sum(1)
    earliest = torch.where(valid, prow, c["huge"]).amin(1)
    new_ready = torch.where(
        nondep,
        torch.where(outstanding >= S.max_mlp, earliest, cycle + 1),
        new_ready)
    new_ready = torch.where(alu, cycle + adv, new_ready)

    adv = adv * disp
    st["li"] = st["li"] + adv
    st["cycle"] = cycle + adv                    # mem rows: +1
    _set(ready, widc, new_ready)
    oi_new = oi + disp
    _set(st["op_idx"], widc, oi_new)
    st["instr"] = st["instr"] + adv

    # ---- warp retirement -> epoch -> timeline (the scalar order) ----
    fin = disp & (oi_new >= _col(c["n_ops"], widc))
    _set(st["done"], widc, _col(st["done"], widc) | fin)
    _set(st["avail"], widc, _col(st["avail"], widc) & ~fin)
    st["last_wid"] = torch.where(fin, c["no_warp"], st["last_wid"])
    st["remaining"] = st["remaining"] - _i64(fin)
    _gated(gate, fin, lambda: _warp_done(S, c, st, fin, widc))
    ep = disp & (st["li"] >= st["next_epoch"])
    em = ep | thr
    _gated(gate, em, lambda: _epoch_service(S, c, st, em, ep, gate))
    tl = disp & (st["instr"] >= st["window_mark"])
    _gated(gate, tl, lambda: _timeline(S, st, tl))


# ------------------------------------------------------------- run loop
def _chunk(S, c, static, k, gate):
    """``k`` iterations on the state tensors ``static``, in place: planes
    are scattered into directly, and a key the iterations rebound to a
    new tensor is copied back at the end."""
    st = dict(static)
    for _ in range(k):
        _iteration(S, c, st, gate)
    for key, t in st.items():
        if t is not static[key]:
            static[key].copy_(t)


def _live(st, c) -> bool:
    return bool(((st["remaining"] > 0)
                 & (st["cycle"] < c["max_cycles"])).any())


def _to_device(arrays, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in arrays.items()}


class _Graph:
    """One chunk of ``chunk`` iterations captured as a CUDA graph over
    static state and const buffers of one shape signature."""

    def __init__(self, S, st_np, cst_np, dev, chunk):
        self.st = _to_device(st_np, dev)
        self.cst = _to_device(cst_np, dev)
        t0 = time.perf_counter()
        # warm up on a throwaway copy of the state, so that every kernel
        # is loaded before the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _chunk(S, self.cst, {k: t.clone() for k, t in self.st.items()}, 1,
                   gate=False)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _chunk(S, self.cst, self.st, chunk, gate=False)
        self.capture_s = time.perf_counter() - t0

    def load(self, st_np, cst_np):
        for dst, src in ((self.st, st_np), (self.cst, cst_np)):
            for k, a in src.items():
                dst[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))


def _signature(st_np, cst_np) -> tuple:
    return tuple((k, a.shape, a.dtype.str)
                 for d in (st_np, cst_np) for k, a in sorted(d.items()))


class GraphCache:
    """Captured chunks by (static config, arrays' shapes, device, chunk),
    the counterpart of the reference's ``_compiled`` cache; it keeps the
    ``KEPT`` most recent, each holding its own state buffers."""

    KEPT = 4

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.last: Optional[_Graph] = None     # the graph of the latest run

    def get(self, S, st_np, cst_np, dev, chunk) -> _Graph:
        key = (S, _signature(st_np, cst_np), dev, chunk)
        g = self.graphs.pop(key, None)
        if g is None:
            g = _Graph(S, st_np, cst_np, dev, chunk)
            while len(self.graphs) >= self.KEPT:
                self.graphs.pop(next(iter(self.graphs)))
        else:
            g.load(st_np, cst_np)
            g.capture_s = 0.0
        self.graphs[key] = self.last = g
        return g


GRAPHS = GraphCache()


def run_loop(S: _Static, st_np, cst_np, dev: torch.device, *,
             graph: bool, chunk: int = CHUNK, gate=None):
    """Run the state to completion on ``dev``; returns (the final state as
    numpy arrays, the seconds spent capturing a CUDA graph). ``gate``
    defaults to True on the CPU and must be False on CUDA (no host sync in
    an iteration)."""
    if gate is None:
        gate = dev.type == "cpu"
    if gate and dev.type == "cuda":
        raise ValueError("gated branches sync with the host; not on CUDA")
    if graph and dev.type != "cuda":
        raise ValueError("a CUDA graph needs a CUDA device")
    capture_s = 0.0
    if graph:
        g = GRAPHS.get(S, st_np, cst_np, dev, chunk)
        st, cst, capture_s = g.st, g.cst, g.capture_s
        while _live(st, cst):
            g.graph.replay()
    else:
        st, cst = _to_device(st_np, dev), _to_device(cst_np, dev)
        while _live(st, cst):
            _chunk(S, cst, st, chunk, gate)
    return {k: t.cpu().numpy() for k, t in st.items()}, capture_s


def run_engine(eng, device=None) -> None:
    """Run every row of a BatchedSMEngine to completion on ``device`` (the
    card by default) and write the final state back into the engine's
    numpy arrays; the engine's ``_finalize`` then assembles results
    exactly like the numpy/C paths. On CUDA a chunk runs as a replayed
    CUDA graph (``GRAPHS.last``); on the CPU it runs eagerly.
    Raises RuntimeError when :func:`supports_engine` says no, or when no
    card is present and none was asked for. Never falls back to another
    stepper."""
    why = supports_engine(eng)
    if why:
        raise RuntimeError(f"torch stepper unavailable for this batch: {why}")
    dev = resolve_device(device)
    graph = dev.type == "cuda"
    S = _static_of(eng)
    st_np, cst_np = _arrays_of(eng)
    t0 = time.perf_counter()
    out, capture_s = run_loop(S, st_np, cst_np, dev, graph=graph)
    eng.perf["stepper_s"] += time.perf_counter() - t0
    eng.perf["capture_s"] = capture_s
    eng.perf["rounds"] += 1
    eng.perf["iterations"] = float(out["n_iter"][0])
    eng.perf["graph"] = float(graph)
    t0 = time.perf_counter()
    _write_back(eng, out)
    for b in range(eng.B):
        eng._finalize(b)
    eng.perf["drain_s"] += time.perf_counter() - t0
