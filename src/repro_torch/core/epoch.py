"""Vectorized epoch-path math: one implementation, batch-first.

CIAO's scheduling decisions fire only at epoch boundaries, yet they used
to be replayed cell-by-cell through Python objects whenever the batched
engine (:mod:`repro_torch.core.batched`) drained its pause flags — the last
per-cell serialization left in the sweep path. This module re-expresses
every epoch-boundary transform as an array kernel over *stacked* state
planes with a leading batch axis:

* :func:`poll_epochs` — the detector's low/high epoch-crossing detection,
  windowed IRS snapshots (Eq. 1 over the epoch that just ended) and
  counter aging, for any subset ``idx`` of cells at once.
* :func:`ccws_tick` — CCWS score decay + lost-locality throttling
  (stable sort + cumulative budget) across cells.
* :func:`statpcal_tick` — the statPCAL bandwidth-driven bypass flip.
* :func:`ciao_low_tick` — Algorithm 1 lines 4-19 (reverse-order
  reactivation, one pop per stack per epoch) across cells.
* :func:`ciao_high_tick` — Algorithm 1 lines 20-28 (one isolate/stall
  action per high epoch) across cells: candidate scoring, the stable
  descending-IRS walk and the single action are all batched scatters.

The **scalar objects are batch-of-1 views**: ``InterferenceDetector``
keeps its state in a single-row :class:`DetPlanes` and
``poll_epochs``/``irs``/…—as well as the CCWS/statPCAL/CIAO
``epoch_tick`` methods in :mod:`repro_torch.core.policies` — delegate to these
kernels with ``B == 1``. The batched engine re-points each cell's
detector/policy at a row of its full-batch planes (:meth:`DetPlanes.row`)
and calls the same kernels once per pause-drain for *all* flagged cells.
That makes the vectorized forms the single implementation the scalar
``SMSimulator`` also exercises, so the golden cells of
``tests/test_equivalence.py`` pin them bit-for-bit and
``tests/test_epoch.py`` property-tests batch == per-cell on random
counter states.

Bit-exactness notes: every arithmetic step mirrors the scalar semantics
elementwise — int64 floor divisions and stable sorts wherever the scalar
code relied on Python's stable ``sorted``/``argsort``. The IRS state is
**fixed-point**: snapshots are stored as the integer triple
``(hits, window, active)`` and every cutoff decision is the
single-rounding float64 compare ``hits*active <> cutoff*window``. All
integer operands stay far below 2**53, so the int64->float64
conversions are exact, the compare performs exactly one IEEE rounding
per side, and the decision is bit-deterministic across numpy, the C
stepper, and XLA — no accumulated float state ever crosses an epoch
boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

NO_WARP = -1
# sort key for dead warps: larger than any -score / any finite key
_DEAD_KEY = np.iinfo(np.int64).max

# reusable batch-of-1 index (the scalar objects' delegation path)
IDX0 = np.zeros(1, np.int64)


# --------------------------------------------------------------- planes
@dataclasses.dataclass
class DetPlanes:
    """Stacked per-cell detector state (one row per cell).

    The arrays are the *canonical* storage: ``InterferenceDetector``
    exposes them through thin properties, and
    :meth:`InterferenceDetector.adopt_row` re-points a detector at a row
    of a full-batch instance so object reads and kernel writes share
    memory.
    """
    cfg: object                      # DetectorConfig (duck-typed)
    inst_total: np.ndarray           # (B,) i64  Inst-total counter
    irs_inst: np.ndarray             # (B,) i64  aged Eq. 1 denominator
    low_idx: np.ndarray              # (B,) i64  last-seen epoch ordinals
    high_idx: np.ndarray             # (B,) i64
    low_base_inst: np.ndarray        # (B,) i64  window bases
    high_base_inst: np.ndarray       # (B,) i64
    high_crossings: np.ndarray       # (B,) i64  aging counter
    irs_hits: np.ndarray             # (B, nw) i64  aged per-warp VTA hits
    low_base_hits: np.ndarray        # (B, nw) i64
    high_base_hits: np.ndarray       # (B, nw) i64
    # fixed-point windowed IRS snapshots: value = hits * act / win
    low_snap_hits: np.ndarray        # (B, nw) i64  hits in the window
    high_snap_hits: np.ndarray       # (B, nw) i64
    low_snap_win: np.ndarray         # (B,) i64  window length (>= 1)
    high_snap_win: np.ndarray        # (B,) i64
    low_snap_act: np.ndarray         # (B,) i64  active warps (>= 1)
    high_snap_act: np.ndarray        # (B,) i64
    vta_hits: np.ndarray             # (B, v_sets) i64 (aliases vta.hits)
    interfering: np.ndarray          # (B, list_entries) i64
    sat: np.ndarray                  # (B, list_entries) i64
    pair_list: np.ndarray            # (B, list_entries, 2) i64
    # per-row config planes: scalar detector knobs promoted to columns
    # so heterogeneous sweeps batch (shape-affecting fields stay on cfg)
    low_epoch: np.ndarray            # (B,) i64
    high_epoch: np.ndarray           # (B,) i64
    aging_high: np.ndarray           # (B,) i64  0 disables aging
    low_cutoff: np.ndarray           # (B,) f64
    high_cutoff: np.ndarray          # (B,) f64
    wid_sets: np.ndarray             # (nw,) i64  wid -> vta set index

    @classmethod
    def alloc(cls, b: int, cfg) -> "DetPlanes":
        i64 = np.int64
        nw, le = cfg.num_warps, cfg.list_entries
        return cls(
            cfg=cfg,
            inst_total=np.zeros(b, i64),
            irs_inst=np.zeros(b, i64),
            low_idx=np.zeros(b, i64),
            high_idx=np.zeros(b, i64),
            low_base_inst=np.zeros(b, i64),
            high_base_inst=np.zeros(b, i64),
            high_crossings=np.zeros(b, i64),
            irs_hits=np.zeros((b, nw), i64),
            low_base_hits=np.zeros((b, nw), i64),
            high_base_hits=np.zeros((b, nw), i64),
            low_snap_hits=np.zeros((b, nw), i64),
            high_snap_hits=np.zeros((b, nw), i64),
            low_snap_win=np.ones(b, i64),
            high_snap_win=np.ones(b, i64),
            low_snap_act=np.ones(b, i64),
            high_snap_act=np.ones(b, i64),
            vta_hits=np.zeros((b, cfg.vta_sets), i64),
            interfering=np.full((b, le), NO_WARP, i64),
            sat=np.zeros((b, le), i64),
            pair_list=np.full((b, le, 2), NO_WARP, i64),
            low_epoch=np.full(b, cfg.low_epoch, i64),
            high_epoch=np.full(b, cfg.high_epoch, i64),
            aging_high=np.full(b, cfg.aging_high_epochs, i64),
            low_cutoff=np.full(b, cfg.low_cutoff, np.float64),
            high_cutoff=np.full(b, cfg.high_cutoff, np.float64),
            wid_sets=np.arange(nw, dtype=i64) % cfg.vta_sets,
        )

    _ROW_FIELDS = ("inst_total", "irs_inst", "low_idx", "high_idx",
                   "low_base_inst", "high_base_inst", "high_crossings",
                   "irs_hits", "low_base_hits", "high_base_hits",
                   "low_snap_hits", "high_snap_hits", "low_snap_win",
                   "high_snap_win", "low_snap_act", "high_snap_act",
                   "vta_hits", "interfering", "sat", "pair_list",
                   "low_epoch", "high_epoch", "aging_high",
                   "low_cutoff", "high_cutoff")

    def row(self, b: int) -> "DetPlanes":
        """A batch-of-1 *view* of row ``b`` (shares memory)."""
        kw = {f: getattr(self, f)[b:b + 1] for f in self._ROW_FIELDS}
        return DetPlanes(cfg=self.cfg, wid_sets=self.wid_sets, **kw)

    def copy_row_from(self, other: "DetPlanes", b: int) -> None:
        """Copy ``other``'s single row into row ``b`` of this batch."""
        for f in self._ROW_FIELDS:
            getattr(self, f)[b] = getattr(other, f)[0]


# -------------------------------------------------------- detector poll
def poll_epochs(pl: DetPlanes, idx: np.ndarray, active: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Low/high epoch-crossing poll for cells ``idx`` (robust to batched
    instruction counting: an ordinal jump of any size is one crossing).

    ``active`` holds each cell's active-warp count (clamped to >= 1
    here, like the scalar code). Returns ``(crossed_low, crossed_high)``
    bool arrays aligned with ``idx``. Mutates the planes in place:
    windowed IRS snapshots at crossings, counter aging every
    ``aging_high_epochs`` high crossings.
    """
    act = np.maximum(np.asarray(active, np.int64), 1)
    it = pl.inst_total[idx]
    nlow = it // pl.low_epoch[idx]
    low = nlow != pl.low_idx[idx]
    if low.any():
        sub = idx[low]
        pl.low_idx[sub] = nlow[low]
        window = np.maximum(it[low] - pl.low_base_inst[sub], 1)
        cur = pl.vta_hits[sub][:, pl.wid_sets]
        pl.low_snap_hits[sub] = cur - pl.low_base_hits[sub]
        pl.low_snap_win[sub] = window
        pl.low_snap_act[sub] = act[low]
        pl.low_base_hits[sub] = cur
        pl.low_base_inst[sub] = it[low]
    nhigh = it // pl.high_epoch[idx]
    high = nhigh != pl.high_idx[idx]
    if high.any():
        sub = idx[high]
        pl.high_idx[sub] = nhigh[high]
        window = np.maximum(it[high] - pl.high_base_inst[sub], 1)
        cur = pl.vta_hits[sub][:, pl.wid_sets]
        pl.high_snap_hits[sub] = cur - pl.high_base_hits[sub]
        pl.high_snap_win[sub] = window
        pl.high_snap_act[sub] = act[high]
        pl.high_base_hits[sub] = cur
        pl.high_base_inst[sub] = it[high]
        pl.high_crossings[sub] += 1
        ag = pl.aging_high[sub]
        aged = sub[(ag > 0)
                   & (pl.high_crossings[sub]
                      % np.where(ag > 0, ag, 1) == 0)]
        if len(aged):
            pl.irs_inst[aged] //= 2
            pl.irs_hits[aged] //= 2
    return low, high


def irs_cumulative(pl: DetPlanes, idx: np.ndarray, wid: np.ndarray,
                   active: np.ndarray) -> np.ndarray:
    """Eq. 1 over the aged cumulative counters, vectorized:
    ``irs_hits[wid] * active / irs_inst`` with the scalar guards
    (zero denominator -> 0.0). Reporting only — cutoff *decisions* go
    through :func:`irs_cum_leq` so they stay single-rounding."""
    inst = pl.irs_inst[idx]
    act = np.asarray(active, np.int64)
    ok = (inst > 0) & (act > 0)
    hits = pl.irs_hits[idx, wid % pl.cfg.num_warps]
    return np.where(ok, (hits * act) / np.where(inst > 0, inst, 1), 0.0)


def irs_cum_leq(pl: DetPlanes, idx: np.ndarray, wid: np.ndarray,
                active: np.ndarray, cutoff: float) -> np.ndarray:
    """Cutoff decision on the cumulative IRS: True where
    ``irs_hits[wid] / (irs_inst / active) <= cutoff`` (or the guards
    degrade the IRS to 0.0, which any cutoff >= 0 admits). Evaluated as
    the single-rounding compare ``hits*act <= cutoff*inst`` — the
    fixed-point decision contract shared by numpy, C, and XLA."""
    inst = pl.irs_inst[idx]
    act = np.asarray(active, np.int64)
    hits = pl.irs_hits[idx, wid % pl.cfg.num_warps]
    bad = (inst <= 0) | (act <= 0)
    return bad | ((hits * act) <= cutoff * inst.astype(np.float64))


def snap_over(hits: np.ndarray, win: np.ndarray, act: np.ndarray,
              cutoff: float) -> np.ndarray:
    """Windowed-snapshot cutoff decision: True where the fixed-point
    snapshot ``hits / (win / act)`` exceeds ``cutoff``, evaluated as the
    single-rounding compare ``hits*act > cutoff*win``."""
    return (hits * act) > cutoff * np.asarray(win, np.float64)


# ----------------------------------------------------------------- CCWS
def ccws_tick(score: np.ndarray, base: np.ndarray, budget: np.ndarray,
              alive: np.ndarray, allowed: np.ndarray,
              idx: np.ndarray) -> np.ndarray:
    """CCWS epoch: decay every warp's lost-locality score, then throttle
    the lowest-scoring warps once the running (descending-score) sum
    exceeds the budget — never the top-scoring warp.

    ``score`` (B, n) int64 is decayed in place (never reassigned — the C
    stepper holds a pointer to each row); ``alive`` (k, n) marks the
    unfinished warps of cells ``idx``; ``allowed`` (B, n) bool rows are
    rewritten. Returns the (k, n) blocked mask (the scalar object's
    ``blocked`` set, for the batch-of-1 delegation).
    """
    s = score[idx]
    s -= np.maximum(1, s // 8)
    np.maximum(s, base[idx, None], out=s)
    score[idx] = s
    # stable argsort on -score with dead warps keyed last == the scalar
    # `alive[argsort(-score[alive], kind="stable")]` ordering
    key = np.where(alive, -s, _DEAD_KEY)
    order = np.argsort(key, axis=1, kind="stable")
    s_sorted = np.take_along_axis(s, order, 1)
    a_sorted = np.take_along_axis(alive, order, 1)
    csum = np.cumsum(np.where(a_sorted, s_sorted, 0), axis=1)
    blk_sorted = a_sorted & (csum > budget[idx, None])
    blk_sorted[:, 0] = False             # the top-score warp always runs
    blocked = np.zeros_like(blk_sorted)
    np.put_along_axis(blocked, order, blk_sorted, 1)
    allowed[idx] = ~blocked
    return blocked


# ------------------------------------------------------------- statPCAL
def statpcal_tick(bypass_active: np.ndarray, util: np.ndarray,
                  threshold: np.ndarray, base_mask: np.ndarray,
                  allowed: np.ndarray, bypass: np.ndarray,
                  idx: np.ndarray) -> np.ndarray:
    """statPCAL epoch: flip to bypass mode while DRAM bandwidth is
    underutilized. ``base_mask`` (B, n) holds the static-limit allowed
    set; masks are rewritten only for cells whose mode flipped. Returns
    the changed mask aligned with ``idx``."""
    new = util < threshold[idx]
    changed = new != bypass_active[idx]
    if changed.any():
        sub = idx[changed]
        nb = new[changed]
        bypass_active[sub] = nb
        bm = base_mask[sub]
        allowed[sub] = np.where(nb[:, None], True, bm)
        bypass[sub] = np.where(nb[:, None], ~bm, False)
    return changed


# ------------------------------------------------------------------ CIAO
def ciao_low_tick(pl: DetPlanes, stall: np.ndarray, stall_len: np.ndarray,
                  iso: np.ndarray, iso_len: np.ndarray,
                  allowed: np.ndarray, isolated: np.ndarray,
                  fin: np.ndarray, n_act: np.ndarray,
                  idx: np.ndarray) -> np.ndarray:
    """Algorithm 1 lines 4-19 across cells ``idx``: pop at most one
    stalled and one isolated warp per cell, newest first, each guarded
    by the *cumulative* IRS of the trigger recorded in the pair list.

    ``stall``/``iso`` are (B, n) LIFO planes with (B,) depths;
    ``allowed``/``isolated`` (B, n) bool; ``fin`` (B, n) the finished
    flags the trigger checks read; ``n_act`` the per-cell active-warp
    counts (clamped >= 1 like ``CIAOPolicy._n_active``). Returns the
    changed mask aligned with ``idx``."""
    cfg = pl.cfg
    le = cfg.list_entries
    act = np.maximum(np.asarray(n_act, np.int64), 1)
    changed = np.zeros(len(idx), bool)

    # reactivate stalled warps, newest first (lines 4-10)
    has = stall_len[idx] > 0
    top = stall[idx, np.maximum(stall_len[idx] - 1, 0)]
    topc = np.where(has, top, 0)
    k = pl.pair_list[idx, topc % le, 1]
    kc = np.where(k >= 0, k, 0)
    pop = has & ((k == NO_WARP) | fin[idx, kc]
                 | irs_cum_leq(pl, idx, kc, act, pl.low_cutoff[idx]))
    if pop.any():
        sub = idx[pop]
        w = stall[sub, stall_len[sub] - 1]
        stall_len[sub] -= 1
        allowed[sub, w] = True
        pl.pair_list[sub, w % le, 1] = NO_WARP
        changed |= pop

    # un-redirect isolated warps, newest first (lines 11-19); a warp
    # stalled while isolated must reactivate first — read `allowed`
    # *after* the pops above, like the scalar order
    hasi = iso_len[idx] > 0
    topi = iso[idx, np.maximum(iso_len[idx] - 1, 0)]
    tic = np.where(hasi, topi, 0)
    ok = hasi & allowed[idx, tic]
    k2 = pl.pair_list[idx, tic % le, 0]
    k2c = np.where(k2 >= 0, k2, 0)
    pop2 = ok & ((k2 == NO_WARP) | fin[idx, k2c]
                 | irs_cum_leq(pl, idx, k2c, act, pl.low_cutoff[idx]))
    if pop2.any():
        sub = idx[pop2]
        w = iso[sub, iso_len[sub] - 1]
        iso_len[sub] -= 1
        isolated[sub, w] = False
        pl.pair_list[sub, w % le, 0] = NO_WARP
        changed |= pop2
    return changed


def ciao_high_tick(pl: DetPlanes, stall: np.ndarray,
                   stall_len: np.ndarray, iso: np.ndarray,
                   iso_len: np.ndarray, allowed: np.ndarray,
                   isolated: np.ndarray, fin: np.ndarray,
                   alive: np.ndarray, mode_p: np.ndarray,
                   mode_t: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Algorithm 1 lines 20-28 across cells ``idx``: walk each cell's
    active warps by descending high-epoch IRS and take (at most) one
    isolate/stall action per cell.

    ``alive`` (k, n) bool and ``mode_p``/``mode_t`` (k,) bool align with
    ``idx``; the stack/mask planes are full-batch like
    :func:`ciao_low_tick`. The per-cell action walk is fully batched:
    every condition reads pre-tick state and at most one scatter fires
    per cell, so cells cannot interact. Candidate order is the stable
    descending sort on the snapshot's integer ``hits`` — within a cell
    the snapshot is ``hits * (act/win)`` with one positive scale, so the
    hits order *is* the IRS order. Returns the (k,) changed mask."""
    cfg = pl.cfg
    nw, le = cfg.num_warps, cfg.list_entries
    k, n = alive.shape
    changed = np.zeros(k, bool)
    if not k:
        return changed
    act = pl.high_snap_act[idx][:, None]
    win = pl.high_snap_win[idx][:, None]
    hits = pl.high_snap_hits[idx][:, np.arange(n) % nw]
    # `snap > cutoff` gate; the scalar walk's sorted-order break at the
    # first snap <= cutoff equals dropping every non-exceeding warp
    cand = alive & snap_over(hits, win, act,
                             pl.high_cutoff[idx][:, None]) \
        & (np.count_nonzero(alive, axis=1) > 1)[:, None]
    order = np.argsort(np.where(cand, -hits, _DEAD_KEY), axis=1,
                       kind="stable")          # (k, n) warp ids, desc IRS
    cand_s = np.take_along_axis(cand, order, 1)
    rows = idx[:, None]
    j = pl.interfering[rows, order % le]
    jc = np.where(j >= 0, j, 0)
    valid = cand_s & (j != NO_WARP) & (j != order) & ~fin[rows, jc]
    iso_j = isolated[rows, jc]
    alw_j = allowed[rows, jc]
    p_ok = valid & mode_p[:, None] & ~iso_j & alw_j
    t_ok = valid & mode_t[:, None] & alw_j & (iso_j | ~mode_p[:, None])
    hit = p_ok | t_ok
    changed = hit.any(axis=1)
    sel = np.flatnonzero(changed)
    if not sel.size:
        return changed
    pos = np.argmax(hit[sel], axis=1)          # first actionable walk pos
    take_p = p_ok[sel, pos]
    jj = j[sel, pos]                           # the victim warp
    ii = order[sel, pos]                       # the interferer
    ps, ts = sel[take_p], sel[~take_p]
    if ps.size:
        bp, jp, ip = idx[ps], jj[take_p], ii[take_p]
        isolated[bp, jp] = True
        pl.pair_list[bp, jp % le, 0] = ip
        iso[bp, iso_len[bp]] = jp
        iso_len[bp] += 1
    if ts.size:
        bt, jt, it = idx[ts], jj[~take_p], ii[~take_p]
        allowed[bt, jt] = False
        pl.pair_list[bt, jt % le, 1] = it
        stall[bt, stall_len[bt]] = jt
        stall_len[bt] += 1
    return changed
