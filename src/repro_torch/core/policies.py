"""Warp scheduling policies: GTO, CCWS, Best-SWL, statPCAL, CIAO-P/T/C.

All policies share the interface the SM simulator drives:

  * ``allow(wid)``        — may this warp issue this cycle? (throttling)
  * ``is_isolated(wid)``  — are its memory requests redirected to smem?
  * ``is_bypass(wid)``    — statPCAL L1D bypass?
  * ``select(ready)``     — pick the next warp (all use GTO order, §V-A)
  * ``epoch_tick(...)``   — epoch-boundary decisions (Algorithm 1 for CIAO)

The per-warp decisions are materialized as cached NumPy bool masks
(``allowed_mask`` / ``isolated_mask`` / ``bypass_mask``) so the
simulator's dispatch loop reads array elements instead of making millions
of ``allow()`` calls. The masks only change where policy state changes —
``epoch_tick``, ``on_mem_event``-driven decisions, ``on_warp_done`` — and
every change bumps ``mask_version`` so the simulator can cache derived
masks (e.g. allowed & ~done) between changes.

The epoch-boundary math itself lives in :mod:`repro_torch.core.epoch` as
vectorized batch-first kernels; the ``epoch_tick`` methods here are
**batch-of-1 views** onto those kernels, and all mask/score/stack updates
are strictly *in place* (arrays are never reassigned). That lets the
batched engine (:mod:`repro_torch.core.batched`) re-point a policy's arrays at
rows of its stacked batch planes (``adopt_*_rows``) and run the very same
kernels once per pause-drain for every flagged cell — scalar and batched
paths share one implementation, pinned bit-for-bit by the golden cells.

CIAO's ``epoch_tick`` is Algorithm 1 with one high-cutoff action per epoch
(the paper applies one isolate/stall per scheduling event and "repeats this
step" across epochs) and reverse-order reactivation at low-cutoff epochs
(§III-C): stalls/redirections are undone newest-first, each guarded by the
IRS of the interfered warp recorded in the pair list.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import epoch as _epoch
from repro_torch.core.interference import InterferenceDetector, NO_WARP

POLICY_NAMES = ("gto", "ccws", "best-swl", "statpcal",
                "ciao-p", "ciao-t", "ciao-c")


class BasePolicy:
    name = "base"

    def __init__(self, num_warps: int, detector: InterferenceDetector):
        self.n = num_warps
        self.det = detector
        self.last_wid: Optional[int] = None
        self.allowed_mask = np.ones(num_warps, bool)
        self.isolated_mask = np.zeros(num_warps, bool)
        self.bypass_mask = np.zeros(num_warps, bool)
        self.mask_version = 0

    # -- issue control ----------------------------------------------------
    def allow(self, wid: int) -> bool:
        return bool(self.allowed_mask[wid])

    def is_isolated(self, wid: int) -> bool:
        return bool(self.isolated_mask[wid])

    def is_bypass(self, wid: int) -> bool:
        return bool(self.bypass_mask[wid])

    # -- GTO (greedy-then-oldest) selection (shared by all, §V-A) ---------
    def select(self, ready: Sequence[int]) -> int:
        if self.last_wid is not None and self.last_wid in ready:
            return self.last_wid
        wid = min(ready)          # oldest = lowest WID
        self.last_wid = wid
        return wid

    # -- hooks -------------------------------------------------------------
    def on_mem_event(self, wid: int, event: str) -> None:
        pass

    def on_warp_done(self, wid: int) -> None:
        pass

    def epoch_tick(self, active: Sequence[int], finished: Sequence[bool],
                   mem_util: float = 0.0) -> None:
        pass

    def next_epoch_after(self, li: int) -> int:
        """Next instruction count at which ``epoch_tick`` can have an
        observable effect — the per-cell next-trigger table. The base
        tick is a no-op, so passive policies (GTO, Best-SWL) park at
        infinity; the simulator still syncs detector counters at exit.
        Families with per-epoch state (CCWS decay, statPCAL bandwidth
        probe) fire every low-cutoff epoch."""
        return 1 << 62

    def _low_epoch_after(self, li: int) -> int:
        low = self.det.cfg.low_epoch
        return (li // low + 1) * low

    def num_allowed(self) -> int:
        return int(self.allowed_mask.sum())

    # -- batched-engine adoption -------------------------------------------
    def adopt_mask_rows(self, allowed_row: np.ndarray,
                        isolated_row: np.ndarray,
                        bypass_row: np.ndarray) -> None:
        """Re-point the cached masks at rows of the batched engine's
        stacked planes (current state is copied in). Mask updates are
        in-place everywhere, so object writes (``on_warp_done`` rebuilds)
        and batch-kernel writes land in the same memory."""
        allowed_row[:] = self.allowed_mask
        isolated_row[:] = self.isolated_mask
        bypass_row[:] = self.bypass_mask
        self.allowed_mask = allowed_row
        self.isolated_mask = isolated_row
        self.bypass_mask = bypass_row

    def _fin_row(self, finished) -> np.ndarray:
        """Full-width finished flags (trigger checks index by raw wid)."""
        fin = np.zeros(self.n, bool)
        f = np.asarray(finished, bool)
        fin[:len(f)] = f
        return fin


class GTOPolicy(BasePolicy):
    name = "gto"


class BestSWLPolicy(BasePolicy):
    """Static wavefront limiting: only the oldest ``limit`` *unfinished*
    warps run; the best limit is found by an offline sweep (paper profiles
    per benchmark, column N_wrp of Table II)."""

    name = "best-swl"

    def __init__(self, num_warps, detector, limit: int = 48):
        super().__init__(num_warps, detector)
        self.limit = max(1, limit)
        self.allowed = set(range(min(self.limit, num_warps)))
        self._next = min(self.limit, num_warps)
        self._rebuild_masks()

    def _rebuild_masks(self) -> None:
        m = self.allowed_mask
        m[:] = False
        if self.allowed:
            m[list(self.allowed)] = True
        self.mask_version += 1

    def on_warp_done(self, wid: int) -> None:
        if wid in self.allowed:
            self.allowed.discard(wid)
            if self._next < self.n:
                self.allowed.add(self._next)
                self._next += 1
            self._rebuild_masks()


class CCWSPolicy(BasePolicy):
    """Cache-Conscious Wavefront Scheduling [12] (score-based variant).

    Each warp carries a lost-locality score (LLS) bumped on its own VTA hits
    and decaying over time. When the total score exceeds the cutoff, the
    *lowest-scoring* warps are throttled — protecting high-locality warps,
    the exact opposite of CIAO's target selection."""

    name = "ccws"

    def __init__(self, num_warps, detector, base_score: int = 64,
                 bump: int = 512, budget_per_warp: int = 128):
        super().__init__(num_warps, detector)
        self.score = np.full(num_warps, base_score, np.int64)
        self.base = base_score
        self.bump = bump
        self.budget = budget_per_warp * num_warps
        self.blocked: set = set()
        self._base1 = np.full(1, base_score, np.int64)
        self._budget1 = np.full(1, self.budget, np.int64)

    def on_mem_event(self, wid: int, event: str) -> None:
        if event == "vta_hit":
            self.score[wid] += self.bump

    def adopt_score_row(self, score_row: np.ndarray) -> None:
        """Re-point the LLS scores at a batched-plane row. The decay is
        in-place, so the C stepper's score pointer stays valid forever."""
        score_row[:] = self.score
        self.score = score_row

    def next_epoch_after(self, li: int) -> int:
        return self._low_epoch_after(li)     # decay runs every epoch

    def epoch_tick(self, active, finished, mem_util=0.0) -> None:
        fin = np.asarray(finished, bool)
        alive = np.zeros(self.n, bool)
        if active is None:                  # simulator fast path: all warps
            alive[:len(fin)] = ~fin
        else:
            act = np.asarray(list(active), np.int64)
            alive[act[~fin[act]]] = True
        blocked = _epoch.ccws_tick(self.score[None], self._base1,
                                   self._budget1, alive[None],
                                   self.allowed_mask[None], _epoch.IDX0)
        self.blocked = set(map(int, np.flatnonzero(blocked[0])))
        self.mask_version += 1


class StatPCALPolicy(BestSWLPolicy):
    """statPCAL [27]-style bypass scheme: static limit like Best-SWL, but
    when L2/DRAM bandwidth is underutilized the throttled warps are released
    in *bypass* mode (skip L1D, go straight to the memory hierarchy)."""

    name = "statpcal"

    def __init__(self, num_warps, detector, limit: int = 48,
                 util_threshold: float = 0.6):
        self._bypass1 = np.zeros(1, bool)
        self._thresh1 = np.full(1, util_threshold, np.float64)
        self._base_mask = np.zeros(num_warps, bool)
        self.util_threshold = util_threshold
        super().__init__(num_warps, detector, limit)

    @property
    def bypass_active(self) -> bool:
        return bool(self._bypass1[0])

    @bypass_active.setter
    def bypass_active(self, value: bool) -> None:
        self._bypass1[0] = value

    def adopt_statpcal_rows(self, bypass1: np.ndarray, thresh1: np.ndarray,
                            base_row: np.ndarray) -> None:
        bypass1[:] = self._bypass1
        thresh1[:] = self._thresh1
        base_row[:] = self._base_mask
        self._bypass1 = bypass1
        self._thresh1 = thresh1
        self._base_mask = base_row

    def _rebuild_masks(self) -> None:
        bm = self._base_mask
        bm[:] = False
        if self.allowed:
            bm[list(self.allowed)] = True
        if self.bypass_active:
            self.allowed_mask[:] = True
            self.bypass_mask[:] = ~bm
        else:
            self.allowed_mask[:] = bm
            self.bypass_mask[:] = False
        self.mask_version += 1

    def epoch_tick(self, active, finished, mem_util=0.0) -> None:
        changed = _epoch.statpcal_tick(
            self._bypass1, np.asarray([mem_util], np.float64),
            self._thresh1, self._base_mask[None], self.allowed_mask[None],
            self.bypass_mask[None], _epoch.IDX0)
        if changed[0]:
            self.mask_version += 1

    def next_epoch_after(self, li: int) -> int:
        return self._low_epoch_after(li)     # bandwidth probe every epoch


@dataclasses.dataclass
class WarpFlags:
    v: int = 1   # 1 = active, 0 = stalled
    i: int = 0   # 1 = isolated (memory requests redirected to smem)


class CIAOPolicy(BasePolicy):
    """Algorithm 1. mode: 'p' (isolate only), 't' (throttle only), 'c' (both).

    The per-warp V (active) and I (isolated) bits ARE the cached masks:
    ``allowed_mask[w]`` is V, ``isolated_mask[w]`` is I. ``flags`` stays
    available as a read-only snapshot for tools and tests. The
    reverse-order reactivation stacks are fixed (n,)-deep LIFO arrays
    (a warp is on each stack at most once) so the epoch kernels can stack
    them across cells; ``stall_stack``/``isolate_stack`` remain list
    views for tools and tests."""

    def __init__(self, num_warps, detector, mode: str = "c"):
        super().__init__(num_warps, detector)
        assert mode in ("p", "t", "c")
        self.mode = mode
        self.name = f"ciao-{mode}"
        self._stall = np.full(num_warps, NO_WARP, np.int64)
        self._stall_len = np.zeros(1, np.int64)
        self._iso = np.full(num_warps, NO_WARP, np.int64)
        self._iso_len = np.zeros(1, np.int64)

    # -- state queries ------------------------------------------------------
    @property
    def flags(self) -> List[WarpFlags]:
        return [WarpFlags(int(v), int(i)) for v, i
                in zip(self.allowed_mask, self.isolated_mask)]

    @property
    def stall_stack(self) -> List[int]:
        return [int(w) for w in self._stall[:int(self._stall_len[0])]]

    @property
    def isolate_stack(self) -> List[int]:
        return [int(w) for w in self._iso[:int(self._iso_len[0])]]

    def adopt_ciao_rows(self, stall_row: np.ndarray, stall_len: np.ndarray,
                        iso_row: np.ndarray, iso_len: np.ndarray) -> None:
        stall_row[:] = self._stall
        stall_len[:] = self._stall_len
        iso_row[:] = self._iso
        iso_len[:] = self._iso_len
        self._stall = stall_row
        self._stall_len = stall_len
        self._iso = iso_row
        self._iso_len = iso_len

    # -- Algorithm 1 --------------------------------------------------------
    # IRS decisions use the *high-epoch windowed* snapshot (Eq. 1 over the
    # last high-cutoff epoch): "CIAO should track the latest IRS_i" (§IV-A).
    # The same signal gates reactivation (against low-cutoff), giving one
    # high-epoch worth of hysteresis: once an interferer is isolated or
    # stalled, the interfered warp's next window shows the true residual
    # interference and the action is undone if it fell below low-cutoff.
    # `active` may be None, meaning "all warps 0..len(finished)" — the
    # simulator's fast path, which skips the fancy-indexing of the general
    # (subset) form used by direct callers and tests.
    def _alive_mask(self, active, finished) -> np.ndarray:
        fin = np.asarray(finished, bool)
        if active is None:
            m = np.zeros(self.n, bool)
            m[:len(fin)] = self.allowed_mask[:len(fin)] & ~fin
            return m
        act = np.asarray(active, np.int64)
        m = np.zeros(self.n, bool)
        m[act[self.allowed_mask[act] & ~fin[act]]] = True
        return m

    def _n_active(self, active, finished) -> int:
        return max(1, int(np.count_nonzero(
            self._alive_mask(active, finished))))

    def low_epoch_tick(self, active, finished) -> None:
        # Reactivation uses the *cumulative* IRS of Algorithm 1 verbatim
        # (VTAHit[k]/(InstNo/ActiveWarpNo) with per-kernel counters):
        # actions persist until the trigger's rate dilutes below low-cutoff
        # or the trigger finishes — matching the paper's phase-granular
        # behaviour (Fig. 9) and preventing isolate/un-isolate oscillation.
        n_act = np.asarray([self._n_active(active, finished)], np.int64)
        changed = _epoch.ciao_low_tick(
            self.det._pl, self._stall[None], self._stall_len,
            self._iso[None], self._iso_len, self.allowed_mask[None],
            self.isolated_mask[None], self._fin_row(finished)[None],
            n_act, _epoch.IDX0)
        if changed[0]:
            self.mask_version += 1

    def high_epoch_tick(self, active, finished) -> None:
        changed = _epoch.ciao_high_tick(
            self.det._pl, self._stall[None], self._stall_len,
            self._iso[None], self._iso_len, self.allowed_mask[None],
            self.isolated_mask[None], self._fin_row(finished)[None],
            self._alive_mask(active, finished)[None],
            np.asarray([self.mode in ("p", "c")]),
            np.asarray([self.mode in ("t", "c")]), _epoch.IDX0)
        if changed[0]:
            self.mask_version += 1

    def stall_directly(self, j: int, trigger: int) -> bool:
        """§III-C: stall an interferer whose redirection stopped being
        effective (shared-memory thrash / reserve-pool defer). Used by the
        serving engine; the SM simulator reaches the same state through
        high_epoch_tick."""
        if self.mode == "p" or not self.allowed_mask[j]:
            return False
        self.allowed_mask[j] = False
        self.mask_version += 1
        self.det.record_stall(j, trigger)
        sl = int(self._stall_len[0])
        self._stall[sl] = j
        self._stall_len[0] = sl + 1
        return True

    def epoch_tick(self, active, finished, mem_util=0.0) -> None:
        n_active = int(np.count_nonzero(
            self._alive_mask(active, finished)))
        low, high = self.det.poll_epochs(n_active)
        if low:
            self.low_epoch_tick(active, finished)
        if high:
            self.high_epoch_tick(active, finished)

    def next_epoch_after(self, li: int) -> int:
        # empty reactivation stacks -> low-cutoff epochs are provably
        # no-ops (Algorithm 1 lines 4-19 touch nothing, the low-window
        # snapshot feeds no decision), so skip to the next high-cutoff
        # boundary; stacks only grow at high-epoch actions, so this is
        # exact. Same table the batched engine precomputes.
        cfg = self.det.cfg
        low, high = cfg.low_epoch, cfg.high_epoch
        if int(self._stall_len[0]) or int(self._iso_len[0]) \
                or high <= low or high % low != 0:
            return (li // low + 1) * low
        return (li // high + 1) * high


def make_policy(name: str, num_warps: int, detector: InterferenceDetector,
                **kw) -> BasePolicy:
    name = name.lower()
    if name == "gto":
        return GTOPolicy(num_warps, detector)
    if name == "ccws":
        return CCWSPolicy(num_warps, detector, **kw)
    if name == "best-swl":
        return BestSWLPolicy(num_warps, detector, **kw)
    if name == "statpcal":
        return StatPCALPolicy(num_warps, detector, **kw)
    if name in ("ciao-p", "ciao-t", "ciao-c"):
        return CIAOPolicy(num_warps, detector, mode=name[-1])
    raise ValueError(name)
