"""Cache-interference detection (paper §III-A, §IV-A, Fig. 6).

Faithful implementation of:

* **Interference list** — 64 entries indexed by interfered WID, each holding
  a 6-bit interfering WID + 2-bit saturating counter. The counter tracks the
  *most recently and frequently* interfering warp: same-warp events increment
  (saturating at 3), different-warp events decrement; the stored WID is
  replaced only when the counter underflows at 0 (Fig. 4c).

* **Pair list** — 64 entries x two 6-bit fields: field 0 records which
  interfered warp triggered the *redirection* (isolation) of this warp,
  field 1 which triggered its *stall*. -1 = empty. Used by Algorithm 1 to
  undo actions in reverse order.

* **IRS** (Eq. 1): ``IRS_i = F_vta_hits(i) / (N_exec_inst / N_active_warps)``
  evaluated on two epochs — the high-cutoff epoch (5000 instructions, decide
  isolate/stall) and the low-cutoff epoch (100 instructions, decide
  reactivate/un-redirect). Cutoffs 0.01 / 0.005 (§IV-A; sensitivity §V-E).

The same detector instance is shared by the on-chip memory model (CIAO-P)
and the warp scheduler (CIAO-T) — paper §III-C notes L1D and shared-memory
interference do not mix, so one VTA suffices.

All per-warp counters, the interference/pair lists, and the epoch/IRS
bookkeeping live in a **batch-of-1** :class:`repro_torch.core.epoch.DetPlanes`
row: the epoch math itself (crossing detection, windowed IRS snapshots,
aging) is the vectorized kernel :func:`repro_torch.core.epoch.poll_epochs`,
which the batched engine calls over whole batches of cells at once and
this object calls with ``B == 1``. :meth:`adopt_row` re-points a detector
at a row of a full-batch plane so the engine's kernel writes and the
object's reads share memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import epoch as _epoch
from repro_torch.core.vta import VictimTagArray

NO_WARP = -1


@dataclasses.dataclass
class DetectorConfig:
    num_warps: int = 48
    list_entries: int = 64           # §V-F: 64-entry interference/pair lists
    vta_sets: int = 48
    vta_tags_per_set: int = 8
    high_cutoff: float = 0.01
    low_cutoff: float = 0.005
    high_epoch: int = 5000           # instructions
    low_epoch: int = 100
    sat_max: int = 3                 # 2-bit saturating counter
    # Counter aging (refinement, ablatable): every N high epochs the
    # cumulative VTA-hit counters and the IRS instruction counter are
    # halved (hardware: shift right). Preserves Eq. 1 ratios but bounds the
    # history horizon so reactivation (low-cutoff test) tracks phase
    # changes instead of the whole-kernel average. 0 disables.
    aging_high_epochs: int = 10


def _plane_prop(name, doc=None):
    """2-D plane row: expose the (nw,)/(le,)-shaped row of the detector's
    batch-of-1 planes as a plain array attribute."""
    def get(self):
        return getattr(self._pl, name)[0]
    return property(get, doc=doc)


def _scalar_prop(name, doc=None):
    """1-D plane row: expose element 0 as a plain int attribute."""
    def get(self):
        return int(getattr(self._pl, name)[0])

    def set_(self, value):
        getattr(self._pl, name)[0] = value
    return property(get, set_, doc=doc)


class InterferenceDetector:
    __slots__ = ("cfg", "vta", "_pl", "pair_counts", "vta_hit_events")

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        # None default: a shared mutable DetectorConfig() default instance
        # would leak state (e.g. epoch overrides) between detectors.
        self.cfg = cfg = cfg if cfg is not None else DetectorConfig()
        self.vta = VictimTagArray(cfg.vta_sets, cfg.vta_tags_per_set)
        # canonical state: a batch-of-1 row of the vectorized epoch planes
        self._pl = _epoch.DetPlanes.alloc(1, cfg)
        # the VTA's per-set hit counters ARE the plane row (epoch
        # snapshots and the batched engine's C stepper write through it)
        self.vta.hits = self._pl.vta_hits[0]
        self.vta_hit_events = 0
        # (evictor, victim) -> event count; the Fig. 4 non-uniformity data.
        self.pair_counts: Dict[Tuple[int, int], int] = {}

    # plane-backed attributes (same names/shapes as the former ndarrays
    # and ints; the arrays are row views, so elementwise mutation by the
    # hot loops lands in the planes the epoch kernels read)
    interfering_wid = _plane_prop("interfering")
    sat_counter = _plane_prop("sat")
    pair_list = _plane_prop("pair_list")
    irs_hits = _plane_prop("irs_hits")
    inst_total = _scalar_prop("inst_total")
    irs_inst = _scalar_prop("irs_inst")

    def adopt_row(self, planes: "_epoch.DetPlanes", b: int) -> None:
        """Re-point this detector at row ``b`` of a full-batch plane set
        (used by the batched engine). Current state is copied in; from
        then on object reads and batch-kernel writes share memory."""
        planes.copy_row_from(self._pl, b)
        self._pl = planes.row(b)
        self.vta.hits = planes.vta_hits[b]

    # ------------------------------------------------------------- events
    def on_instruction(self, n: int = 1) -> None:
        self._pl.inst_total[0] += n
        self._pl.irs_inst[0] += n

    def on_eviction(self, owner_wid: int, line_addr: int,
                    evictor_wid: int) -> None:
        self.vta.insert(owner_wid, line_addr, evictor_wid)

    def on_miss(self, wid: int, line_addr: int) -> Optional[int]:
        """Probe VTA; on a VTA hit update the interference list (Fig. 4c)
        and return the interfering WID."""
        vta = self.vta
        # the dominant outcome is a VTA miss: answer it with one dict probe
        # before paying for the full FIFO walk
        if line_addr not in vta._member[wid % vta.num_sets]:
            return None
        evictor = vta.probe(wid, line_addr)
        if evictor is None:  # pragma: no cover - membership implies a hit
            return None
        self.vta_hit_events += 1
        self.irs_hits[wid % self.cfg.num_warps] += 1
        key = (evictor, wid)
        self.pair_counts[key] = self.pair_counts.get(key, 0) + 1
        i = wid % self.cfg.list_entries
        interfering, sat = self.interfering_wid, self.sat_counter
        if interfering[i] == evictor:
            sat[i] = min(sat[i] + 1, self.cfg.sat_max)
        elif interfering[i] == NO_WARP:
            interfering[i] = evictor
            sat[i] = 0
        else:
            if sat[i] == 0:
                interfering[i] = evictor   # replace on underflow
            else:
                sat[i] -= 1
        return evictor

    # ---------------------------------------------------------------- IRS
    def irs(self, wid: int, active_warps: int) -> float:
        """Eq. 1 over the aged cumulative counters."""
        if self.irs_inst == 0 or active_warps <= 0:
            return 0.0
        per_warp_inst = self.irs_inst / active_warps
        if per_warp_inst <= 0:
            return 0.0
        return self.irs_hits[wid % self.cfg.num_warps] / per_warp_inst

    def poll_epochs(self, active_warps: int) -> Tuple[bool, bool]:
        """Check for low/high epoch crossings (robust to batched instruction
        counting). At each crossing, snapshot the *windowed* IRS — Eq. 1
        evaluated over the epoch that just ended, so IRS tracks "the latest
        IRS_i" (§IV-A) and falls once an interferer is isolated/stalled.

        Batch-of-1 delegation to :func:`repro_torch.core.epoch.poll_epochs` —
        the same kernel the batched engine runs over whole batches."""
        low, high = _epoch.poll_epochs(
            self._pl, _epoch.IDX0,
            np.asarray([active_warps], np.int64))
        return bool(low[0]), bool(high[0])

    def irs_low(self, wid: int) -> float:
        """Last low-epoch windowed IRS, from the fixed-point snapshot
        triple (reporting; cutoff decisions use the int compare)."""
        pl = self._pl
        h = int(pl.low_snap_hits[0, wid % self.cfg.num_warps])
        return h * int(pl.low_snap_act[0]) / int(pl.low_snap_win[0])

    def irs_high(self, wid: int) -> float:
        pl = self._pl
        h = int(pl.high_snap_hits[0, wid % self.cfg.num_warps])
        return h * int(pl.high_snap_act[0]) / int(pl.high_snap_win[0])

    def most_interfering(self, wid: int) -> int:
        return int(self._pl.interfering[0, wid % self.cfg.list_entries])

    # ------------------------------------------------------------ pair list
    def record_isolation(self, interfering: int, interfered: int) -> None:
        self._pl.pair_list[0, interfering % self.cfg.list_entries, 0] = \
            interfered

    def record_stall(self, interfering: int, interfered: int) -> None:
        self._pl.pair_list[0, interfering % self.cfg.list_entries, 1] = \
            interfered

    def isolation_trigger(self, wid: int) -> int:
        return int(self._pl.pair_list[0, wid % self.cfg.list_entries, 0])

    def stall_trigger(self, wid: int) -> int:
        return int(self._pl.pair_list[0, wid % self.cfg.list_entries, 1])

    def clear_isolation(self, wid: int) -> None:
        self._pl.pair_list[0, wid % self.cfg.list_entries, 0] = NO_WARP

    def clear_stall(self, wid: int) -> None:
        self._pl.pair_list[0, wid % self.cfg.list_entries, 1] = NO_WARP

    # -------------------------------------------------------------- epochs
    def at_high_epoch(self) -> bool:
        return self.inst_total > 0 and \
            self.inst_total % self.cfg.high_epoch == 0

    def at_low_epoch(self) -> bool:
        return self.inst_total > 0 and \
            self.inst_total % self.cfg.low_epoch == 0
