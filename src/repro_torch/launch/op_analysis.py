"""Per-rank op analysis of an eager step: FLOPs, bytes and collectives.

The counterpart of the reference's ``launch/hlo_analysis.py``, which parses
the post-SPMD optimized HLO of a compiled step. Eager torch has no HLO: here
a ``TorchDispatchMode`` sees every op that one rank runs, DTensor's local
ops and collectives included, and counts the same three roofline inputs:

  * ``flops``: the products only, as the reference's ``dot``/``convolution``
    count: ``2 · prod(out) · prod(contracting dims)`` from
    ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``, ``addmm``,
    convolutions, ...) and the custom ops' own formulas (K2 and K3 count the
    dense products of the reference's jnp attention). Elementwise FLOPs are
    excluded, as there.
  * ``bytes``: the inputs and outputs of every local op but views and
    metadata ops (``_NO_TRAFFIC``); slicing and gathering ops at twice their
    output, updating ops at three times it, as the reference's. An upper
    bound on device-memory traffic: eager torch fuses nothing.
  * ``bytes_hbm_model``: the products, the slicing/gathering/updating ops
    and the collectives only (the reference's TPU-fusion model).
  * collectives by the reference's kinds: raw bytes are the op's result,
    effective bytes apply the ring factors (all-reduce 2(K-1)/K,
    all-gather/reduce-scatter/all-to-all (K-1)/K), K the size of the
    collective's process group.

Counts are per rank: a DTensor op is left to DTensor (the mode returns
``NotImplemented`` for DTensor types), which runs the rank's local ops and
collectives back through the mode; the sharding propagator's shape
inference, which runs the op once on FakeTensors of the global shapes and
caches the result, is not counted, so a first and a second call count the
same. Eager code runs a Python loop's body each time, so a loop is counted
by its trip count with nothing else to do: the reference's
``num_computations``, ``num_executable`` and ``loop_multipliers`` (the HLO's
computations and while-loop multipliers) have no counterpart and are left
out, and so is ``cost_analysis_dict`` (XLA's own cost analysis).

``MemoryTracker`` is the counterpart of XLA's memory analysis: the bytes of
one rank's live storages, each added when an op creates it (its local
tensors only, never the sharding propagator's FakeTensors of the global
shapes) and taken off when it is freed (a weakref finalizer on the
storage), and their peak.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# The reference's ring factors (hlo_analysis.py), by kind.
COLL_FACTORS = {
    "all-reduce": lambda k: 2.0 * (k - 1) / k,
    "all-gather": lambda k: (k - 1) / k,
    "reduce-scatter": lambda k: (k - 1) / k,
    "all-to-all": lambda k: (k - 1) / k,
    "collective-permute": lambda k: 1.0,
}
COLLECTIVE_KINDS = tuple(COLL_FACTORS)

# torch's functional collectives (what DTensor and the decode merge call)
# by the reference's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops whose inputs are not full-size reads (the reference's _SLICE_LIKE and
# _UPDATE_LIKE), by their aten names
_SLICE_LIKE = ("index", "index_select", "gather", "embedding")
_UPDATE_LIKE = ("index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
                "scatter_add", "scatter_add_", "index_copy", "index_copy_", "slice_scatter",
                "select_scatter")
# views are told by ``OpOverload.is_view``; these move no bytes either
_NO_TRAFFIC = ("detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
               "new_empty", "new_empty_strided", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset", "wait_tensor",
               "_wrap_tensor_autograd", "set_", "resize_")


# ops whose result is their input's storage in an eager run (a collective's
# result waited for, or wrapped for autograd; their meta kernels allocate)
_ALIASING = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int:
    """K of a functional collective: the size of the group its last string
    argument names."""
    name = next(a for a in reversed(args) if isinstance(a, str))
    return dist.distributed_c10d._resolve_process_group(name).size()


class OpCounter(TorchDispatchMode):
    """Counts one rank's local ops while active; ``summary()`` gives the
    reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_hbm_model = 0.0
        self.coll_eff: Dict[str, float] = {}
        self.coll_raw: Dict[str, float] = {}
        self.coll_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out          # the sharding propagator's shape inference
        packet = func._overloadpacket
        name = packet.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        kind = _COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            k = _group_size(args)
            raw = _nbytes(out)
            if k > 1:
                self.coll_eff[kind] = self.coll_eff.get(kind, 0.0) + raw * COLL_FACTORS[kind](k)
                self.coll_raw[kind] = self.coll_raw.get(kind, 0.0) + raw
                self.coll_ops += 1
            moved = _nbytes(args) + raw
            self.bytes += moved
            self.bytes_hbm_model += moved
            return out
        if name in _SLICE_LIKE:
            moved = 2 * _nbytes(out)
        elif name in _UPDATE_LIKE:
            moved = 3 * _nbytes(out)
        else:
            moved = _nbytes((args, kwargs)) + _nbytes(out)
        self.bytes += moved
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.bytes_hbm_model += moved
        elif name in _SLICE_LIKE or name in _UPDATE_LIKE:
            self.bytes_hbm_model += moved
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "bytes_hbm_model": float(self.bytes_hbm_model),
            "collective_bytes_effective": dict(self.coll_eff),
            "collective_bytes_raw": dict(self.coll_raw),
            "collective_total_effective": sum(self.coll_eff.values()),
            "collective_total_raw": sum(self.coll_raw.values()),
            "collective_num_ops": self.coll_ops,
        }


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """``fn(*args, **kwargs)`` run once under an ``OpCounter``: this rank's
    FLOPs, bytes and collectives (the reference's ``analyze`` keys but the
    HLO's loop bookkeeping)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.summary()


class MemoryTracker(TorchDispatchMode):
    """One rank's live storage bytes while active, and their peak. Each
    storage counts once, from the op that creates it (views and in-place
    ops add nothing) until it is freed; ``track`` adds tensors made before
    the tracker started (a step's arguments), DTensors by their local
    shard."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def track(self, *tensors) -> None:
        for t in tensors:
            self._add(t.to_local() if isinstance(t, DTensor) else t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def _alias(self, st) -> None:
        """Count nothing for ``st`` (it stands for a storage already
        counted) until it is freed."""
        key = st._cdata
        self._held[key] = 0
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves((args, kwargs, out))):
            return out          # the sharding propagator's shape inference
        if func._overloadpacket.__name__ in _ALIASING:
            # the collective's result, already counted; on the meta device
            # the wrap's kernel makes a new storage, which views then share
            if isinstance(out, torch.Tensor) and out.untyped_storage()._cdata not in self._held:
                self._alias(out.untyped_storage())
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out
