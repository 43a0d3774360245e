"""Logical-axis sharding: names -> mesh axes -> DTensor placements.

The reference's ``parallel/sharding.py`` on torch. Model code never names
physical mesh axes; it annotates tensors with logical axis names
("act_batch", "p_heads", ...). A :class:`ShardEnv` resolves those through a
*rules* table onto whatever mesh it holds, dropping physical axes the mesh
does not have, so the same model code runs on one device, on the 256-chip
single pod and on the 512-chip pod pair.

The mesh is either a :class:`MeshShape` (names and sizes, no devices: the
counterpart of JAX's ``AbstractMesh``, on which resolution is checked at the
production sizes) or a ``torch.distributed.device_mesh.DeviceMesh``. A
resolved spec is a tuple with one entry a tensor dimension (None, a mesh
axis name, or a tuple of names, major to minor: the reference's
``PartitionSpec``); ``placements`` turns it into one DTensor placement a
mesh dimension, and ``constrain`` redistributes a DTensor to it (the
counterpart of ``with_sharding_constraint``; a plain tensor passes
unchanged).

Baseline parallelism (the rule tables are the reference's, key for key):
  * FSDP: weight "p_embed"/"p_ff_in" dims over ``data``
  * TP:   heads / mlp hidden / vocab / experts over ``model``
  * DP:   activation batch over ``pod`` + ``data``
  * SP (decode): KV-cache sequence over ``model``
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

Axes = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# Rule tables. Keys are logical axis names; values are physical mesh axes.
# ---------------------------------------------------------------------------
DEFAULT_RULES: Dict[str, Axes] = {
    # --- activations ---
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_kv_seq": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_embed": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_inner": "model",       # ssm/rglru recurrent width
    # --- params ---
    "p_vocab": "model",
    "p_embed": "data",          # FSDP shard of the model dim
    "p_heads": "model",
    "p_mlp": "model",
    "p_experts": "model",       # EP (arctic)
    "p_expert_ff": None,        # per-expert ff; "model" in TP-expert mode
    "p_ff_in": "data",          # FSDP shard of FFN input dim
    "p_inner": "model",         # ssm/rglru inner width
    "p_state": None,
    "layers": None,
    "p_none": None,
    "pod_stack": "pod",         # leading per-pod dim (compression err state)
}

# Decode: batch stays on data, KV sequence sharded over model (SP); heads
# replicated (kv_heads < model size for every assigned arch).
DECODE_RULES: Dict[str, Axes] = {
    **DEFAULT_RULES,
    "act_heads": None,
    "act_kv_heads": None,
    "act_kv_seq": "model",
    "act_mlp": "model",
}

# long_500k: batch=1 -> nothing for data/pod to do on activations; spread the
# half-million-token KV across every chip.
LONG_DECODE_RULES: Dict[str, Axes] = {
    **DECODE_RULES,
    "act_batch": None,
    "act_kv_seq": ("pod", "data", "model"),
}

RULE_SETS = {
    "train": DEFAULT_RULES,
    "prefill": DEFAULT_RULES,
    "decode": DECODE_RULES,
    "long_decode": LONG_DECODE_RULES,
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: axis names and sizes, major to minor."""

    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, major to minor, of a MeshShape or a DeviceMesh."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _tup(a: Axes) -> Tuple[str, ...]:
    return () if a is None else ((a,) if isinstance(a, str) else tuple(a))


def _untup(t: Tuple[str, ...]) -> Axes:
    return None if not t else (t[0] if len(t) == 1 else t)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Tuple[Axes, ...]

    @property
    def placements(self):
        """One DTensor placement a mesh dimension: ``Shard(d)`` where tensor
        dimension ``d`` names it, else ``Replicate()``. A dimension split
        over several mesh axes takes them major to minor, so their order
        must be the mesh's."""
        names = list(mesh_axes(self.mesh))
        out = [Replicate()] * len(names)
        for d, a in enumerate(self.spec):
            idx = [names.index(x) for x in _tup(a)]
            if idx != sorted(idx):
                raise ValueError(f"dimension {d} splits over {a}, not in the mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return out


@dataclasses.dataclass(frozen=True)
class ShardEnv:
    """Mesh + logical rules, threaded through model code."""

    mesh: Any                     # MeshShape or DeviceMesh
    rules: Mapping[str, Axes]

    @property
    def axes(self) -> Dict[str, int]:
        return mesh_axes(self.mesh)

    @property
    def size(self) -> int:
        return math.prod(self.axes.values())

    # -- resolution --------------------------------------------------------
    def _resolve(self, name: Optional[str]) -> Axes:
        if name is None:
            return None
        if name not in self.rules:
            raise KeyError(f"unknown logical axis {name!r}")
        present = tuple(a for a in _tup(self.rules[name]) if a in self.axes)
        return _untup(present)

    def _fit(self, axes: Axes, dim: int) -> Axes:
        """Drop trailing mesh axes until ``dim`` is divisible by the shard
        product (kv_heads=4 cannot shard 16 ways; vocab 49155 is odd; ...)."""
        tup = _tup(axes)
        sizes = self.axes
        while tup:
            prod = 1
            for a in tup:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            tup = tup[:-1]
        return _untup(tup)

    def pspec(self, *logical: Optional[str], shape=None) -> Tuple[Axes, ...]:
        """The resolved spec: one entry a dimension (None, an axis name or a
        tuple of names). With ``shape``, each dimension keeps only the axes
        that divide it; a mesh axis appears in at most one dimension, the
        first that names it."""
        axes = [self._resolve(n) for n in logical]
        if shape is not None:
            axes = [self._fit(a, d) for a, d in zip(axes, shape)]
        used: set = set()
        deduped = []
        for a in axes:
            kept = tuple(x for x in _tup(a) if x not in used)
            used.update(kept)
            deduped.append(_untup(kept))
        return tuple(deduped)

    def sharding(self, *logical: Optional[str], shape=None) -> "Sharding":
        return Sharding(self.mesh, self.pspec(*logical, shape=shape))

    def placements(self, *logical: Optional[str], shape=None):
        return self.sharding(*logical, shape=shape).placements

    def constrain(self, x, *logical: Optional[str], grad: bool = False):
        """``x`` redistributed to the logical spec ('' / None = replicated
        dim); a plain tensor unchanged. A DTensor is redistributed on a mesh
        of one device too, where it moves nothing: its placements (a
        product's ``Partial``) then say what the next ops expect. With
        ``grad``, its gradient is redistributed to the same spec too
        (``_Constrained``), as the transpose of the reference's
        ``with_sharding_constraint`` constrains the cotangent. Only the
        MLP's output passes it (``layers.mlp_apply``): there a gradient
        still pending a sum over ``model`` is reduced at the residual
        stream, not left to the product's backward. Elsewhere DTensor's
        own backward gives the same collectives (gemma2-2b's records are
        equal with every constraint passing it), or the extra
        redistributions cost more than they pin (at the SSD's
        constraints they change mamba2's collectives and slow its
        backward's sharding propagation many times over)."""
        if not isinstance(x, DTensor):
            return x
        names = [n if n else None for n in logical]
        placements = tuple(self.placements(*names, shape=x.shape))
        if grad:
            return _Constrained.apply(x, placements)
        return x.redistribute(x.device_mesh, placements)

    # -- axis sizes ---------------------------------------------------------
    def axis_size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.axes.get(a, 1)
        return n

    @property
    def tp(self) -> int:
        return self.axis_size("model")

    @property
    def dp(self) -> int:
        return self.axis_size("pod", "data")

    @property
    def fsdp(self) -> int:
        return self.axis_size("data")

    def with_rules(self, overrides: Mapping[str, Axes]) -> "ShardEnv":
        merged = dict(self.rules)
        merged.update(overrides)
        return dataclasses.replace(self, rules=merged)

    def without_axes(self, *axes: str) -> "ShardEnv":
        """Strip mesh axes from every rule (the reference's body of a
        shard_map manual over them; here the per-pod loss, which runs on the
        mesh without ``pod``)."""
        drop = set(axes)
        return dataclasses.replace(
            self, rules={k: _untup(tuple(a for a in _tup(v) if a not in drop))
                         for k, v in self.rules.items()})


class _Constrained(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too.
    DTensor's own redistribute hands the gradient back in the input's
    placements (a pending sum stays pending), which leaves the backward's
    collectives to its sharding propagation."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


# The keys whose rules differ between the two serving phases: heads over
# ``model`` at prefill, the KV sequence over it at decode.
PHASE_KEYS = tuple(k for k in DECODE_RULES if DECODE_RULES[k] != DEFAULT_RULES[k])


def phase_env(env: Optional[ShardEnv], mode: str) -> Optional[ShardEnv]:
    """``env`` with the rules of serving phase ``mode`` ("prefill" or
    "decode") at ``PHASE_KEYS``, its other rules (the batch's, overrides)
    kept; None stays None."""
    if env is None:
        return None
    return env.with_rules({k: RULE_SETS[mode][k] for k in PHASE_KEYS})


def on_devices(env: Optional[ShardEnv]) -> bool:
    """Whether ``env`` holds a DeviceMesh (DTensors), not a description."""
    return env is not None and not isinstance(env.mesh, MeshShape)


def sharded(env: Optional[ShardEnv]):
    """While a sharded step runs, plain tensors among DTensors (RoPE's
    frequencies, positions, masks) count as replicated."""
    return implicit_replication() if on_devices(env) else contextlib.nullcontext()


def make_env(mesh, mode: str = "train",
             overrides: Sequence[Tuple[str, Axes]] = ()) -> ShardEnv:
    rules = dict(RULE_SETS[mode])
    for k, v in overrides:
        rules[k] = v
    return ShardEnv(mesh=mesh, rules=rules)


def local_env(mode: str = "train") -> ShardEnv:
    """One device with both axes named: constraints are no-ops."""
    return make_env(MeshShape((1, 1), ("data", "model")), mode)


def is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def spec_map(fn, tree):
    """``fn`` over the spec leaves of a tree of dicts, lists and tuples."""
    if is_spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v) for k, v in tree.items()}
    return type(tree)(spec_map(fn, v) for v in tree)


def _zip_specs(fn, specs, struct):
    """``fn(spec, leaf)`` over a spec tree and the tensor tree beside it."""
    if is_spec_leaf(specs):
        return fn(specs, struct)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, struct[k]) for k, v in specs.items()}
    return type(specs)(_zip_specs(fn, v, s) for v, s in zip(specs, struct))


def fit_rank(spec, ndim: int):
    """``spec`` cut or padded with None to ``ndim`` entries."""
    return tuple(spec[:ndim]) + (None,) * max(0, ndim - len(spec))


def tree_shardings(env: ShardEnv, logical_tree, struct_tree=None) -> Any:
    """Map a tree of logical-axis tuples to Shardings. With ``struct_tree``
    (the matching tensors, meta ones too), resolution is divisibility-aware
    per dimension, and a spec whose length differs from its tensor's rank
    is cut or padded with None."""
    if struct_tree is None:
        return spec_map(lambda spec: env.sharding(*spec), logical_tree)
    return _zip_specs(lambda spec, t: env.sharding(*fit_rank(spec, t.dim()), shape=tuple(t.shape)),
                      logical_tree, struct_tree)


def distribute(x, sharding: Sharding):
    """The global tensor ``x`` (the same on every rank) as a DTensor with
    ``sharding`` on its DeviceMesh: each rank keeps its shard. Where every
    mesh dimension that splits ``x`` has one device, the shard is ``x``
    itself, wrapped without a copy."""
    mesh, placements = sharding.mesh, sharding.placements
    if all(n == 1 for p, n in zip(placements, mesh.shape) if p.is_shard()):
        return DTensor.from_local(x, mesh, placements, shape=x.shape, stride=x.stride())
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def zeros(shape, dtype, device, sharding: Sharding):
    """A zeroed DTensor of global ``shape`` placed by ``sharding``, each rank
    allocating only its own shard (on ``device``, the meta device too)."""
    local = list(shape)
    for p, n in zip(sharding.placements, sharding.mesh.shape):
        if p.is_shard():
            local[p.dim] //= n
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), sharding.mesh,
                              sharding.placements, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, reckoned without
    making one (a global-shape tensor would count as this rank's memory in
    the dry run)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))


def distribute_tree(tree, shardings):
    """``distribute`` over a tree of tensors and its tree of Shardings."""
    if isinstance(shardings, Sharding):
        return distribute(tree, shardings)
    if isinstance(shardings, dict):
        return {k: distribute_tree(tree[k], v) for k, v in shardings.items()}
    return type(shardings)(distribute_tree(t, v) for t, v in zip(tree, shardings))


def fsdp_gathered(w):
    """A weight as a product against it reads it: whole over every mesh
    dimension but ``model`` (the FSDP gather: the rules split "p_embed" and
    "p_ff_in" over ``data``, the axis of the activations' batch), still
    split over ``model`` (TP). Its gradient comes back reduce-scattered to
    the weight's placements. GSPMD gathers the reference's weights alike;
    pinned here, DTensor's sharding propagation cannot gather the
    activations' batch instead (a choice that moved between torch
    versions). A plain tensor passes unchanged."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    if all(p == Replicate() or n == "model" or size == 1
           for n, p, size in zip(mesh.mesh_dim_names, w.placements, mesh.shape)):
        return w            # nothing to gather (a mesh of one rank a dimension too)
    pl = [p if n == "model" else Replicate() for n, p in zip(mesh.mesh_dim_names, w.placements)]
    return w.redistribute(mesh, pl)


def reduced(x):
    """A DTensor's pending reductions (``Partial`` placements, such as a max
    or a sum over a split dimension) carried out, one all-reduce a mesh
    dimension; anything else as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in x.placements])
    return x


def constrain(env: Optional[ShardEnv], x, *logical: Optional[str], grad: bool = False):
    """``env.constrain(x, *logical, grad=grad)``, or ``x`` when there is no
    env: the model's constraint points with ``env=None`` are the
    single-device path."""
    return x if env is None else env.constrain(x, *logical, grad=grad)


def placed_like(x, p):
    """A DTensor ``x`` (a gradient, an update) in the placements of ``p``
    (autograd may leave it partial); anything else as it is."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(p.placements):
        return x.redistribute(p.device_mesh, p.placements)
    return x
