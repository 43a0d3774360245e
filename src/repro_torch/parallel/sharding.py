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
import functools
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
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
    # the running step's tokens (0: not given); a product against a weight
    # of more rows moves the tokens' rows to it (``moves_rows``)
    tokens: int = 0

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
        ``with_sharding_constraint`` constrains the cotangent. Five
        constraints pass it, each where a gradient still pending a sum
        over ``model`` would otherwise be left to the next product's
        backward, whose choice moved with the torch version: the outputs
        of the MLP (``layers.mlp_apply``), the attention
        (``attention.output_proj``), the RG-LRU (``rglru.rglru_forward``)
        and the SSD (``ssd.ssd_forward``), each reduced at the residual
        stream, and the attention's input where wq and wk split
        differently (``attention.project_qkv``). The SSD's scan runs under
        ``local_map``, so its output's constraint no longer slows the
        backward's sharding propagation (reduced mamba2's train cell on a
        (2, 2, 2) mesh counts in seconds either way). The others (a
        block's inner activations, B‖C, the SSD's parts, the decode
        path) stay without it: DTensor's own backward gives the
        collectives the reference's transpose gives there."""
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


def step_env(env: Optional[ShardEnv], tokens: int) -> Optional[ShardEnv]:
    """``env`` for a step of ``tokens`` tokens (rows, all ranks'); None
    stays None."""
    return None if env is None else dataclasses.replace(env, tokens=int(tokens))


def moves_rows(w, env: Optional[ShardEnv], k: int) -> bool:
    """Whether a product against the weight ``w`` of ``k`` rows (its
    contraction; a table's vocab for a lookup) brings its rows to w
    (``rows_product``) rather than gathering w over its FSDP split
    (``fsdp_gathered``): whichever moves less. The rows move when the
    step's tokens (``env.tokens``, every rank's) are fewer than w's rows,
    no gradient is taken, and a mesh dimension of more than one rank other
    than ``model`` splits w. A decode step moves its rows (128 at
    decode_32k, against K >= 1,024); a training or prefill step, of more
    tokens than any weight has rows, gathers the weight, and so does any
    step that takes gradients: a weight's gradient is reduce-scattered to
    its split anyway."""
    if not (isinstance(w, DTensor) and env is not None and 0 < env.tokens < k):
        return False
    mesh = w.device_mesh
    return not torch.is_grad_enabled() and any(
        p.is_shard() and n != "model" and size > 1
        for n, p, size in zip(mesh.mesh_dim_names, w.placements, mesh.shape))


def product(x, w, env: Optional[ShardEnv] = None, view=None):
    """``x @ view(w)``, ``view`` turning the stored weight into the (K, N)
    matrix the product reads (the tied table's transpose, a flattening of
    heads; by default w itself): on a mesh, ``rows_product`` against
    ``view(w)`` where ``moves_rows`` says so, else against the view of w
    gathered over its FSDP split (``fsdp_gathered``). The one place that
    chooses between moving the rows and gathering the weight."""
    view = view or (lambda t: t)
    if moves_rows(w, env, x.shape[-1]):
        return rows_product(x, view(w))
    return x @ view(fsdp_gathered(w))


def rows_product(x, w):
    """x (..., K) @ w (K, N), DTensors, with x's rows brought to the weight's
    split, pinned collective by collective on the local shards (torch's
    functional collectives; no gradient). Mesh dimension by dimension:

    * where w's K is split (FSDP over ``data``; TP over ``model``), x's K
      is split alike: rows split there go to the ranks by K slice (an
      all-to-all); the product's partial sums over that dimension are
      reduced in f32, reduce-scattered back to the rows' split, or
      all-reduced;
    * where w's N is split, x's rows come whole (an all-gather, where they
      were split), and each rank hands its columns of the other ranks'
      rows back after the sums (an all-to-all, in x's dtype);
    * where neither is, x's rows stay as they are; the first such
      dimension that splits nothing else (``model`` where the heads or the
      vocab do not divide it) splits w's N for the product, as GSPMD moves
      a decode batch onto that otherwise idle axis, and the output keeps
      the split (the next constraint gathers it where the model's rules
      say so).

    The product's partial sums come out in f32 (its operands read in their
    own dtype where the device has the mixed product: CUDA, and meta
    tensors in the dry run), are reduced in f32, and the output is rounded
    to x's dtype once."""
    mesh, dtype = w.device_mesh, x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, k)
    xl, wl = x.to_local(), w.to_local()
    free = not any(p == Shard(1) and n > 1 for p, n in zip(w.placements, mesh.shape))
    out, reduce, expand = [], [], []    # output placements; all-reduces; row moves in order
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        size, group, rank = mesh.size(i), (mesh, i), mesh.get_local_rank(i)
        rows = px == Shard(0) and size > 1
        if px.is_partial() or (px == Shard(1) and pw != Shard(0) and size > 1):
            raise NotImplementedError(f"a product of rows placed {x.placements} "
                                      f"against a weight placed {w.placements}")
        if size == 1:
            out.append(Replicate())
        elif pw == Shard(0):                            # K split
            if rows:
                xl = rows_to_slices(xl, size, group)
                expand.append((i, "sum"))
                out.append(Shard(0))
            else:
                if px != Shard(1):
                    xl = _chunk(xl, 1, size, rank)
                reduce.append(i)
                out.append(Replicate())
        elif pw == Shard(1):                            # N split
            if rows:
                xl = funcol.all_gather_tensor(xl, 0, group)
                expand.append((i, "back"))
            out.append(Shard(0) if rows else Shard(1))
        elif rows:
            out.append(Shard(0))
        elif free:
            wl = _chunk(wl, 1, size, rank)
            free = False
            out.append(Shard(1))
        else:
            out.append(Replicate())
    if dtype == torch.float32 or xl.device.type == "cpu" or \
            "dtype" not in torch.ops.aten.mm.overloads():
        yl = xl.float() @ wl.float()                    # the CPU has no mixed product
    else:                                               # the operands read in their dtype
        yl = torch.mm(xl, wl, out_dtype=torch.float32)
    for i in reduce:
        yl = funcol.all_reduce(yl, "sum", (mesh, i))
    for n, (i, how) in enumerate(reversed(expand)):
        if how == "sum":
            yl = funcol.reduce_scatter_tensor(yl, "sum", 0, (mesh, i))
        else:
            if not any(h == "sum" for _, h in expand[:len(expand) - n]):
                yl = yl.to(dtype)
            yl = slices_to_rows(yl, mesh.size(i), (mesh, i))
    yl = funcol.wait_tensor(yl.to(dtype))
    y = DTensor.from_local(yl, mesh, out, shape=torch.Size((x.shape[0], w.shape[1])),
                           stride=(w.shape[1], 1))
    return y.reshape(*lead, w.shape[1])


def _chunk(t, dim: int, n: int, rank: int):
    """Rank ``rank``'s slice of t's dimension ``dim`` split n ways as a
    DTensor ``Shard`` splits it: slices of ceil(size / n), the last ones
    shorter or empty."""
    step = -(-t.shape[dim] // n)
    start = min(rank * step, t.shape[dim])
    return t.narrow(dim, start, min(step, t.shape[dim] - start))


def rows_to_slices(xl, n: int, group):
    """Rows (r, K) of this rank of a group of n to every rank's rows of
    this rank's K slice (n·r, K/n), the group's rows in rank order."""
    r, k = xl.shape
    send = xl.reshape(r, n, k // n).transpose(0, 1).reshape(n * r, k // n)
    return funcol.all_to_all_single(send, None, None, group)


def slices_to_rows(yl, n: int, group):
    """Every rank's rows of this rank's column slice (n·r, c) to this
    rank's rows of every slice (r, n·c): ``rows_to_slices`` reversed."""
    c = yl.shape[1]
    got = funcol.all_to_all_single(yl.contiguous(), None, None, group)
    return got.reshape(n, -1, c).transpose(0, 1).reshape(-1, n * c)


def column_parts(t, sizes: Sequence[int]):
    """The parts of t's last dimension, of ``sizes``, each split over
    ``model`` on its own: a fused projection's columns (z, x, B‖C, dt of
    the SSD's ``w_in``), split over ``model`` in slices that straddle the
    parts' ends, regrouped so that each rank holds its slice of every part
    (one all-to-all over ``model``; the split must divide every part). A
    plain tensor, or one whose last dimension ``model`` does not split, is
    sliced."""
    mesh_dim = _last_dim_split(t)
    if mesh_dim is None:
        return list(torch.split(t, list(sizes), dim=-1))
    mesh, i = t.device_mesh, mesh_dim
    n, rank = mesh.size(i), mesh.get_local_rank(i)
    if any(size % n for size in sizes):
        raise NotImplementedError(f"parts {tuple(sizes)} split {n} ways")
    width = t.shape[-1] // n
    have = [[(r * width, (r + 1) * width)] for r in range(n)]
    want = [_part_ranges(sizes, n, r) for r in range(n)]
    local = _move_columns(t.to_local(), have, want, rank, (mesh, i))
    pl = list(t.placements)
    pl[i] = Shard(t.dim() - 1)
    out = []
    for size, part in zip(sizes, local.split([size // n for size in sizes], dim=-1)):
        shape = (*t.shape[:-1], size)
        out.append(DTensor.from_local(part, mesh, pl, shape=torch.Size(shape),
                                      stride=contiguous_stride(shape)))
    return out


def joined_columns(parts):
    """``column_parts`` reversed: the parts, placed as ``column_parts``
    gives them, joined on the last dimension and split over ``model`` in
    even slices (one all-to-all). Plain tensors are concatenated."""
    mesh_dim = _last_dim_split(parts[0])
    if mesh_dim is None:
        return torch.cat(parts, dim=-1)
    mesh, i = parts[0].device_mesh, mesh_dim
    n, rank = mesh.size(i), mesh.get_local_rank(i)
    sizes = [p.shape[-1] for p in parts]
    shape = (*parts[0].shape[:-1], sum(sizes))
    pl = list(parts[0].placements)
    width = sum(sizes) // n
    have = [_part_ranges(sizes, n, r) for r in range(n)]
    want = [[(r * width, (r + 1) * width)] for r in range(n)]
    local = torch.cat([p.to_local() for p in parts], dim=-1)
    local = _move_columns(local, have, want, rank, (mesh, i))
    pl[i] = Shard(len(shape) - 1)
    return DTensor.from_local(local, mesh, pl, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _last_dim_split(t):
    """The mesh dimension of more than one rank that splits t's last
    dimension, or None (a plain tensor too)."""
    if not isinstance(t, DTensor):
        return None
    last = Shard(t.dim() - 1)
    dims = [i for i, (p, n) in enumerate(zip(t.placements, t.device_mesh.shape))
            if n > 1 and (p == last or p == Shard(-1))]
    if len(dims) > 1:
        raise NotImplementedError(f"a last dimension split over {len(dims)} mesh dimensions")
    return dims[0] if dims else None


def _part_ranges(sizes, n: int, rank: int):
    """The global column ranges [a, b) of each part's slice that ``rank``
    of n holds."""
    out, off = [], 0
    for size in sizes:
        w = size // n
        out.append((off + rank * w, off + (rank + 1) * w))
        off += size
    return out


def _move_columns(local, have, want, rank: int, group):
    """Columns of a tensor spread over a group: rank r holds the global
    columns of the ranges ``have[r]`` (in order) and wants those of
    ``want[r]`` (in order). One all-to-all on the last dimension; each
    rank sends every other rank the columns it wants and holds."""
    plan = _column_plan(tuple(map(tuple, have)), tuple(map(tuple, want)), rank)
    send_idx, send_n, recv_n, order = plan
    moved = local.index_select(-1, torch.tensor(send_idx, device=local.device))
    moved = moved.movedim(-1, 0).contiguous()
    got = funcol.all_to_all_single_autograd(moved, list(recv_n), list(send_n), group)
    got = got.movedim(0, -1)
    return got.index_select(-1, torch.tensor(order, device=local.device))


@functools.lru_cache(maxsize=256)
def _column_plan(have, want, rank: int):
    """(local indices to send in order, counts sent to each rank, counts
    received from each, the received columns' order in ``want[rank]``)."""
    def cols(ranges):
        return [c for a, b in ranges for c in range(a, b)]
    owner = {c: src for src, ranges in enumerate(have) for c in cols(ranges)}
    mine = {c: j for j, c in enumerate(cols(have[rank]))}
    send_idx, send_n = [], []
    for dest in range(len(want)):
        sent = [mine[c] for c in cols(want[dest]) if owner[c] == rank]
        send_idx += sent
        send_n.append(len(sent))
    wanted = cols(want[rank])
    received, recv_n = [], []
    for src in range(len(have)):
        got = [c for c in wanted if owner[c] == src]
        received += got
        recv_n.append(len(got))
    pos = {c: j for j, c in enumerate(received)}
    return tuple(send_idx), tuple(send_n), tuple(recv_n), tuple(pos[c] for c in wanted)


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
