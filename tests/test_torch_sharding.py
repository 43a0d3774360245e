"""The port's logical-axis sharding against the reference's: the rule tables
key for key, ``tests/test_sharding.py``'s unit tests mirrored, and, for all
ten archs on the (1, 1) test mesh and the production meshes (16, 16) and
(2, 16, 16), every leaf of the parameter, cache, optimizer (AdamW and
Adafactor), train-state (with and without the error feedback) and batch
specs resolved through the port's ``pspec(..., shape=...)`` to the same
mesh axes as the reference's ``pspec`` on a device-free ``AbstractMesh``.

A port leaf is matched to its reference leaf through
``convert.reference_leaf``: where the reference stacks a pattern
position's layers, the port's spec is the reference's without its
"layers" entry, and resolves as the reference's does on the other
dimensions (exact equality of specs and of resolved mesh axes; no
tolerance).
"""
import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.models import model as RM
from repro.parallel import sharding as RS
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch import configs as C
from repro_torch.configs import shapes
from repro_torch.configs.base import RunConfig
from repro_torch.convert import reference_leaf
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.parallel import sharding as S
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


# ------------------------------------------------------------- rule tables
def test_rule_tables_equal_the_references_key_for_key():
    for name in ("DEFAULT_RULES", "DECODE_RULES", "LONG_DECODE_RULES"):
        mine, ref = getattr(S, name), getattr(RS, name)
        assert list(mine) == list(ref), name
        assert mine == ref, name
    assert S.RULE_SETS.keys() == RS.RULE_SETS.keys()
    assert all(S.RULE_SETS[k] == RS.RULE_SETS[k] for k in RS.RULE_SETS)


# ------------------------------------- tests/test_sharding.py, mirrored
def _env2d():
    return S.make_env(S.MeshShape((1, 1), ("data", "model")), "train")


def test_rules_filter_missing_axes():
    assert _env2d().pspec("act_batch", None, "act_mlp") == ("data", None, "model")


def test_divisibility_fit():
    sp = _env2d().pspec("p_embed", "p_heads", shape=(2304, 4))
    assert sp == ("data", "model")
    # at 16-way axes, 4 kv heads cannot split over model
    env = S.make_env(LM.make_production_mesh(), "train")
    assert env.pspec("p_embed", "p_heads", shape=(2304, 4)) == ("data", None)


def test_decode_rules_shard_kv_seq():
    assert S.DECODE_RULES["act_kv_seq"] == "model"
    assert S.DECODE_RULES["act_heads"] is None
    assert S.LONG_DECODE_RULES["act_kv_seq"] == ("pod", "data", "model")
    assert S.LONG_DECODE_RULES["act_batch"] is None


def test_arch_overrides_merge():
    env = _env2d().with_rules({"act_seq": "model"})
    assert env.rules["act_seq"] == "model"
    assert env.rules["act_batch"] == ("pod", "data")


# ------------------------------------------------------- the port's own
def test_meshes_are_the_references():
    assert LM.make_production_mesh() == S.MeshShape((16, 16), ("data", "model"))
    assert LM.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert [LM.make_test_mesh(n).shape_tuple for n in (1, 2, 6, 8, 3)] == [
        (1, 1), (1, 2), (3, 2), (2, 4), (3, 1)]


def test_placements_are_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = S.MeshShape((2, 2, 2), ("pod", "data", "model"))
    env = S.make_env(mesh, "train")
    assert env.placements("act_batch", None, "act_heads", None) == [Shard(0), Shard(0), Shard(2)]
    assert env.placements("p_embed", "p_vocab") == [Replicate(), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="order"):
        S.Sharding(mesh, (("data", "pod"),)).placements


def test_constrain_passes_a_plain_tensor():
    x = torch.ones(4, 8)
    env = S.make_env(S.MeshShape((2, 2), ("data", "model")), "train")
    assert env.constrain(x, "act_batch", "act_embed") is x
    assert S.constrain(None, x, "act_batch") is x


# ------------------------------------------------ resolution of every leaf
def _norm(entry):
    return tuple(entry) if isinstance(entry, (tuple, list)) else entry


def _ref_flat(tree, prefix=""):
    """{path: leaf} of a reference tree whose leaves are spec tuples,
    ShapeDtypeStructs or arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not RS.is_spec_leaf(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_ref_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not S.is_spec_leaf(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _ref_path(cfg, path):
    """The reference's path of a port leaf, and whether the reference
    stacks layers there."""
    parts = path.split("/")
    for i, part in enumerate(parts):
        if part == "layers" or (part == "encoder" and parts[i + 1:i + 2] == ["layers"]):
            mapped = reference_leaf(cfg, "/".join(parts[i:]))
            return "/".join(parts[:i] + [mapped]), "stack" in mapped.split("/")
    return path, False


def _hold(cfg, env_pair, port_specs, port_structs, ref_specs, ref_structs):
    """Every port leaf's spec is its reference leaf's (without "layers"
    where the reference stacks) and resolves to the same mesh axes."""
    env, ref_env = env_pair
    ps, pt = _port_flat(port_specs), _port_flat(port_structs)
    rs, rt = _ref_flat(ref_specs), _ref_flat(ref_structs)
    assert ps.keys() == pt.keys()
    for path, spec in ps.items():
        rpath, stacked = _ref_path(cfg, path)
        rspec, rshape = rs[rpath], tuple(rt[rpath].shape)
        shape = tuple(pt[path].shape)
        if stacked:
            i = rspec.index("layers")
            rspec, rshape = rspec[:i] + rspec[i + 1:], rshape[:i] + rshape[i + 1:]
            ref_axes = tuple(map(_norm, ref_env.pspec(*rs[rpath], shape=rt[rpath].shape)))
            ref_axes = ref_axes[:i] + ref_axes[i + 1:]
        else:
            ref_axes = tuple(map(_norm, ref_env.pspec(*rspec, shape=rshape)))
        assert spec == rspec, path
        assert shape == rshape, path
        assert env.pspec(*spec, shape=shape) == ref_axes, path


@functools.lru_cache(maxsize=None)
def _envs(mesh_i, mode):
    shape, names = MESHES[mesh_i]
    return (S.make_env(S.MeshShape(shape, names), mode),
            RS.make_env(jax.sharding.AbstractMesh(shape, names), mode))


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(name, optimizer):
    cfg = dataclasses.replace(ref_get_config(name), optimizer=optimizer)
    return RM.param_shapes(cfg, RefRunConfig(param_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _ref_state_struct(name, optimizer, comp):
    cfg = dataclasses.replace(ref_get_config(name), optimizer=optimizer)
    return RTS.train_state_struct(cfg, RefRunConfig(param_dtype="float32",
                                                    gradient_compression=comp), npod=2)


@functools.lru_cache(maxsize=None)
def _port_state_specs(name, optimizer, comp):
    cfg = dataclasses.replace(C.get_config(name), optimizer=optimizer)
    return TS.state_logical_specs(cfg, RunConfig(param_dtype="float32", gradient_compression=comp))


@functools.lru_cache(maxsize=None)
def _ref_opt_specs_cached(name, optimizer):
    return _ref_opt_specs(name, optimizer)


@functools.lru_cache(maxsize=None)
def _port_state_struct(name, optimizer, comp):
    cfg = dataclasses.replace(C.get_config(name), optimizer=optimizer)
    return TS.train_state_struct(cfg, RunConfig(param_dtype="float32",
                                                gradient_compression=comp), npod=2)


def _ref_opt_specs(name, optimizer):
    """The reference's optimizer-state specs where its state has the
    leaf. Its ``opt_specs`` gives every Adafactor leaf of two or more
    dimensions {"r", "c"}, while ``adafactor_init`` keeps {"v"} for a leaf
    whose last two dimensions are not both > 1 (the (d, 1, Dh) projections
    of a single kv head); such a "v" takes its parameter's spec."""
    cfg = dataclasses.replace(ref_get_config(name), optimizer=optimizer)
    p_specs = RM.param_specs(cfg)
    specs = RO.opt_specs(optimizer, p_specs)
    if optimizer == "adamw":
        return specs
    state = _ref_flat(_ref_state_struct(name, optimizer, "")["opt"]["v"])
    flat_p = _ref_flat(p_specs)
    flat_s = _ref_flat(specs["v"])
    return {"v": {path: flat_s[path] if path in flat_s else flat_p[path.rsplit("/", 1)[0]]
                  for path in state}, "count": ()}


ARCHS = C.ARCH_NAMES


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=lambda i: "x".join(map(str, MESHES[i][0])))
@pytest.mark.parametrize("name", ARCHS)
def test_param_and_cache_specs_resolve_as_the_references(name, mesh_i):
    cfg, ref_cfg = C.get_config(name), ref_get_config(name)
    train = _envs(mesh_i, "train")
    _hold(cfg, train, M.param_specs(cfg), M.param_shapes(cfg),
          RM.param_specs(ref_cfg), _ref_param_shapes(name, ref_cfg.optimizer))
    # the cache as the decode cell holds it, under the decode rules
    b, s = shapes.DECODE_32K.global_batch, shapes.DECODE_32K.seq_len
    cross = s if cfg.is_encoder_decoder else 0
    port_cache = {"layers": M.init_cache(cfg, b, s, device="meta", cross_len=cross)}
    port_specs = {"layers": M.cache_specs(cfg)}
    _hold(cfg, _envs(mesh_i, "decode"), port_specs, port_cache, RM.cache_specs(ref_cfg),
          RM.cache_struct(ref_cfg, b, s, cross_len=cross))


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=lambda i: "x".join(map(str, MESHES[i][0])))
@pytest.mark.parametrize("name", ARCHS)
def test_optimizer_and_state_specs_resolve_as_the_references(name, mesh_i):
    env = _envs(mesh_i, "train")
    for optimizer in ("adamw", "adafactor"):
        cfg = dataclasses.replace(C.get_config(name), optimizer=optimizer)
        for comp in ("", "int8"):
            mine = _port_state_specs(name, optimizer, comp)
            struct = _port_state_struct(name, optimizer, comp)
            ref_struct = _ref_state_struct(name, optimizer, comp)
            assert mine.keys() == struct.keys() == ref_struct.keys()
            ref_specs = {"opt": _ref_opt_specs_cached(name, optimizer), "step": ()}
            ref_specs["params"] = RM.param_specs(dataclasses.replace(ref_get_config(name),
                                                                     optimizer=optimizer))
            if comp:
                ref_specs["err"] = jax.tree.map(lambda sp: ("pod_stack",) + sp,
                                                ref_specs["params"], is_leaf=RS.is_spec_leaf)
            for key in mine:
                if key == "opt" and optimizer == "adafactor":
                    # the group keys are the reference's paths already
                    _hold(cfg, env, mine["opt"], struct["opt"],
                          ref_specs["opt"], ref_struct["opt"])
                elif key == "step":
                    assert mine["step"] == () and tuple(struct["step"].shape) == ()
                else:
                    _hold(cfg, env, mine[key], struct[key], ref_specs[key], ref_struct[key])
            struct_p = struct["params"]
            assert O.opt_specs(optimizer, M.param_specs(cfg), struct_p,
                               TS.optimizer_groups(cfg, struct_p)) == mine["opt"]


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=lambda i: "x".join(map(str, MESHES[i][0])))
@pytest.mark.parametrize("name", ARCHS)
def test_batch_specs_resolve_as_the_references(name, mesh_i):
    cfg, ref_cfg = C.get_config(name), ref_get_config(name)
    for shape in shapes.shapes_for(cfg):
        mode = "long_decode" if shape.name == "long_500k" else shape.mode
        ref_shape = RefShapeConfig(**dataclasses.asdict(shape))
        mine, ref = TS.batch_logical_specs(cfg, shape.mode), RTS.batch_logical_specs(ref_cfg, shape.mode)
        port_in, ref_in = M.input_specs(cfg, shape), RM.input_specs(ref_cfg, ref_shape)
        if shape.mode == "decode":
            # the port's cache is a list of layers
            mine = {**mine, "cache": {"layers": mine["cache"]}}
            port_in = {**port_in, "cache": {"layers": port_in["cache"]}}
        _hold(cfg, _envs(mesh_i, mode), mine, port_in, ref, ref_in)


def test_tree_shardings_fit_specs_to_rank_and_divisibility():
    env = S.make_env(S.MeshShape((2, 16, 16), ("pod", "data", "model")), "train")
    struct = {"a": torch.empty(8, 3, device="meta"), "b": torch.empty(4, device="meta")}
    sh = S.tree_shardings(env, {"a": ("act_batch", "act_heads", "act_embed"), "b": ("p_vocab",)},
                          struct)
    # 8 rows cannot split 32 ways but split over pod, 3 heads not 16 ways
    assert sh["a"].spec == ("pod", None)
    assert sh["b"].spec == (None,)
    assert S.tree_shardings(env, {"a": ("act_batch",)})["a"].spec == (("pod", "data"),)


def test_distribute_wraps_without_a_copy_on_a_one_device_mesh(tmp_path):
    """On a (1, 1, 1) mesh a shard is the whole tensor: placed by any
    sharding, the DTensor's local tensor is the tensor itself."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        env = S.make_env(LM.make_device_mesh((1, 1, 1), ("pod", "data", "model"), "cpu"))
        t = torch.randn(8, 6)
        for spec in (("p_vocab", "p_embed"), ("act_batch", None), (None, None)):
            d = S.distribute(t, env.sharding(*spec, shape=tuple(t.shape)))
            assert d.to_local().data_ptr() == t.data_ptr() and torch.equal(d.full_tensor(), t)
    finally:
        dist.destroy_process_group()
