"""The port's sharded training on 8 gloo ranks on the CPU: a (pod 2, data 2,
model 2) mesh, the reference's ``test_multidevice_train_step`` setting
(reduced gemma2, ``RunConfig(remat_policy="none", param_dtype="float32")``).

One spawn of 8 ranks (``torch.multiprocessing``, a ``file://`` rendezvous
under the test's tmp dir, a timeout) evaluates every case; rank 0 writes
the gathered results and the parent holds them against the port's
single-device step and the reference:

* gemma2 with no compression: the loss within 1e-5 relative, each gradient
  and each AdamW moment within 1e-5 of its leaf's max |·| of the port's
  single-device step, each parameter after the step within 1e-5 of its
  leaf's max where the gradient is resolved (at least 1e-6 and 1e-3 of its
  leaf's max |g|), elsewhere within the step's reach 2 lr (1 + wd |p|):
  where |g| is near Adam's eps, its f32 rounding moves the update by a
  share of the lr (the rule of ``chip_smoke.py`` phase 8a).
* gemma2 with ``"int8"``: the per-pod exchange against the port's one-device
  composition (``loss_and_grads`` on each half-batch, the stacked
  ``pod_mean_compressed`` with one scale a pod and reference leaf, whose
  layers it stacks) and against the reference's (its ``loss_fn``
  under ``local_env`` on each half-batch, its ``pod_mean_compressed``):
  the loss within 1e-5 relative; each mean gradient within one quantum
  (the larger pod scale / npod) plus 1e-5 of the leaf's max, since an f32
  gradient one ulp apart can move its int8 code by one (the share of
  elements a whole quantum apart is printed); each error-feedback element
  within the larger pod scale plus the same slack. After clip and AdamW the
  parameters hold within 1e-5 of their leaf's max where the mean gradients
  agree within 1e-5 of theirs and are resolved (as gemma2's), elsewhere
  within the step's reach 2 lr (1 + wd |p|) (Adam turns a quantum into up
  to a whole step).
* the MoE under ``local_map``: reduced granite-moe (TP: each expert's ff
  over ``model``) and arctic (EP: experts over ``model``, FSDP-gathered over
  ``data``), output and gradients within 1e-5 of their max |·| of the
  single-device ``moe_apply`` at capacity factor 8 (nothing dropped); at
  capacity factor 1 (the per-shard capacity binds) the output equals the
  single-device ``moe_apply`` run on each data shard's own tokens, within
  the same tolerance.
* arctic's whole step (Adafactor, its factored moments over sharded
  dimensions, the EP MoE) at 1 token a row, 8 in all: an expert's capacity
  (at least 8 slots) then holds every token on one device as on a shard, so
  neither drops (at 4 a row the single device drops and the shards do not): as gemma2's, with Adafactor's moments in
  place of AdamW's.
* a checkpoint saved on the (2, 2, 2) mesh restores whole on one rank and
  onto the mesh again, bit-equal; the ``Trainer`` on the mesh (async
  checkpoints, a restart restored onto the mesh) gives the single-device
  trainer's three losses within 1e-5 relative.
"""
import dataclasses
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.models import model as RM
from repro.parallel import compression as RC
from repro.parallel.sharding import local_env
from repro.train import optim as RO
from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.parallel import compression as C
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS
from repro_torch.train.data import SyntheticLM, as_tensors
from repro_torch.train.tree import flatten_with_paths, tree_map

WORLD, MESH, NAMES = 8, (2, 2, 2), ("pod", "data", "model")
LR, TIMEOUT_S = 3e-3, 420
GEMMA_SHAPE = ShapeConfig("t", 32, 8, "train")
ARCTIC_SHAPE = ShapeConfig("t", 1, 8, "train")
RTOL, LEAF_TOL = 1e-5, 1e-5
MOE_TOKENS = (8, 16)


def _run(comp=""):
    return RunConfig(remat_policy="none", param_dtype="float32", learning_rate=LR,
                     warmup_steps=1, gradient_compression=comp)


def _state(cfg, run, npod=1):
    """The port's seeded initial state at step 1 (the lr is 0 at step 0)."""
    state = TS.init_train_state(cfg, run, torch.Generator().manual_seed(0), "cpu", npod=npod)
    state["step"].fill_(1)
    return state


def _batch(cfg, shape):
    return as_tensors(next(SyntheticLM(cfg).numpy_batches(shape)), "cpu")


def _moe_case(name):
    cfg = reduced_config(name)
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(cfg, gen, "cpu", torch.float32)["layers"][0]["moe"]
    x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen)
    w = torch.randn(*MOE_TOKENS, cfg.d_model, generator=gen)
    return cfg, params, x, w


def _moe_grads(cfg, params, x, w, cf, env=None):
    leaves = {"x": x, **params}
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    out = MOE.moe_apply(cfg, {k: v for k, v in leaves.items() if k != "x"}, leaves["x"],
                        capacity_factor=cf, env=env)
    grads = torch.autograd.grad((out * w).sum(), list(leaves.values()))
    return out.detach(), dict(zip(leaves, grads))


# --------------------------------------------------------------- the ranks
def _collectives_class():
    from torch.distributed.tensor.debug import CommDebugMode

    class Collectives(CommDebugMode):
        """CommDebugMode that also logs each collective's elements by
        (kind, dtype, mesh dimension)."""

        def __init__(self, mesh):
            super().__init__()
            self.groups = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
            self.log = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(getattr(func, "_overloadpacket", None), "__name__", "")
            if out is not NotImplemented and name in (
                    "all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
                    "all_to_all_single", "broadcast"):
                t = args[0]
                key = (name, str(t.dtype).removeprefix("torch."),
                       self.groups.get(args[-1], str(args[-1])))
                self.log[key] = self.log.get(key, 0) + t.numel()
            return out

    return Collectives


def _Collectives(mesh):
    return _collectives_class()(mesh)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _ranks(rank, store, out_dir):
    """One rank: every case on the (2, 2, 2) mesh; rank 0 saves the
    gathered results."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.parallel.sharding import distribute_tree, make_env, tree_shardings
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    try:
        env = make_env(make_device_mesh(MESH, NAMES, "cpu"))
        res = {"seconds": {}}

        def place(cfg, run, state, batch):
            sh = tree_shardings(env, TS.state_logical_specs(cfg, run), state)
            bsh = tree_shardings(env, TS.batch_logical_specs(cfg, "train"), batch)
            return distribute_tree(state, sh), distribute_tree(batch, bsh), sh

        def full_tree(tree):
            return tree_map(lambda t: _full(t).detach().clone(), tree)

        # gemma2, "" and "int8"
        cfg = reduced_config("gemma2-2b")
        batch = _batch(cfg, GEMMA_SHAPE)
        for comp in ("", "int8"):
            t0 = time.perf_counter()
            run = _run(comp)
            state, dbatch, sh = place(cfg, run, _state(cfg, run, npod=2), batch)
            if comp:
                with _Collectives(env.mesh) as comms:
                    loss, grads, err = TS.pod_compressed_grads(cfg, run, env, state, dbatch)
                res[comp, "collectives"] = dict(comms.log)
                res[comp, "err_first"] = full_tree(err)
            else:
                loss, grads = TS.loss_and_grads(cfg, run, state["params"], dbatch, env)
            res[comp, "loss"], res[comp, "grads"] = _full(loss).item(), full_tree(grads)
            _, m = TS.make_train_step(cfg, run, env)(state, dbatch)
            res[comp, "metrics"] = {k: _full(v).item() for k, v in m.items()}
            res[comp, "state"] = full_tree(state)
            res["seconds"]["gemma2" + comp] = time.perf_counter() - t0
            if not comp:
                # save on the mesh -> restore whole on rank 0 -> restore onto the mesh
                ckpt_dir = os.path.join(out_dir, "ckpt")
                CK.save(state, ckpt_dir, 2, fingerprint=cfg.fingerprint())
                if rank == 0:
                    whole, _ = CK.restore(TS.train_state_struct(cfg, run, npod=2), ckpt_dir,
                                          device="cpu")
                    res["ckpt_whole"] = whole
                back, at = CK.restore(TS.train_state_struct(cfg, run, npod=2), ckpt_dir,
                                      device="cpu", shardings=sh)
                res["ckpt_back_equal"] = all(
                    torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                    for a, b in zip(flatten_with_paths(back).values(),
                                    flatten_with_paths(state).values()))
                # the Trainer on the mesh: 2 steps with async checkpoints, then a
                # restart that restores onto the mesh and takes the third
                tcfg = TrainerConfig(total_steps=2, checkpoint_every=1, log_every=1,
                                     checkpoint_dir=os.path.join(out_dir, "trainer"))
                first = Trainer(cfg, run, GEMMA_SHAPE, tcfg, device="cpu", env=env).run_loop()
                tcfg3 = dataclasses.replace(tcfg, total_steps=3)
                resumed = Trainer(cfg, run, GEMMA_SHAPE, tcfg3, device="cpu", env=env).run_loop()
                res["trainer_losses"] = first["losses"] + resumed["losses"]
        # the MoE alone, TP and EP
        for name in ("granite-moe-3b-a800m", "arctic-480b"):
            t0 = time.perf_counter()
            mcfg, params, x, w = _moe_case(name)
            specs = M.param_specs(mcfg)["layers"][0]["moe"]
            dparams = distribute_tree(params, tree_shardings(env, specs, params))
            act = env.sharding("act_batch", None, None, shape=tuple(x.shape))
            dx, dw = distribute_tree(x, act), distribute_tree(w, act)
            with implicit_replication():
                out, grads = _moe_grads(mcfg, dparams, dx, dw, 8.0, env)
                res[name, "out8"], res[name, "grads8"] = _full(out), full_tree(grads)
                res[name, "out1"] = _full(MOE.moe_apply(mcfg, dparams, dx, capacity_factor=1.0,
                                                        env=env))
            res["seconds"][name + " moe"] = time.perf_counter() - t0
        # arctic's whole step: Adafactor and the EP MoE
        t0 = time.perf_counter()
        acfg, run = reduced_config("arctic-480b"), _run()
        state, dbatch, _ = place(acfg, run, _state(acfg, run), _batch(acfg, ARCTIC_SHAPE))
        _, m = TS.make_train_step(acfg, run, env)(state, dbatch)
        res["arctic", "metrics"] = {k: _full(v).item() for k, v in m.items()}
        res["arctic", "state"] = full_tree(state)
        res["seconds"]["arctic step"] = time.perf_counter() - t0
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    ctx = torch.multiprocessing.start_processes(
        _ranks, args=(str(out / "store"), str(out)), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks took over {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
    res = torch.load(out / "results.pt", weights_only=False)
    print("seconds by case:", res["seconds"])
    return res


# ------------------------------------------------------------- the holds
def _leafwise(mine, ref, tol=LEAF_TOL, what=""):
    m, r = flatten_with_paths(mine), flatten_with_paths(ref)
    assert m.keys() == r.keys()
    for key, t in m.items():
        want = r[key].float()
        err = (t.float() - want).abs().max().item()
        assert err <= tol * max(want.abs().max().item(), 1e-30), f"{what} {key}: {err}"


def test_sharded_step_equals_the_single_device_step(ranks):
    cfg, run = reduced_config("gemma2-2b"), _run()
    state, batch = _state(cfg, run), _batch(cfg, GEMMA_SHAPE)
    before = tree_map(torch.clone, state["params"])
    loss, grads = TS.loss_and_grads(cfg, run, state["params"], batch)
    assert ranks["", "loss"] == pytest.approx(loss.item(), rel=RTOL)
    _leafwise(ranks["", "grads"], grads, what="gradient")
    _, m = TS.make_train_step(cfg, run)(state, batch)
    for k, v in m.items():
        assert ranks["", "metrics"][k] == pytest.approx(v.item(), rel=RTOL), k
    _hold_params(ranks["", "state"]["params"], state["params"], before, grads, run)
    _leafwise(ranks["", "state"]["opt"]["m"], state["opt"]["m"], what="AdamW m")


def _hold_params(mine, ref, before, grads, run):
    """Parameters after a step: within LEAF_TOL of the leaf's max where the
    gradient is resolved, else within the step's reach."""
    m, r, b, g = (flatten_with_paths(t) for t in (mine, ref, before, grads))
    for key, p in r.items():
        grad = g[key].abs()
        resolved = grad >= max(1e-6, 1e-3 * grad.max().item())
        reach = 2 * LR * (1 + run.weight_decay * b[key].abs())
        tol = torch.where(resolved, LEAF_TOL * p.abs().max(), reach)
        assert ((m[key] - p).abs() <= tol).all(), key


def _one_device_int8(cfg, run, params, batch):
    """The port's composition on one device: each pod's loss and gradients
    on its half of the batch, the stacked int8 exchange from zero error,
    clip, AdamW, the update."""
    halves = [{k: x[i * 4:(i + 1) * 4] for k, x in batch.items()} for i in range(2)]
    per_pod = [TS.loss_and_grads(cfg, run, params, h) for h in halves]
    stacked = tree_map(lambda *g: torch.stack(g), *[g for _, g in per_pod])
    mean, err = C.pod_mean_compressed(stacked, C.init_error_feedback(params, 2),
                                      TS.optimizer_groups(cfg, params))
    loss = (per_pod[0][0] + per_pod[1][0]) / 2
    return loss, stacked, mean, err


def _ref_one_device_int8(cfg, params, batch):
    """The reference's composition: its ``loss_fn`` under ``local_env`` on
    each half-batch, its ``pod_mean_compressed``, ``clip_by_global_norm``
    and AdamW at step 1; returns (loss, stacked gradients, mean, err,
    parameters after)."""
    env = local_env()
    run = RefRunConfig(remat_policy="none", param_dtype="float32")
    ref_params = jax.tree.map(jnp.asarray, params)
    halves = [{k: jnp.asarray(np.asarray(x[i * 4:(i + 1) * 4])) for k, x in batch.items()}
              for i in range(2)]
    outs = [jax.value_and_grad(lambda p, b: RM.loss_fn(env, cfg, p, b, run))(ref_params, h)
            for h in halves]
    stacked = jax.tree.map(lambda *g: jnp.stack(g), *[g for _, g in outs])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), NAMES)
    err0 = RC.init_error_feedback(ref_params, 2)
    mean, err = RC.pod_mean_compressed(stacked, err0, mesh)
    clipped, _ = RO.clip_by_global_norm(mean, 1.0)
    updates, _ = RO.adamw_update(clipped, RO.adamw_init(ref_params), ref_params,
                                 lr=RO.lr_schedule(1, base_lr=LR, warmup=1))
    after = jax.tree.map(lambda p, u: p + u, ref_params, updates)
    return float(outs[0][0] + outs[1][0]) / 2, stacked, mean, err, after


def _hold_quantum(mine, ref, stacked, what, per="mean"):
    """Element-wise within one quantum (the larger pod scale of the leaf's
    reference leaf, over npod for the mean) plus LEAF_TOL of the leaf's
    max; returns the share of elements a whole quantum apart."""
    from repro_torch.convert import reference_leaf
    cfg = reduced_config("gemma2-2b")
    m, r, g = flatten_with_paths(mine), flatten_with_paths(ref), flatten_with_paths(stacked)
    scales: dict = {}
    for key, t in g.items():
        group = reference_leaf(cfg, key)
        scales[group] = max(scales.get(group, 0.0), t.float().abs().max().item() / 127.0)
    apart = total = 0
    for key, t in m.items():
        scale = scales[reference_leaf(cfg, key)]
        quantum = scale / 2 if per == "mean" else scale
        want = r[key].float()
        diff = (t.float() - want).abs()
        slack = LEAF_TOL * max(want.abs().max().item(), 1e-30)
        assert diff.max().item() <= quantum + slack, f"{what} {key}: {diff.max().item()} > {quantum}"
        apart += int((diff > quantum / 2 + slack).sum())
        total += diff.numel()
    return apart / total


def _hold_int8_params(mine, ref, g_mine, g_ref, before, run):
    """Parameters after clip and AdamW: within LEAF_TOL of the leaf's max
    where both sides' mean gradients agree within LEAF_TOL of theirs and
    are resolved, elsewhere within the step's reach 2 lr (1 + wd |p|)."""
    m, r, gm, gr, b = (flatten_with_paths(t) for t in (mine, ref, g_mine, g_ref, before))
    for key, p in r.items():
        g = gr[key].abs()
        agree = ((gm[key] - gr[key]).abs() <= LEAF_TOL * g.max()) & (
            g >= max(1e-6, 1e-3 * g.max().item()))
        reach = 2 * LR * (1 + run.weight_decay * b[key].abs())
        tol = torch.where(agree, LEAF_TOL * p.abs().max(), reach)
        assert ((m[key] - p).abs() <= tol).all(), key


def test_int8_step_equals_the_one_device_compositions(ranks):
    cfg, run = reduced_config("gemma2-2b"), _run("int8")
    state, batch = _state(cfg, run, npod=2), _batch(cfg, GEMMA_SHAPE)
    params = tree_map(torch.clone, state["params"])
    loss, stacked, mean, err = _one_device_int8(cfg, run, params, batch)
    assert ranks["int8", "loss"] == pytest.approx(loss.item(), rel=RTOL)
    assert ranks["int8", "metrics"]["loss"] == pytest.approx(loss.item(), rel=RTOL)
    shares = {"mesh_vs_port_mean": _hold_quantum(ranks["int8", "grads"], mean, stacked, "mean"),
              "mesh_vs_port_err": _hold_quantum(ranks["int8", "err_first"], err, stacked, "err",
                                                per="pod")}
    # clip, AdamW and the update from the one-device mean
    clipped, gnorm = O.clip_by_global_norm(mean, run.max_grad_norm)
    # |norm(a) - norm(b)| <= norm(a - b), each element within its quantum
    scale = max(g.abs().max().item() for g in flatten_with_paths(stacked).values()) / 127.0
    reach = sum(m.numel() * (scale / 2 + LEAF_TOL * m.abs().max().item()) ** 2
                for m in flatten_with_paths(mean).values()) ** 0.5
    assert abs(ranks["int8", "metrics"]["grad_norm"] - gnorm.item()) <= reach
    lr = O.lr_schedule(state["step"], base_lr=LR, warmup=1)
    opt = O.adamw_init(params)
    updates = O.adamw_update(clipped, opt, params, lr=lr)
    O.apply_updates(params, updates)
    mesh_after = ranks["int8", "state"]["params"]
    _hold_int8_params(mesh_after, params, ranks["int8", "grads"], mean, state["params"], run)
    # and the reference's composition on one device
    ref_cfg = ref_reduced_config("gemma2-2b")
    np_params = {k: v.numpy() for k, v in flatten_with_paths(state["params"]).items()}
    ref_loss, ref_stacked, ref_mean, ref_err, ref_after = _ref_one_device_int8(
        ref_cfg, _ref_tree(cfg, np_params, ref_cfg), batch)
    assert loss.item() == pytest.approx(ref_loss, rel=RTOL)
    ref_mean_port = _port_tree(cfg, ref_mean)
    _hold_int8_params(mesh_after, _port_tree(cfg, ref_after), ranks["int8", "grads"],
                      ref_mean_port, state["params"], run)
    ref_stacked_port = _port_tree(cfg, ref_stacked, lead=1)
    shares["port_vs_ref_mean"] = _hold_quantum(mean, ref_mean_port, ref_stacked_port, "mean")
    shares["mesh_vs_ref_mean"] = _hold_quantum(ranks["int8", "grads"], ref_mean_port,
                                               ref_stacked_port, "mean")
    shares["port_vs_ref_err"] = _hold_quantum(err, _port_tree(cfg, ref_err, lead=1),
                                              ref_stacked_port, "err", per="pod")
    print("share of elements a whole quantum apart:", shares)


def test_int8_exchange_moves_int8_over_pod(ranks):
    """The exchange's collectives over ``pod`` (elements on rank 0, by kind
    and dtype): the gradients' int8 codes all-gathered, and in f32 only
    each pod's scale a reference leaf and its loss."""
    log = ranks["int8", "collectives"]
    print("collectives of the int8 exchange:", log)
    over_pod = {k: n for k, n in log.items() if k[2] == "pod"}
    cfg = reduced_config("gemma2-2b")
    params = M.param_shapes(cfg, _run("int8"))
    groups = set(TS.optimizer_groups(cfg, params))
    local = sum(t.numel() for t in flatten_with_paths(params).values()) // 4   # data x model
    assert over_pod.get(("all_gather_into_tensor", "int8", "pod"), 0) >= local
    f32 = sum(n for (kind, dtype, _), n in over_pod.items() if dtype == "float32")
    assert f32 <= len(groups) + 1


def _ref_tree(cfg, flat_port, ref_cfg):
    """The port's parameters (flat numpy) as the reference's stacked tree."""
    template = jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0),
                                                       RefRunConfig(param_dtype="float32")))
    from repro_torch.convert import reference_leaf
    groups: dict = {}
    for path, arr in flat_port.items():
        groups.setdefault(reference_leaf(cfg, path), []).append(arr)

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, f"{prefix}/{i}") for i, v in enumerate(tree))
        arrs = groups[prefix]
        return np.stack(arrs) if arrs[0].shape != tree.shape else arrs[0]

    return fill(template)


def _port_tree(cfg, ref_tree, lead=0):
    """A reference tree (stacked layers after ``lead`` leading dims) as the
    port's per-layer tree of torch tensors."""
    np_tree = jax.tree.map(np.asarray, ref_tree)
    if lead:
        return tree_map(lambda *xs: torch.stack(xs),
                        *[params_from_jax(jax.tree.map(lambda a: a[i], np_tree), cfg)
                          for i in range(np.asarray(jax.tree.leaves(np_tree)[0]).shape[0])])
    return params_from_jax(np_tree, cfg)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_under_local_map_equals_moe_apply(ranks, name):
    cfg, params, x, w = _moe_case(name)
    out, grads = _moe_grads(cfg, params, x, w, 8.0)
    tol = LEAF_TOL * out.abs().max().item()
    assert (ranks[name, "out8"] - out).abs().max().item() <= tol
    _leafwise(ranks[name, "grads8"], grads, what="MoE gradient")
    # capacity 1: each data shard drops from its own tokens
    shards = [MOE.moe_apply(cfg, params, xs, capacity_factor=1.0) for xs in x.chunk(4)]
    per_shard = torch.cat(shards)
    assert not torch.allclose(per_shard, MOE.moe_apply(cfg, params, x, capacity_factor=1.0))
    assert (ranks[name, "out1"] - per_shard).abs().max().item() <= tol


def test_arctic_step_equals_the_single_device_step(ranks):
    cfg, run = reduced_config("arctic-480b"), _run()
    state, batch = _state(cfg, run), _batch(cfg, ARCTIC_SHAPE)
    before = tree_map(torch.clone, state["params"])
    grads = TS.loss_and_grads(cfg, run, state["params"], batch)[1]
    _, m = TS.make_train_step(cfg, run)(state, batch)
    for k, v in m.items():
        assert ranks["arctic", "metrics"][k] == pytest.approx(v.item(), rel=RTOL), k
    _hold_params(ranks["arctic", "state"]["params"], state["params"], before, grads, run)
    _leafwise(ranks["arctic", "state"]["opt"]["v"], state["opt"]["v"], what="Adafactor")


def test_trainer_on_the_mesh_equals_the_single_device_trainer(ranks, tmp_path):
    """``Trainer(env=...)``: the state placed by the specs, batches as
    ("act_batch", ...) DTensors, async checkpoints gathered to rank 0 and a
    restart restored onto the mesh: its three losses are the single-device
    trainer's."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg, run = reduced_config("gemma2-2b"), _run()
    tcfg = TrainerConfig(total_steps=2, checkpoint_every=1, log_every=1,
                         checkpoint_dir=str(tmp_path))
    want = Trainer(cfg, run, GEMMA_SHAPE, tcfg, device="cpu").run_loop()["losses"]
    tcfg3 = dataclasses.replace(tcfg, total_steps=3)
    want += Trainer(cfg, run, GEMMA_SHAPE, tcfg3, device="cpu").run_loop()["losses"]
    assert ranks["trainer_losses"] == pytest.approx(want, rel=RTOL)


def test_checkpoint_on_the_mesh_restores_whole_and_back(ranks):
    whole = ranks["ckpt_whole"]
    for key, t in flatten_with_paths(ranks["", "state"]).items():
        assert torch.equal(flatten_with_paths(whole)[key], t), key
    assert ranks["ckpt_back_equal"]
