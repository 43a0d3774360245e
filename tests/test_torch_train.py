"""The port's training pieces against the reference: the optimizers and the
lr schedule on random trees, ``attention_chunked`` against the reference's
``attention_core``, the chunked loss, ``SyntheticLM``'s batches, the
configs, and five ``make_train_step`` steps against the reference's jitted
step; and ``tests/test_train.py``'s cases mirrored.

Tolerances (f32 on both sides, the same arithmetic in another order):
optimizer updates and states rel 1e-6 (atol 1e-12 for values near zero);
attention 2e-6; a loss rel 1e-5; after five train steps the loss, grad
norm and lr rel 1e-5 and each parameter within 1e-5 absolute (weights of
~0.1, steps of up to the lr 3e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs import shapes as ref_shapes
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.models import attention as RA
from repro.models import model as RM
from repro.train import data as RD
from repro.train import optim as RO
from repro.train import train_step as RTS
from repro_torch import configs as C
from repro_torch.configs import shapes
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import data as D
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS
from repro_torch.train.tree import flatten_with_paths, tree_leaves, tree_map

SHAPE = ShapeConfig(name="t", seq_len=64, global_batch=4, mode="train")


# ----------------------------------------------------------------- configs
def test_run_and_shape_config_equal_the_reference_field_by_field():
    for mine, ref in ((RunConfig, RefRunConfig), (ShapeConfig, RefShapeConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(mine)]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
    assert {k: dataclasses.asdict(s) for k, s in shapes.ALL_SHAPES.items()} == {
        k: dataclasses.asdict(s) for k, s in ref_shapes.ALL_SHAPES.items()}
    for name in C.ARCH_NAMES:
        assert ([s.name for s in shapes.shapes_for(C.get_config(name))]
                == [s.name for s in ref_shapes.shapes_for(ref_get_config(name))])
    with pytest.raises(ValueError):
        ShapeConfig(name="x", seq_len=1, global_batch=1, mode="serve")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", C.ARCH_NAMES)
def test_fingerprint_equals_the_reference(name, reduced):
    mine = (C.reduced_config if reduced else C.get_config)(name)
    ref = (ref_reduced_config if reduced else ref_get_config)(name)
    assert mine.fingerprint() == ref.fingerprint()
    assert len(mine.fingerprint()) == 12


# -------------------------------------------------------------- optimizers
def _random_tree(seed):
    """Leaves of the shapes the optimizers meet: matrices, a stacked (L, R,
    C) leaf, vectors and (1, n) / (n, 1) leaves that Adafactor does not
    factor."""
    rng = np.random.default_rng(seed)
    shapes_ = {"w": (16, 24), "stack": (3, 8, 5), "vec": (32,), "row": (1, 7), "col": (6, 1),
               "nested": [{"a": (4, 4)}, {"b": (9,)}]}

    def draw(shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return draw(t)
    return build(shapes_)


def _close(mine, ref, rtol=1e-6, atol=1e-12):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 500, 99_999, 200_000])
def test_lr_schedule(step):
    for warmup in (0, 10):
        _close(O.lr_schedule(torch.tensor(step, dtype=torch.int32), base_lr=3e-4, warmup=warmup),
               RO.lr_schedule(step, base_lr=3e-4, warmup=warmup))


def test_global_norm_and_clip():
    tree = _random_tree(0)
    mine = tree_map(torch.from_numpy, tree)
    _close(O.global_norm(mine), RO.global_norm(tree))
    for max_norm in (0.5, 100.0):
        clipped, norm = O.clip_by_global_norm(mine, max_norm)
        ref_clipped, ref_norm = RO.clip_by_global_norm(tree, max_norm)
        _close(norm, ref_norm)
        for a, b in zip(tree_leaves(clipped), _ref_leaves_in_port_order(ref_clipped, clipped)):
            _close(a, b)


def _ref_leaves_in_port_order(ref_tree, port_tree):
    """The reference tree's leaves read in the port tree's order (JAX sorts
    dict keys; the port keeps insertion order)."""
    flat = flatten_with_paths(jax.tree.map(np.asarray, ref_tree))
    return [flat[k] for k in flatten_with_paths(port_tree)]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_the_reference(name):
    """Three updates from the same params and gradients: the updates and
    every state leaf (AdamW's m and v; Adafactor's factored r and c, and v
    for the leaves it does not factor) equal the reference's."""
    params, init_update = _random_tree(1), O.make_optimizer(name)
    ref_init, ref_update = RO.make_optimizer(name)
    mine_p = tree_map(torch.from_numpy, params)
    state, ref_state = init_update[0](mine_p), ref_init(params)
    for i in range(3):
        grads = _random_tree(10 + i)
        ups = init_update[1](tree_map(torch.from_numpy, grads), state, mine_p,
                             lr=torch.tensor(1e-2), weight_decay=0.1)
        ref_ups, ref_state = ref_update(grads, ref_state, params, lr=1e-2, weight_decay=0.1)
        for a, b in zip(tree_leaves(ups), _ref_leaves_in_port_order(ref_ups, ups)):
            _close(a, b)
        for key in [k for k in state if k != "count"]:
            mine_flat = flatten_with_paths(state[key])
            ref_flat = flatten_with_paths(jax.tree.map(np.asarray, ref_state[key]))
            assert mine_flat.keys() == ref_flat.keys()
            for k, v in mine_flat.items():
                _close(v, ref_flat[k])
        assert int(state["count"]) == int(ref_state["count"]) == i + 1


def test_adafactor_factored_state_small():
    params = {"big": torch.zeros(64, 128), "vec": torch.zeros(32)}
    st = O.adafactor_init(params)
    assert sum(t.numel() for t in tree_leaves(st["v"])) == 64 + 128 + 32
    upd = O.adafactor_update(tree_map(torch.ones_like, params), st, params, lr=0.01)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(upd))


def test_adamw_decreases_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    state = O.adamw_init(w)
    for _ in range(200):
        upd = O.adamw_update(tree_map(lambda x: 2 * x, w), state, w, lr=0.05, weight_decay=0.0)
        w = tree_map(lambda p, u: p + u, w, upd)
    assert w["w"].abs().max().item() < 0.1


def test_clip_by_global_norm():
    clipped, norm = O.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert norm.item() == pytest.approx(20.0)
    assert O.global_norm(clipped).item() == pytest.approx(1.0, rel=1e-5)


def test_update_is_rounded_to_the_parameter_dtype():
    p = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    for name in ("adamw", "adafactor"):
        init, update = O.make_optimizer(name)
        upd = update(tree_map(torch.ones_like, p), init(p), p, lr=torch.tensor(1e-3))
        assert upd["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        O.make_optimizer("sgd")


# --------------------------------------------------------------- attention
CASES = [("causal", 0, 50.0, 0, 16), ("local", 0, 50.0, 0, 16), ("full", 0, 0.0, 0, 24),
         ("prefix", 0, 0.0, 10, 16), ("prefix", 0, 30.0, 40, 12), ("causal", 0, 0.0, 0, 0),
         ("local", 8, 50.0, 0, 48)]


@pytest.mark.parametrize("mask,q_offset,cap,prefix,chunk", CASES)
def test_attention_chunked_matches_attention_core(env, mask, q_offset, cap, prefix, chunk):
    """Every mask kind, with and without a softcap, at several KV chunks a
    call (chunk 16 of 48 keys: 3; chunk 0: the reference's automatic one),
    GQA with 2 queries a kv head, a local window of 20 and a query offset."""
    cfg = dataclasses.replace(C.reduced_config("gemma2-2b"), local_window=20,
                              attn_logit_softcap=cap)
    ref_cfg = dataclasses.replace(ref_reduced_config("gemma2-2b"), local_window=20,
                                  attn_logit_softcap=cap)
    rng = np.random.default_rng(3)
    sq, skv = 48 - q_offset, 48
    q = rng.standard_normal((2, sq, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 32)).astype(np.float32) for _ in range(2))
    ref = RA.attention_core(env, ref_cfg, q, k, v, mask_kind=mask, q_offset=q_offset,
                            prefix_len=prefix or None, chunk=chunk)
    mine = A.attention_chunked(cfg, *map(torch.from_numpy, (q, k, v)), mask_kind=mask,
                               q_offset=q_offset, prefix_len=prefix or None, chunk=chunk)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=2e-6)


def test_attention_chunked_bf16_rounds_p_as_the_reference(env):
    cfg, ref_cfg = C.reduced_config("gemma2-2b"), ref_reduced_config("gemma2-2b")
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 40, n, 32)).astype(np.float32) for n in (4, 2, 2))
    ref = RA.attention_core(env, ref_cfg, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                            mask_kind="causal", chunk=8)
    mine = A.attention_chunked(cfg, *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                               mask_kind="causal", chunk=8)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32), atol=2 ** -7)


def test_pick_chunk():
    assert [A.pick_chunk(s, w) for s, w in ((48, 16), (48, 0), (4096, 0), (100, 64), (7, 3))] \
        == [16, 48, 1024, 50, 1]


# -------------------------------------------------------------------- loss
def _gemma_case(s=64, seed=0):
    cfg, ref_cfg = C.reduced_config("gemma2-2b"), ref_reduced_config("gemma2-2b")
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(0), RefRunConfig(param_dtype="float32"))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return cfg, ref_cfg, ref, params_from_jax(jax.tree.map(np.asarray, ref), cfg), batch


@pytest.mark.parametrize("loss_chunk", [0, 16, 64, 24])
def test_loss_chunking_equivalent(env, loss_chunk):
    """Chunked CE (16: four chunks; 64 = S and 24, which does not divide S:
    unchunked, as the reference) gives the reference's loss, and its
    gradients equal the unchunked ones."""
    cfg, ref_cfg, ref, port, batch = _gemma_case()
    run = RunConfig(remat_policy="none", loss_chunk=loss_chunk, param_dtype="float32")
    ref_loss = jax.jit(lambda p, b: RM.loss_fn(
        env, ref_cfg, p, b, RefRunConfig(remat_policy="none", param_dtype="float32")))(
            ref, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = TS.loss_and_grads(cfg, run, port, tb)
    assert loss.item() == pytest.approx(float(ref_loss), rel=1e-5)
    _, grads0 = TS.loss_and_grads(cfg, dataclasses.replace(run, loss_chunk=0), port, tb)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item() + 1e-9)


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_remat_policies_same_loss(policy):
    """The reference's test: finite loss and gradients under each policy."""
    cfg, _, _, port, batch = _gemma_case(s=32)
    loss, grads = TS.loss_and_grads(cfg, RunConfig(remat_policy=policy, param_dtype="float32"),
                                     port, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_unknown_remat_policy_raises():
    cfg, _, _, port, batch = _gemma_case(s=8)
    with pytest.raises(ValueError, match="remat_policy"):
        M.loss_fn(cfg, port, {k: torch.from_numpy(v) for k, v in batch.items()},
                  RunConfig(remat_policy="some"))


def test_dots_policy_saves_the_weight_products_only():
    """"dots" keeps the 2-D products against weights (aten.mm) and
    recomputes the rest, attention's batched products among them."""
    ops = torch.ops.aten
    save = M._save_weight_products(None, ops.mm.default)
    assert save == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    for op in (ops.bmm.default, ops.exp.default, ops.add.Tensor):
        assert M._save_weight_products(None, op) == \
            torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["gemma2-2b", "seamless-m4t-medium", "paligemma-3b"])
def test_synthetic_lm_equals_the_reference(name):
    """Three batches, exactly: tokens and targets (int32), and the
    frontends' embeddings rounded to bf16."""
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    shape = ShapeConfig(name="t", seq_len=40, global_batch=3, mode="train")
    ref_shape = RefShapeConfig(name="t", seq_len=40, global_batch=3, mode="train")
    mine = D.SyntheticLM(cfg, D.DataConfig(seed=3)).batches(shape, "cpu")
    ref = RD.SyntheticLM(ref_cfg, RD.DataConfig(seed=3)).batches(ref_shape)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            want = to_torch(np.asarray(b[k]))
            assert a[k].dtype == want.dtype, k
            assert torch.equal(a[k], want), k


# -------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def ref_steps(env):
    """For each (optimizer, grad_accum): the reference's five jitted steps
    from its initial state on its SyntheticLM batches, as numpy."""
    out = {}
    for opt in ("adamw", "adafactor"):
        for accum in (1, 2):
            ref_cfg = dataclasses.replace(ref_reduced_config("gemma2-2b"), optimizer=opt)
            run = RefRunConfig(remat_policy="none", grad_accum=accum, param_dtype="float32",
                               learning_rate=3e-3, warmup_steps=2)
            state = RTS.init_train_state(ref_cfg, run, jax.random.PRNGKey(0))
            init = jax.tree.map(np.asarray, state["params"])
            step = jax.jit(RTS.make_train_step(ref_cfg, run, env))
            data = RD.SyntheticLM(ref_cfg).batches(RefShapeConfig("t", 32, 4, "train"))
            metrics = []
            for _ in range(5):
                state, m = step(state, next(data))
                metrics.append({k: float(v) for k, v in m.items()})
            out[opt, accum] = (init, metrics, jax.tree.map(np.asarray, state["params"]))
    return out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_five_train_steps_match_the_reference(ref_steps, opt, accum):
    init, ref_metrics, ref_params = ref_steps[opt, accum]
    cfg = dataclasses.replace(C.reduced_config("gemma2-2b"), optimizer=opt)
    run = RunConfig(remat_policy="none", grad_accum=accum, param_dtype="float32",
                    learning_rate=3e-3, warmup_steps=2)
    params = params_from_jax(init, cfg)
    state = {"params": params,
             "opt": O.make_optimizer(opt)[0](params, TS.optimizer_groups(cfg, params)),
             "step": torch.zeros((), dtype=torch.int32)}
    step = TS.make_train_step(cfg, run)
    data = D.SyntheticLM(cfg).batches(ShapeConfig("t", 32, 4, "train"), "cpu")
    for ref_m in ref_metrics:
        state, m = step(state, next(data))
        for k, v in ref_m.items():
            assert m[k].item() == pytest.approx(v, rel=1e-5, abs=1e-9), k
    assert int(state["step"]) == 5
    assert state["params"] is params                 # updated in place
    want = flatten_with_paths(params_from_jax(ref_params, cfg))
    for key, got in flatten_with_paths(state["params"]).items():
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_grad_accum_matches_full_batch():
    cfg = C.reduced_config("qwen3-4b")
    gen = torch.Generator().manual_seed(0)
    run1 = RunConfig(remat_policy="none", grad_accum=1, param_dtype="float32")
    s1 = TS.init_train_state(cfg, run1, gen, "cpu")
    s2 = tree_map(torch.clone, s1)
    batch = next(D.SyntheticLM(cfg).batches(SHAPE, "cpu"))
    _, m1 = TS.make_train_step(cfg, run1)(s1, batch)
    _, m2 = TS.make_train_step(cfg, dataclasses.replace(run1, grad_accum=2))(s2, batch)
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-4)
    assert max((a - b).abs().max().item() for a, b in
               zip(tree_leaves(s1["params"]), tree_leaves(s2["params"]))) < 5e-5


def test_bf16_train_step_keeps_dtypes_and_learns():
    """In bf16 the parameters stay bf16 (norm scales f32), the optimizer
    state f32, and a repeated batch's loss falls."""
    cfg = C.reduced_config("gemma2-2b")
    run = RunConfig(remat_policy="full", loss_chunk=16, learning_rate=1e-2, warmup_steps=1)
    state = TS.init_train_state(cfg, run, torch.Generator().manual_seed(0), "cpu")
    batch = next(D.SyntheticLM(cfg).batches(SHAPE, "cpu"))
    step = TS.make_train_step(cfg, run)
    losses = [step(state, batch)[1]["loss"].item() for _ in range(6)]
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    assert state["params"]["final_norm"]["scale"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tree_leaves(state["opt"]["m"]))
    assert losses[-1] < losses[0]


def test_int8_gradient_compression_raises():
    """int8 compression is ported (``tests/test_torch_parallel.py`` holds
    it on a mesh): only an unknown compression raises."""
    cfg = C.reduced_config("gemma2-2b")
    TS.make_train_step(cfg, RunConfig(gradient_compression="int8"))
    with pytest.raises(ValueError, match="gradient_compression"):
        TS.make_train_step(cfg, RunConfig(gradient_compression="fp8"))


def test_train_state_struct_is_shapes_only():
    cfg, run = C.reduced_config("arctic-480b"), RunConfig()
    struct = TS.train_state_struct(cfg, run)
    real = TS.init_train_state(cfg, run, torch.Generator().manual_seed(0), "cpu")
    assert all(t.device.type == "meta" for t in tree_leaves(struct))
    assert (tree_map(lambda t: (tuple(t.shape), t.dtype), struct)
            == tree_map(lambda t: (tuple(t.shape), t.dtype), real))
    # arctic trains with Adafactor, its state in the reference's stacked layout
    assert struct["opt"]["v"]["stack/b0/moe/w_in"]["r"].shape == (2, 8, 128)


def test_serve_steps_are_prefill_and_decode_step():
    cfg, _, _, port, batch = _gemma_case(s=8)
    prefill_fn, decode_fn = TS.make_serve_steps(cfg, RunConfig())
    with torch.no_grad():
        logits, cache, pos = prefill_fn(port, {"tokens": torch.from_numpy(batch["tokens"])},
                                        max_len=9)
        want, _, _ = M.prefill(cfg, port, {"tokens": torch.from_numpy(batch["tokens"])})
        step_logits, cache = decode_fn(port, logits.argmax(-1)[:, None], pos + 1, cache)
    assert torch.equal(logits, want)
    assert step_logits.shape == (4, cfg.vocab_size)


def test_bmm_f32_backward_is_the_widened_products():
    """The MoE's bf16 expert products (f32 out): their gradients are those
    of the products of the operands widened to f32, each rounded to its
    operand's dtype (torch's ``bmm(out_dtype=)`` has no derivative)."""
    from repro_torch.models.moe import bmm_f32
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 4, generator=gen).to(torch.bfloat16).requires_grad_()
    b = torch.randn(3, 4, 6, generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn(3, 5, 6, generator=gen)
    out = bmm_f32(a, b)
    assert out.dtype == torch.float32
    (out * w).sum().backward()
    a2, b2 = (t.detach().clone().requires_grad_() for t in (a, b))
    (torch.bmm(a2.float(), b2.float()) * w).sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, a2.grad) and torch.equal(b.grad, b2.grad)


@pytest.mark.parametrize("name", ["gemma2-2b", "recurrentgemma-9b", "seamless-m4t-medium",
                                  "mamba2-2.7b"])
def test_optimizer_groups_are_the_references_stacked_leaves(name):
    """Every port leaf maps to a leaf of the reference's tree, the leaves
    that map to one leaf are the layers the reference stacks there, and
    together they have its shape."""
    from repro_torch.convert import reference_leaf
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    ref = flatten_with_paths(jax.tree.map(
        np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0),
                                   RefRunConfig(param_dtype="float32"))))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    port = flatten_with_paths(params)
    groups = TS.optimizer_groups(cfg, params)
    assert groups == [reference_leaf(cfg, p) for p in port]
    members: dict = {}
    for path, key in zip(port, groups):
        members.setdefault(key, []).append(port[path])
    assert members.keys() == ref.keys()
    for key, ts in members.items():
        stacked = (len(ts),) + tuple(ts[0].shape)
        assert ref[key].shape in (tuple(ts[0].shape), stacked), key
