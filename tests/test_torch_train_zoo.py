"""The training loss and its gradients in the port against the reference,
for the reduced config of each of the ten archs at f32, remat "none": the
same parameters (the reference's ``init_params`` converted through numpy,
with seamless's and paligemma's biases and norm scales drawn at random so
a misplaced one shows) and the same batch (2 x 32 tokens; seamless's
decoder over a 20-frame source; paligemma's text after its 8 patch
embeddings; the last 5 targets of a row are padding, -1), the port's
``loss_fn`` and ``torch.autograd`` against ``jax.value_and_grad`` of the
reference's ``loss_fn``.

This covers every block's backward in plain torch: attention (chunked,
with the causal, local, full and prefix masks), the MoE's index writes
into fresh buffers, the SSD chunk loop, the RG-LRU's Hillis-Steele scan,
cross-attention and the parallel block.

Tolerances: both compute the same f32 arithmetic in another order; loss
within rel 1e-5; each gradient leaf within 1e-4 of that leaf's max |g|,
or within 1e-7 absolute where the leaf's gradient is zero in exact
arithmetic (a key bias: softmax is invariant to it) and both sides hold
rounding noise of ~1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.models import model as RM
from repro_torch import configs as C
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.tree import flatten_with_paths

REF_RUN = RefRunConfig(remat_policy="none", param_dtype="float32")
RUN = RunConfig(remat_policy="none", param_dtype="float32")
B, S, SRC = 2, 32, 20


def _random_biases_and_scales(tree, rng):
    def draw(path, x):
        if path[-1].key in ("bq", "bk", "bv", "bo", "scale"):
            return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, tree)


def arch_case(name):
    """(port cfg, ref cfg, numpy ref params, numpy batch)."""
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    np_ref = jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0), REF_RUN))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["targets"][1, -5:] = -1              # padding: weighs nothing
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        np_ref = _random_biases_and_scales(np_ref, rng)
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = rng.standard_normal((B, SRC, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, np_ref, batch


def ref_loss_and_grads(env, ref_cfg, np_ref, batch, cfg):
    """The reference's loss and its gradients, in the port's tree layout."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(env, ref_cfg, p, b, REF_RUN)))
    loss, grads = fn(jax.tree.map(jnp.asarray, np_ref),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads), cfg)


def assert_grads_close(grads, ref_grads):
    ref_flat = flatten_with_paths(ref_grads)
    flat = flatten_with_paths(grads)
    assert flat.keys() == ref_flat.keys()
    for key, ref in ref_flat.items():
        tol = max(1e-4 * ref.abs().max().item(), 1e-7)
        err = (flat[key] - ref).abs().max().item()
        assert err <= tol, f"{key}: max|err| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("name", C.ARCH_NAMES)
def test_loss_and_grads_match_the_reference(env, name):
    cfg, ref_cfg, np_ref, batch = arch_case(name)
    ref_loss, ref_grads = ref_loss_and_grads(env, ref_cfg, np_ref, batch, cfg)
    loss, grads = loss_and_grads(cfg, RUN, params_from_jax(np_ref, cfg),
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    assert_grads_close(grads, ref_grads)


@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("name", C.ARCH_NAMES)
def test_remat_keeps_loss_and_grads(name, policy):
    """Each remat policy recomputes what "none" keeps, over every block
    kind (the MoE's dispatch, the SSD and RG-LRU scans, the encoder and
    cross-attention): the same loss and gradients, within f32 rounding."""
    cfg, _, np_ref, batch = arch_case(name)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = params_from_jax(np_ref, cfg)
    loss, grads = loss_and_grads(cfg, RUN, params, batch)
    loss_r, grads_r = loss_and_grads(cfg, RunConfig(remat_policy=policy, param_dtype="float32"),
                                      params, batch)
    assert loss_r.item() == pytest.approx(loss.item(), rel=1e-6)
    assert_grads_close(grads_r, grads)
