"""The loss's whole-vocab f32 tensors (ROADMAP.md, fault F8, repaired).

``model._ce`` scores a chunk of f32 logits (B, S, V) through
``model._LseGold``, whose backward writes the gradient into one new tensor
and adds the targets' terms to it in place, so at no point of the loss's
forward and backward are more than two f32 tensors of the chunk's (B, S, V)
shape live: the logits it saved and that gradient (autograd of
``logsumexp`` and ``gather`` kept four on a mesh, and five on one device,
where ``torch.logsumexp`` made temporaries of its own). Counted here with
``op_analysis.MemoryTracker`` on reduced seamless-m4t-medium: the loss and
its backward on one device, and a ``make_train_step`` step as rank 0 of a
fake 8-rank
group on a (2, 4) mesh (meta tensors, as the dry run counts), with a vocab
that ``model`` (4) does not divide, so a rank holds the whole vocab of its
rows, and with one it divides.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import RunConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.op_analysis import MemoryTracker
from repro_torch.train.tree import tree_leaves

SHAPE = ShapeConfig(name="train_tiny", seq_len=64, global_batch=4, mode="train")


class VocabTracker(MemoryTracker):
    """``MemoryTracker`` that also counts the live f32 storages of ``rows``
    x ``vocab`` elements whose last dimension is ``vocab`` (the loss's
    logits and what is made like them, in whatever shape they are made),
    and their most at once."""

    def __init__(self, rows: int, vocab: int):
        super().__init__()
        self.rows, self.vocab, self.logits, self.most = rows, vocab, set(), 0

    def _add(self, t):
        key = t.untyped_storage()._cdata
        if key in self._held:
            return
        super()._add(t)
        if t.dtype == torch.float32 and t.shape[-1:] == (self.vocab,) \
                and t.numel() == self.rows * self.vocab:
            self.logits.add(key)
            self.most = max(self.most, len(self.logits))

    def _free(self, key):
        super()._free(key)
        self.logits.discard(key)


def _most_live(cfg, mesh_shape):
    """The most f32 (B, S, V-slice) tensors live at once in one train step
    of ``cfg`` at SHAPE, on one CPU device or as rank 0 of a fake group."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    run = RunConfig()
    rows = M.input_specs(cfg, SHAPE)["targets"].numel()    # the scored tokens
    if mesh_shape is None:
        gen = torch.Generator().manual_seed(0)
        params = M.init_params(cfg, gen, "cpu", torch.float32)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) if v.dtype != torch.float32 else
                 torch.randn(v.shape, generator=gen) for k, v in M.input_specs(cfg, SHAPE).items()}
        tracker = VocabTracker(rows, cfg.vocab_size)
        with tracker:
            M.loss_fn(cfg, params, batch, run).backward()
        return tracker.most
    model = mesh_shape[1]
    vocab = cfg.vocab_size // model if cfg.vocab_size % model == 0 else cfg.vocab_size
    with D.fake_group(mesh_shape[0] * model):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        step, _, args = D.lower_cell(cfg, SHAPE, mesh, run)
        tracker = VocabTracker(rows // mesh_shape[0], vocab)
        tracker.track(*[t for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        with tracker:
            step()
    return tracker.most


@pytest.mark.parametrize("vocab,mesh_shape", [(509, None), (509, (2, 4)), (2000, (2, 4))],
                         ids=["one device", "whole vocab a rank", "vocab split"])
def test_loss_keeps_two_vocab_tensors(vocab, mesh_shape):
    cfg = dataclasses.replace(reduced_config("seamless-m4t-medium"), vocab_size=vocab)
    assert _most_live(cfg, mesh_shape) == 2
