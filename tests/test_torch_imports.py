"""Rules of the port: it imports neither JAX nor the reference package, its
configurations equal the reference's field by field, and it runs on the card
unless told otherwise."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro_torch import configs as C
from repro_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_import_check_sees_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax\nfrom repro.models import model\nimport repro_torch\n"
                     "importlib.import_module('repro.configs')\n")
    found = [m for m in _imported_modules(probe) if m.split(".")[0] in FORBIDDEN]
    assert found == ["jax", "repro.models", "repro.configs"]


@pytest.mark.parametrize("ops", sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/ops.py")),
                         ids=lambda p: p.parent.name)
def test_kernel_dispatch_has_no_fallback(ops):
    """No try/except in a kernel's dispatch: a CUDA tensor goes to the
    kernel or the call raises."""
    tree = ast.parse(ops.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("reduced", [False, True])
def test_gemma2_config_equals_the_reference(reduced):
    get = C.reduced_config if reduced else C.get_config
    ref_get = ref_reduced_config if reduced else ref_get_config
    assert dataclasses.asdict(get("gemma2-2b")) == dataclasses.asdict(ref_get("gemma2-2b"))


ZOO = [n for n in C.ARCH_NAMES if n != "gemma2-2b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_equals_the_reference(name, reduced):
    """Every other registered arch, as gemma2-2b above."""
    get = C.reduced_config if reduced else C.get_config
    ref_get = ref_reduced_config if reduced else ref_get_config
    assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return tree.numel()


def test_param_count_counts_init_params():
    from repro_torch.models.model import init_params
    cfg = C.reduced_config("gemma2-2b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    leaves = [params["embed"]["table"], params["final_norm"]["scale"]]
    leaves += [t for lp in params["layers"] for sub in lp.values() for t in sub.values()]
    assert cfg.param_count() == sum(t.numel() for t in leaves)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_param_count_counts_init_params(name):
    """MoE (router and experts), arctic's dense residual, qk-norm scales
    and the untied head are counted as ``init_params`` draws them."""
    from repro_torch.models.model import init_params
    cfg = C.reduced_config(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert cfg.param_count() == _count(params)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_param_count_at_full_width_is_the_references_moe_and_head(name):
    """At full width the port's count differs from the reference's only by
    the reference's extra d a dense attention block (its ``mlp + d`` term);
    in the recurrent blocks, by what the reference's count leaves out
    (``tests/test_torch_ssm.py`` spells out those terms); and in an
    encoder-decoder by the biases, which the reference does not count (a
    decoder layer's self- and cross-attention's, an encoder layer's), an
    encoder layer's extra d (its ``3 * d`` term) and the encoder's final
    norm, which it leaves out."""
    cfg, ref = C.get_config(name), ref_get_config(name)
    attn_blocks = sum(k in ("local", "global") for k in cfg.layer_kinds())
    dense_blocks = 0 if cfg.num_experts else attn_blocks
    rw, di, n, nh = (cfg.rglru_width or cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                     cfg.ssm_num_heads)
    recurrent = sum({"rglru": 3 * rw, "ssd": di + 2 * n + nh - cfg.d_model}.get(k, 0)
                    for k in cfg.layer_kinds())
    bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim + cfg.d_model if cfg.attn_bias else 0
    attentions = 2 if cfg.is_encoder_decoder else 1
    encoder = (cfg.num_encoder_layers * (cfg.d_model - bias) - cfg.d_model
               if cfg.is_encoder_decoder else 0)
    assert ref.param_count() - cfg.param_count() == (
        dense_blocks * cfg.d_model - recurrent - attentions * attn_blocks * bias + encoder)


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
