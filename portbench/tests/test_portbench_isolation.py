"""Nothing under portbench/ loads JAX or the JAX package, and the plain
references load nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path):
    """Top-level names of the modules ``path`` imports, by its syntax tree."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not {top(n) for n in imports(path)} & FORBIDDEN


def test_the_name_check_compares_whole_top_level_names():
    assert top("repro_torch.models") == "repro_torch" and "repro_torch" not in FORBIDDEN
    assert top("repro.core") in FORBIDDEN


def _closure(module: str):
    """The portbench modules ``module`` imports, transitively, with every
    other top-level name they import."""
    seen, outside, todo = set(), set(), [module]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = ROOT / (mod.replace(".", "/") + ".py")
        for name in imports(path):
            if top(name) == "portbench":
                todo.append(name)
            else:
                outside.add(top(name))
    return seen, outside


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("[!_]*.py")),
                         ids=lambda p: p.stem)
def test_references_import_nothing_of_the_program(path):
    seen, outside = _closure(f"portbench.reference.{path.stem}")
    assert all(m.startswith("portbench.reference") for m in seen), seen
    assert not outside & (FORBIDDEN | {"repro_torch"}), outside


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU at a small size, in a fresh interpreter."""
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "from portbench.tests import tiny\nfrom portbench import harness\n"
            "harness.run(tiny.cell(), 5, 0.2, True, 'cpu')\n"
            "print(harness.forbidden_modules())").format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_a_run_on_the_card_loads_neither(card):
    """``run.py`` exits 3 if the window left JAX or its package loaded."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "granite-moe-3b-a800m.prompt_4k", "--seed", "5", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
