"""What the kernel probes share: text edits of a kernel's source, and building
several sources at once into ``build/probe/``.

Used by ``tools/flash_probe.py`` (K3) and ``tools/kernel_probe.py`` (K1,
K2); neither needs the card to import this module.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"


def edited(src: str, edits) -> str:
    """``src`` with each edit (old, new) or (old, new, n) applied: ``old``
    must appear exactly n times (once when n is not given), and every
    occurrence becomes ``new``."""
    for edit in edits:
        old, new = edit[:2]
        n = edit[2] if len(edit) > 2 else 1
        if src.count(old) != n:
            raise SystemExit(f"{Path(sys.argv[0]).name}: the source has {old!r} "
                             f"{src.count(old)} times, not {n}")
        src = src.replace(old, new)
    return src


def build_all(sources):
    """{name: path.cu} -> {name: path.so} under OUT, one nvcc each, all
    started together, nvcc's output (its -Xptxas -v report) beside each
    library as lib{name}.log; raises SystemExit with that output if one
    fails."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cu in sources.items():
        so = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen(_build.nvcc_command(Path(cu), so),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"{Path(sys.argv[0]).name}: {name} does not build:\n{log[-4000:]}")
        built[name] = so
    return built
