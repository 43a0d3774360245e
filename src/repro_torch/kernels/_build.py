"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel lives in ``kernels/<name>/csrc/<name>.cu`` with a plain C
interface, and may include the shared headers ``kernels/*.cuh``. At first
use it is compiled for Hopper (``sm_90a``) into
``<repo>/build/kernels/lib<name>-<digest>.so``, the digest covering the
source, the shared headers and the flags, so an edited source or header is
rebuilt and an unchanged one is not. Several sources build in parallel, one
nvcc process each. A failed build raises; nothing falls back to another
implementation.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output, including the -Xptxas -v report


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the default toolkit location, or $PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def headers():
    """The headers every source may include, in a fixed order."""
    return sorted(KERNELS_DIR.glob("*.cuh"))


def nvcc_command(src: Path, out: Path):
    """nvcc's command line for one source, with the shared headers on the
    include path."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(KERNELS_DIR), "-o", str(out), str(src)]


def _paths(name: str):
    src = source(name)
    shared = b"".join(h.read_bytes() for h in headers())
    digest = hashlib.sha1(src.read_bytes() + shared + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, lib, lib.with_suffix(".log")


def build(names: Iterable[str]) -> Dict[str, Built]:
    """Compile every named source that is not built yet, all at once."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Built] = {}
    procs = {}
    for name in names:
        src, lib, log = _paths(name)
        if lib.is_file():
            done[name] = Built(name, lib, 0.0,
                               log.read_text() if log.is_file() else "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        with open(tmp_log, "w") as out:   # a file, not a pipe: nvcc never blocks on it
            proc = subprocess.Popen(nvcc_command(src, tmp), stdout=out,
                                    stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, tmp_log, lib, log, time.perf_counter())
    # each build's own seconds: the time its nvcc exited, seen by polling
    ended = {}
    while len(ended) < len(procs):
        for name, (proc, *_rest, t0) in procs.items():
            if name not in ended and (proc.poll() is not None
                                      or time.perf_counter() - t0 > BUILD_TIMEOUT_S):
                ended[name] = time.perf_counter() - t0
        time.sleep(0.05)
    failures = []
    for name, (proc, tmp, tmp_log, lib, log, t0) in procs.items():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            with open(tmp_log, "a") as out:
                out.write(f"\nnvcc timed out after {BUILD_TIMEOUT_S} s")
        out = tmp_log.read_text()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            tmp_log.unlink(missing_ok=True)
            continue
        os.replace(tmp_log, log)
        os.replace(tmp, lib)
        done[name] = Built(name, lib, ended[name], out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if code != 0:
        err = getattr(lib, f"{prefix}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
