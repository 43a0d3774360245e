"""Curated on-disk trace set: identical workloads on every machine.

A copy of ``repro.workloads.curated``: it reads the same shipped set
(``results/workloads/curated``) as data.

The runner's workload cache (``results/workloads/``) is transient — each
machine regenerates and caches locally, so two machines only see the
same traces because generation is seeded. This module adds a *shipped*
set: a small directory of versioned ``.npz`` workloads committed to the
repository (``results/workloads/curated/``) together with a
``MANIFEST.json`` of SHA-256 checksums. Cross-machine sweeps load these
instead of regenerating, and the checksums turn silent drift (a stale
file, a partial checkout, a generator edit without a re-ship) into a
hard error.

Lookup order in :func:`repro_torch.core.runner._cached_workload` is: in-memory
LRU -> local cache dir -> **curated set** -> generate. Set
``$REPRO_NO_CURATED=1`` to skip the curated set (the test suite does, so
generator edits are always exercised), or ``$REPRO_CURATED_DIR`` to point
at a different shipped set.

Rebuild after a generator change::

    python -m repro_torch.workloads.curated --build

which regenerates every manifest entry (or ``--workloads ... --scale
... --seed ...`` to curate a new slice) and rewrites the manifest.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional

MANIFEST = "MANIFEST.json"
MANIFEST_VERSION = 1
# the grid slice shipped by default: the quick-set workloads at the
# benchmark quick scale, under the fig8 grid's base seed
DEFAULT_WORKLOADS = ("kmn", "bicg", "syrk", "gesummv", "conv2d", "nw")
DEFAULT_SCALE = 0.2
DEFAULT_SEED = 0


def curated_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_CURATED_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/workloads/curated.py -> repo root is three levels up
    return pathlib.Path(__file__).resolve().parents[3] \
        / "results" / "workloads" / "curated"


def enabled() -> bool:
    return not os.environ.get("REPRO_NO_CURATED")


def _fname(name: str, seed: int, scale: float) -> str:
    return f"{name}-s{seed}-x{scale:g}.npz"


def load_manifest(root: Optional[pathlib.Path] = None) -> Dict[str, str]:
    """filename -> sha256 of the shipped set ({} when absent)."""
    root = root if root is not None else curated_dir()
    path = root / MANIFEST
    if not path.exists():
        return {}
    doc = json.loads(path.read_text())
    if doc.get("version") != MANIFEST_VERSION:
        raise ValueError(f"unsupported curated manifest version in {path}")
    return dict(doc["files"])


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_curated(name: str, seed: int, scale: float):
    """Load a workload from the curated set, or None when it is not
    shipped. A shipped file whose checksum disagrees with the manifest
    raises — a corrupt or stale curated set must never silently feed a
    sweep."""
    if not enabled():
        return None
    root = curated_dir()
    fname = _fname(name, seed, scale)
    digest = load_manifest(root).get(fname)
    if digest is None:
        return None
    path = root / fname
    if not path.exists():
        raise FileNotFoundError(
            f"curated manifest lists {fname} but the file is missing "
            f"under {root}")
    got = _sha256(path)
    if got != digest:
        raise ValueError(
            f"curated workload {fname} checksum mismatch "
            f"(manifest {digest[:12]}…, file {got[:12]}…) — re-ship with "
            f"`python -m repro_torch.workloads.curated --build`")
    from repro_torch.workloads.io import load_workload
    return load_workload(path)


def verify_manifest(root: Optional[pathlib.Path] = None) -> List[str]:
    """Check every manifest entry (existence + checksum). Returns a list
    of human-readable problems; empty means the set is intact."""
    root = root if root is not None else curated_dir()
    problems: List[str] = []
    files = load_manifest(root)
    if not files:
        return [f"no curated manifest under {root}"]
    for fname, digest in sorted(files.items()):
        path = root / fname
        if not path.exists():
            problems.append(f"missing: {fname}")
        elif _sha256(path) != digest:
            problems.append(f"checksum mismatch: {fname}")
    return problems


def build(workloads=DEFAULT_WORKLOADS, scale: float = DEFAULT_SCALE,
          seed: int = DEFAULT_SEED,
          root: Optional[pathlib.Path] = None) -> pathlib.Path:
    """(Re)generate the curated set and rewrite the manifest. Existing
    manifest entries not in this build are regenerated too, so a partial
    build never leaves stale hashes behind."""
    from repro_torch.core.runner import workload_seed
    from repro_torch.workloads import make_workload
    from repro_torch.workloads.io import save_workload
    root = root if root is not None else curated_dir()
    root.mkdir(parents=True, exist_ok=True)
    entries = {}
    wanted = {(w, workload_seed(seed, w), scale) for w in workloads}
    # keep previously curated slices alive by re-deriving their keys
    for fname in load_manifest(root) if (root / MANIFEST).exists() else {}:
        stem = fname[:-len(".npz")]
        name, s, x = stem.rsplit("-s", 1)[0], None, None
        try:
            rest = stem[len(name) + 2:]
            s_str, x_str = rest.split("-x", 1)
            s, x = int(s_str), float(x_str)
        except ValueError:
            continue
        wanted.add((name, s, x))
    for name, s, x in sorted(wanted):
        wl = make_workload(name, seed=s, scale=x)
        path = root / _fname(name, s, x)
        save_workload(wl, path)
        entries[path.name] = _sha256(path)
    doc = {"version": MANIFEST_VERSION, "files": entries}
    (root / MANIFEST).write_text(json.dumps(doc, indent=1, sort_keys=True)
                                 + "\n")
    return root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="store_true",
                    help="regenerate the curated set + manifest")
    ap.add_argument("--verify", action="store_true",
                    help="verify the shipped set against the manifest")
    ap.add_argument("--workloads", nargs="*", default=list(DEFAULT_WORKLOADS))
    ap.add_argument("--scale", type=float, default=DEFAULT_SCALE)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = ap.parse_args()
    if args.build:
        root = build(tuple(args.workloads), args.scale, args.seed)
        print(f"curated set rebuilt under {root}")
        return 0
    problems = verify_manifest()
    for p in problems:
        print(f"PROBLEM: {p}")
    print("curated set OK" if not problems else
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
