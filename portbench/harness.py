"""One run of one cell: set-up, the measured window, the traced requests,
the check, and the result's line.

Everything that belongs to a cell is data found by name from
``BENCHMARK.json``: the configuration file (``configs/<config>.json``,
whose ``arch`` names ``arch/<arch>.py``, the weights and counts, and
``reference/<arch>.py``, the plain reference), the traffic mix
(``traffic/<mix>.json``, read by ``traffic.py``), the cell's limits
(``limits/<cell>.json``) and one reader a metric (``metrics/<metric>.py``,
a function ``read(run)`` returning the value, or None where the run has
nothing to read).

The program under test is the port's serving entry,
``repro_torch.serving.generate.generate``; the benchmark draws the weights
and the prompts itself and hands them to it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from portbench import check, traffic
from portbench.trace import WINDOW, Spans
from portbench.trace import read as read_trace

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and mix,
    its chips, limits and the metrics it reports (every end-to-end metric;
    the per-layer metrics whose ``workloads`` name it)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    return {"name": name, "chips": work["chips"],
            "config": json.loads((root / entry["file"]).read_text()),
            "mix": traffic.load(work["traffic"]), "limits": check.load_limits(name),
            "end_to_end": bench["end_to_end"],
            "per_layer": [m for m in bench["per_layer"] if name in m["workloads"]]}


def arch_of(config):
    return importlib.import_module(f"portbench.arch.{config['arch']}")


def port_config(config):
    """The port's configuration of this model with every field the file
    fixes set to the file's value, so the file, not the port's own copy,
    says what runs. Fields where the port's copy differs are logged."""
    from repro_torch.configs import get_config
    cfg = get_config(config["port_config"])
    want = arch_of(config).port_fields(config)
    moved = {k: (getattr(cfg, k), v) for k, v in want.items() if getattr(cfg, k) != v}
    if moved:
        log(f"portbench: {config['name']}.json sets {moved} (port's, file's)")
    return dataclasses.replace(cfg, **want)


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


class KernelBuilds:
    """While installed, records the seconds of every kernel build the
    program makes (``repro_torch.kernels._build.build``; 0 for a library
    already built in this checkout)."""

    def __init__(self):
        self.seconds = {}

    def __enter__(self):
        from repro_torch.kernels import _build
        self._mod, self._real = _build, _build.build

        def build(names):
            done = self._real(names)
            self.seconds.update({n: b.seconds for n, b in done.items()})
            return done

        _build.build = build
        return self

    def __exit__(self, *exc):
        self._mod.build = self._real


def _launches():
    from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    return {"K3": flash_attention_cuda.launches, "K2": decode_attention_cuda.launches}


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None) -> dict:
    """The run; returns the result's line as a dict."""
    import torch
    from repro_torch.serving.generate import generate
    t_start = time.perf_counter() if t_start is None else t_start
    config, mix = cell["config"], cell["mix"]
    arch = arch_of(config)
    cfg = port_config(config)
    vocab, new = config["vocab_size"], mix["max_new_tokens"]

    t_imported = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(traffic.request_seed(seed, "weights"))
    params = arch.draw_params(config, gen, device)
    _sync(device)
    t_drawn = time.perf_counter()

    def request(index):
        """One request; the client takes its tokens and logits to the host."""
        prompts = traffic.prompts(mix, vocab, seed, index, device)
        t0 = time.perf_counter()
        tokens, logits = generate(cfg, params, prompts, new, device=device)
        tokens, logits = tokens.cpu(), logits.cpu()
        return t0, time.perf_counter(), tokens, logits

    with KernelBuilds() as builds:
        request("warm-up")
    setup_s = time.perf_counter() - t_start
    log(f"portbench: {cell['name']} seed {seed}: set-up {setup_s:.3f} s (start to the port "
        f"imported {t_imported - t_start:.3f}, weights {t_drawn - t_imported:.3f}, warm-up "
        f"request {t_start + setup_s - t_drawn:.3f}, of which kernel builds "
        f"{sum(builds.seconds.values()):.3f}: {builds.seconds})")

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    before = _launches()
    served, first = [], None
    while True:
        t0, t1, tokens, logits = request(len(served))
        first = t0 if first is None else first
        served.append((len(served), tokens, logits))
        if t1 - first >= seconds:
            break
    window_s = t1 - first
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else None
    launches = {k: (v - before[k]) / len(served) for k, v in _launches().items()}
    log(f"portbench: window {window_s:.3f} s, {len(served)} requests; kernel launches a "
        f"request {launches}")

    profile, spans = None, Spans()
    if trace:
        from torch.profiler import ProfilerActivity, profile as profiler, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
        with profiler(activities=acts) as prof:
            _sync(device)
            with spans, record_function(WINDOW):
                for j in range(mix["trace_requests"]):
                    request(("traced", j))
        profile = read_trace(prof)
        del prof
        log(f"portbench: traced {mix['trace_requests']} requests: window {profile['window_s']:.4f}"
            f" s, busy {profile['busy_s']:.4f} s, by span "
            + json.dumps(profile["span_device_s"]) + f", no span {profile['unattributed_s']:.4f} s")

    ctx = SimpleNamespace(config=config, mix=mix, arch=arch, device=device,
                          setup_s=setup_s, peak_bytes=peak,
                          window={"requests": len(served), "seconds": window_s},
                          trace=profile, calls=spans.calls,
                          traced_requests=mix["trace_requests"] if trace else 0)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if device != "cpu":
        torch.cuda.empty_cache()
        log(f"portbench: card {card_line()}")
    t_check = time.perf_counter()
    compared, picked, _ = check.judge(config, mix, params, served, seed, cell["limits"], device)
    log(f"portbench: checked requests {picked} of {len(served)} against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")
    if device != "cpu":
        result_device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell["chips"], "memory_peak_bytes": peak}
    else:
        result_device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        result_device.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
    result = {"correct": check.passes(compared), "attempted": len(served), "failed": 0,
              "metrics": metrics, "device": result_device}
    if trace:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    # counted in setup_s, and given apart: the nvcc build that only a
    # checkout's first run makes
    result["kernel_build_s"] = sum(builds.seconds.values())
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "(nvidia-smi gave no answer)"


def forbidden_modules():
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
