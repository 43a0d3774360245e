"""Paper-faithful demo on the PyTorch port's simulator: the SM simulator
running all seven schedulers on one benchmark per class (LWS / SWS / CI) —
the Fig. 8 experiment in miniature — followed by the same sweep on traces
derived from the reference's Pallas kernels (through the on-disk npz
round trip), and a 2-SM chip run where the SMs contend on the shared
L2/DRAM stage (``examples/ciao_sim_demo.py`` without JAX). The scalar
simulator runs on the host.

    PYTHONPATH=src python examples/torch_ciao_sim_demo.py
"""
import tempfile

from repro_torch.core import load_workload, make_workload, save_workload
from repro_torch.core.gpu import GPUConfig, run_gpu_policy_sweep
from repro_torch.core.simulator import run_policy_sweep

POLICIES = ("gto", "ccws", "best-swl", "statpcal", "ciao-p", "ciao-t",
            "ciao-c")


def _print_sweep(name: str, klass_label: str, res) -> None:
    gto = res["gto"].ipc
    print(f"\n{name} [{klass_label}]  (IPC normalized to GTO, 1 SM)")
    print(f"{'policy':10s} {'ipc':>6s} {'hit%':>6s} {'active':>7s} "
          f"{'vta_hits':>9s}")
    for p in POLICIES:
        r = res[p]
        print(f"{p:10s} {r.ipc / gto:6.2f} "
              f"{100 * r.l1_hit_rate:6.1f} "
              f"{r.mean_active_warps:7.1f} {r.vta_hits:9d}")


def single_sm(names=("kmn", "syrk", "backprop"), scale: float = 0.5):
    """{workload: {policy: SimResult}}."""
    out = {}
    for name in names:
        wl = make_workload(name, scale=scale)
        out[name] = run_policy_sweep(wl, POLICIES)
        _print_sweep(name, wl.klass, out[name])
    return out


def derived_kernels(names=("flashattn", "gather"), scale: float = 0.5):
    """Kernel-derived traces (repro_torch.workloads.derived): the flash-attn
    tiled Q/K/V walk and the gather kernel's index stream, scheduled by
    the same policies — plus the on-disk npz round trip."""
    out = {}
    for name in names:
        wl = make_workload(name, scale=scale)
        with tempfile.TemporaryDirectory() as td:
            wl = load_workload(save_workload(wl, f"{td}/{name}"))
        out[name] = run_policy_sweep(wl, POLICIES)
        _print_sweep(name, f"{wl.klass}, kernel-derived", out[name])
    return out


def multi_sm(num_sms: int = 2, names=("kmn", "syrk"), scale: float = 0.25):
    """Same sweep on a multi-SM chip: every SM runs a full copy of the
    workload; the shared L2 capacity and DRAM bandwidth now carry
    cross-SM interference. {workload: {policy: GPUResult}}."""
    gpu = GPUConfig(num_sms=num_sms)
    out = {}
    for name in names:
        wl = make_workload(name, scale=scale)
        res = out[name] = run_gpu_policy_sweep(wl, ("gto", "ciao-p", "ciao-c"),
                                               gpu=gpu)
        gto = res["gto"].ipc
        print(f"\n{name} [{wl.klass}]  (chip IPC normalized to GTO, "
              f"{num_sms} SMs)")
        print(f"{'policy':10s} {'ipc':>6s} {'per-SM ipc':>24s}")
        for p, r in res.items():
            per_sm = " ".join(f"{s.ipc:.3f}" for s in r.per_sm)
            print(f"{p:10s} {r.ipc / gto:6.2f} {per_sm:>24s}")
    return out


def main():
    single_sm()
    derived_kernels()
    multi_sm()


if __name__ == "__main__":
    main()
