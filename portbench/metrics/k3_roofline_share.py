"""k3_roofline_share: K3's bound (``yardstick.flash_bound_ms``, a copy of
``chip_smoke.flash_bound``/``bound_ms``) summed over its traced calls, over
the device time of kernels named ``flash_wgmma_kernel``, in %."""
from portbench.yardstick import flash_bound_ms

KERNEL = "flash_wgmma_kernel"


def read(run):
    calls = run.calls.get("k3")
    t = run.trace
    s = sum(v for k, v in (t or {}).get("kernel_s", {}).items() if KERNEL in k)
    if not calls or s <= 0:
        return None
    return 100.0 * sum(flash_bound_ms(c) for c in calls) / (1e3 * s)
