"""device_idle_share: 1 - (the union of device intervals) / (the traced
window's wall time), over the traced requests, in %."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
