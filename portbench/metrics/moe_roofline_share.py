"""moe_roofline_share: the MoE layer's bound (``arch/<arch>.py``
``moe_bound_ms``: the router's and k experts' products, or the weights and
tokens moved, whichever is longer) summed over its traced calls, over the
device time inside ``moe_apply`` spans, in %."""


def read(run):
    calls = run.calls.get("moe_apply")
    t = run.trace
    s = (t or {}).get("span_device_s", {}).get("moe_apply", 0.0)
    if not calls or s <= 0:
        return None
    bound = sum(run.arch.moe_bound_ms(run.config, b * n) for b, n, _ in calls)
    return 100.0 * bound / (1e3 * s)
