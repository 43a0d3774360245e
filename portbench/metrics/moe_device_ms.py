"""moe_device_ms: device time inside ``moe_apply`` spans, per traced
request, in ms."""


def read(run):
    t = run.trace
    s = (t or {}).get("span_device_s", {}).get("moe_apply", 0.0)
    if not run.calls.get("moe_apply") or s <= 0:
        return None
    return 1e3 * s / run.traced_requests
