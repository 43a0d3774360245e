"""Spans around the program's layers, taken from the benchmark's side, and
what a ``torch.profiler`` trace says about them.

``Spans`` wraps, for the traced requests only, the module attributes the
program calls its layers through (``repro_torch.models.model``'s
``prefill``/``decode_step``, which ``generate`` calls as ``M.prefill``;
``moe.moe_apply``, which the model calls by module;
``attention.flash_attention_op``, K3's entry), each call in a
``record_function("portbench.<name>")`` with the shapes it was called at.
No file of the program is edited.

``read`` reduces the trace: device time by span (a kernel belongs to a span
when the CPU op that launched it, by the profiler's correlation of
launches, started inside the span on the same thread), device time by
kernel name, the union of device intervals inside the traced window (busy),
and the longest idle gaps, each named by the innermost CPU op and span
running on the host at the gap's start.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

PREFIX = "portbench."
WINDOW = PREFIX + "traced"


def _shape_prefill(cfg, params, batch, *a, **k):
    return tuple(batch["tokens"].shape)


def _shape_decode(cfg, params, token, *a, **k):
    return tuple(token.shape)


def _shape_rows(cfg, params, x, *a, **k):
    return tuple(x.shape)


def _shape_k3(q, k, v, *a, causal=True, **kw):
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], bool(causal))


# (span, module, attribute, the shapes a call records)
TARGETS = (("prefill", "repro_torch.models.model", "prefill", _shape_prefill),
           ("decode_step", "repro_torch.models.model", "decode_step", _shape_decode),
           ("moe_apply", "repro_torch.models.moe", "moe_apply", _shape_rows),
           ("k3", "repro_torch.models.attention", "flash_attention_op", _shape_k3))


class Spans:
    """Wraps the targets while installed; ``calls[span]`` lists the shapes
    of each call made meanwhile."""

    def __init__(self):
        self.calls = defaultdict(list)
        self._saved = []

    def install(self):
        from torch.profiler import record_function
        for span, mod_name, attr, shape in TARGETS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _span=span, _shape=shape, **k):
                self.calls[_span].append(_shape(*a, **k))
                with record_function(PREFIX + _span):
                    return _fn(*a, **k)

            self._saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.remove()


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, top: int = 10) -> dict:
    """The trace of ``prof`` reduced, times in seconds: ``window_s`` (the
    ``portbench.traced`` span), ``busy_s``, ``span_device_s`` by span,
    ``kernel_s`` by device op name, ``unattributed_s`` (device time no span
    took), ``device_ops`` and ``idle_gaps`` (the ``top`` largest, as [name,
    seconds])."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu, device = [], []
    for ev in events:
        if ev.device_type() == DeviceType.CPU:
            cpu.append(ev)
        elif not ev.is_user_annotation() and not ev.name().startswith(PREFIX):
            device.append(ev)
    window = next((ev for ev in cpu if ev.name() == WINDOW), None)
    if window is None:
        raise RuntimeError("the trace holds no portbench.traced span")
    w0, w1, main = window.start_ns(), window.end_ns(), window.start_thread_id()
    host = sorted((ev for ev in cpu if ev.start_thread_id() == main and w0 <= ev.start_ns() <= w1),
                  key=lambda ev: ev.start_ns())
    # the ops a launch links to: the frontend events (no link of their own),
    # as torch's own reduction takes them
    start_of = {ev.correlation_id(): ev.start_ns() for ev in host
                if ev.linked_correlation_id() == 0}
    spans = [(ev.start_ns(), ev.end_ns(), ev.name()[len(PREFIX):]) for ev in host
             if ev.name().startswith(PREFIX) and ev.name() != WINDOW]

    span_ns, kernel_ns, intervals, launched = defaultdict(int), defaultdict(int), [], []
    for ev in device:
        s, e = max(ev.start_ns(), w0), min(ev.end_ns(), w1)
        if e <= s:
            continue
        intervals.append((s, e))
        kernel_ns[ev.name()] += e - s
        launched.append((start_of.get(ev.linked_correlation_id(), -1), e - s))
    # a sweep over launches in host order, with the spans open at each
    unattributed, j, open_spans = 0, 0, []
    for t, dur in sorted(launched):
        while j < len(spans) and spans[j][0] <= t:
            open_spans.append(spans[j])
            j += 1
        open_spans = [sp for sp in open_spans if sp[1] >= t]
        names = {sp[2] for sp in open_spans} if t >= 0 else set()
        for name in names:
            span_ns[name] += dur
        if not names:
            unattributed += dur
    busy = _union(intervals)
    gaps = [(b[0] - a[1], a[1]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]])]
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:top]
    starts = [ev.start_ns() for ev in host]

    def doing(t):
        """The innermost portbench span and CPU op running at ``t``."""
        i = bisect.bisect_right(starts, t)
        inner = span = None
        for ev in host[:i]:
            if ev.end_ns() >= t:
                if ev.name().startswith(PREFIX) and ev.name() != WINDOW:
                    span = ev.name()
                inner = ev.name()
        return " > ".join(n for n in dict.fromkeys((span, inner)) if n) or "(no op)"

    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "span_device_s": {k: v / 1e9 for k, v in span_ns.items()},
            "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
            "unattributed_s": unattributed / 1e9,
            "device_ops": [[k, v / 1e9] for k, v in
                           sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[doing(t), g / 1e9] for g, t in gaps]}
