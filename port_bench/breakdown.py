"""The traced run's breakdown: the device operations that took most time,
and the card's idle time by what the host was doing, as the port's
innermost open stage span names it."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from . import trace as tr

TOP = 10
OUTSIDE = "prove outside spans (VM trace, glue)"


def _self_segments(spans, lo, hi):
    """[(label, start, end)]: [lo, hi] cut where the innermost open span
    changes; label None outside every span."""
    inside = [sp for sp in spans if sp.start < hi and sp.end > lo]
    points = sorted({lo, hi} | {max(lo, min(hi, t)) for sp in inside
                                for t in (sp.start, sp.end)})
    out = []
    for a, b in zip(points, points[1:]):
        sp = tr.innermost_span(inside, (a + b) // 2)
        out.append(("/".join(sp.path) if sp else None, a, b))
    return out


def idle_by_label(run) -> dict:
    """Idle nanoseconds of the card in the traced window, by label."""
    labels, lo, hi = [], [], []
    steps = run.steps
    for i, s in enumerate(steps):
        for label, a, b in _self_segments(run.device_trace.spans,
                                          s.start_ns, s.proved_ns):
            labels.append(label or OUTSIDE)
            lo.append(a)
            hi.append(b)
        labels.append("verify")
        lo.append(s.proved_ns)
        hi.append(s.end_ns)
        if i + 1 < len(steps):
            labels.append("between steps")
            lo.append(s.end_ns)
            hi.append(steps[i + 1].start_ns)
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    idle_ns = (hi - lo) - run.device_trace.ops.covered(lo, hi)
    idle = defaultdict(int)
    for label, ns in zip(labels, idle_ns.tolist()):
        idle[label] += ns
    return idle


def busy_and_window(run) -> tuple[float, float]:
    """(seconds the card ran an operation, seconds of the traced window)."""
    lo, hi = run.steps[0].start_ns, run.steps[-1].end_ns
    return int(run.device_trace.ops.covered(lo, hi)) / 1e9, (hi - lo) / 1e9


def breakdown(run) -> dict:
    ops = run.device_trace.ops
    by_name = np.bincount(ops.name_id, weights=ops.duration(),
                          minlength=len(ops.names)) if len(ops) else []
    top_ops = sorted(zip(ops.names, by_name), key=lambda kv: -kv[1])[:TOP]
    idle = idle_by_label(run)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name, float(ns) / 1e9] for name, ns in top_ops],
            "idle_gaps": [[label, ns / 1e9] for label, ns in top_idle]}


def alignment(run) -> dict:
    """How the device trace sits on the host clock: the marker's offset
    and uncertainty, and the share of device time inside the window's
    steps (near 1 where the clocks agree)."""
    t = run.device_trace
    lo, hi = run.steps[0].start_ns, run.steps[-1].end_ns
    total = int(t.ops.duration().sum())
    inside = int((np.minimum(t.ops.end, hi)
                  - np.maximum(t.ops.start, lo)).clip(0).sum())
    return {"offset_ns": t.offset_ns, "marker_slack_ns": t.marker_slack_ns,
            "device_ops": len(t.ops), "read_s": t.read_s,
            "share_in_steps": inside / total if total else None}
