"""What several metric readers share."""

from __future__ import annotations


def proved(run):
    """The window's steps whose prove returned a proof."""
    return [s for s in run.steps if s.proof is not None]


def span_seconds_per_prove(run, names):
    """The port's top-level stage spans `names`, summed over the traced
    window's proves, over the number of proves; None untraced."""
    steps = [s for s in proved(run) if s.spans]
    if not steps:
        return None
    return sum(s.spans.get(n, 0.0) for s in steps for n in names) / len(steps)
