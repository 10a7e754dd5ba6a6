"""The port's profiler totals (`triton_vm_tpu_torch.utils.profiler.totals()`):
every finished session of the process, summed. A traced run opens one
session a step of its window and none in its set-up, so the totals cover
the window's proves."""

from __future__ import annotations


def per_prove(run, counter: str):
    """The profiler's counter `counter`, summed over every span path and
    session, over the number of sessions; None untraced, where no session
    ran, or where the program keeps no totals."""
    if not run.trace:
        return None
    from triton_vm_tpu_torch.utils import profiler

    totals = getattr(profiler, "totals", None)
    if totals is None:
        return None
    t = totals()
    if not t.sessions:
        return None
    return t.count(counter) / t.sessions
