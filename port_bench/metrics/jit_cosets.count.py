"""jit_cosets.count: coset transforms a prove in the JIT LDE
(stark/jit_lde.py): the profiler's `JIT cosets` counter, one per coset
transform of a table's coefficients, summed over every span path and the
traced window's sessions, over their number; None untraced, where no
session ran, or where the program counts no such counter."""

COUNTER = "JIT cosets"


def read(run):
    if not run.trace:
        return None
    from triton_vm_tpu_torch.utils import profiler

    totals = getattr(profiler, "totals", None)
    if totals is None:
        return None
    t = totals()
    if not t.sessions or not any(COUNTER in c for c in t.counts.values()):
        return None
    return t.count(COUNTER) / t.sessions
