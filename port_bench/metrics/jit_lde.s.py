"""jit_lde.s: seconds a prove in the JIT (coset-by-coset) LDE
(stark/jit_lde.py: K4, K2, K3 a coset): every span path of the
profiler's totals that ends in `JIT coset NTT`, `JIT coset hash` or `JIT
coset quotients`, at any depth (they are sub-spans of `main LDE`, `aux
LDE`, `quotients` and `reveal`), summed over the traced window's
sessions, over their number; None untraced, where no session ran, or
where no prove took the JIT path."""

SPANS = ("JIT coset NTT", "JIT coset hash", "JIT coset quotients")


def read(run):
    if not run.trace:
        return None
    from triton_vm_tpu_torch.utils import profiler

    totals = getattr(profiler, "totals", None)
    if totals is None:
        return None
    t = totals()
    paths = [p for p in t.seconds if p and p[-1] in SPANS]
    if not t.sessions or not paths:
        return None
    return sum(t.seconds[p] for p in paths) / t.sessions
