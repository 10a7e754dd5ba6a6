"""device.idle_pct: the share of the window's prove time in which no
operation (kernel, copy or fill) of any kind runs on the card: one less
the union of the profiler's device intervals over the steps' prove
intervals, in %."""

from port_bench.metrics import common


def read(run):
    t = run.device_trace
    steps = common.proved(run)
    if t is None or not steps or not len(t.ops):
        return None
    total = sum(s.proved_ns - s.start_ns for s in steps)
    busy = sum(int(t.ops.covered(s.start_ns, s.proved_ns)) for s in steps)
    return 100.0 * (total - busy) / total
