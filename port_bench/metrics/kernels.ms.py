"""kernels.ms: milliseconds a prove of device time in the port's
hand-written kernels K1-K4 (csrc/), from the profiler's CUDA activity by
kernel name, summed over the traced window's proves, over their number."""

from port_bench import trace as tr
from port_bench.metrics import common


def read(run):
    t = run.device_trace
    steps = common.proved(run)
    if t is None or not steps or not len(t.ops):
        return None
    ops = t.ops
    in_proves = sum((ops.start >= s.start_ns) & (ops.start < s.proved_ns)
                    for s in steps)
    ns = int(ops.duration()[ops.mask_of(tr.kernel_of) & (in_proves > 0)]
             .sum())
    if ns == 0:
        return None
    return ns / 1e6 / len(steps)
