"""kernels_roofline: the port's kernels K1-K4 together, as a share of
their roofline: the least time the card could take for every launch of
the traced window (roofline/work.py's operations and bytes over
roofline/peaks.json's rates) over the device time the profiler gives the
kernels by name, in %."""

from port_bench import trace as tr
from port_bench.roofline import work


def read(run):
    t = run.device_trace
    if t is None or not t.launches or not len(t.ops):
        return None
    bound = sum(work.bound_s(kernel, shape) for kernel, shape in t.launches)
    ns = int(t.ops.duration()[t.ops.mask_of(tr.kernel_of)].sum())
    if ns == 0:
        return None
    return 100.0 * bound / (ns / 1e9)
