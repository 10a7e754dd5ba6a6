"""ood_deep.s: seconds a prove in the out-of-domain rows and the DEEP sum
(ops/kernels.py): spans OOD and weighted sum; summed over the traced
window, over the number of proves."""

from port_bench.metrics import common

SPANS = ('OOD', 'weighted sum')


def read(run):
    return common.span_seconds_per_prove(run, SPANS)
