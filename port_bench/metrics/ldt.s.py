"""ldt.s: seconds a prove in the low-degree test (ldt/stir.py, ldt/fri.py):
span LDT; summed over the traced window, over the number of proves."""

from port_bench.metrics import common

SPANS = ('LDT',)


def read(run):
    return common.span_seconds_per_prove(run, SPANS)
