"""witness.s: seconds a prove in the witness (tables/master.py,
tables/extend_device.py): spans fill main and extend aux; summed over
the traced window, over the number of proves."""

from port_bench.metrics import common

SPANS = ('fill main', 'extend aux')


def read(run):
    return common.span_seconds_per_prove(run, SPANS)
