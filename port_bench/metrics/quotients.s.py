"""quotients.s: seconds a prove in the quotients
(stark/prover._quotients_on_rows, K3): span quotients; summed over the
traced window, over the number of proves."""

from port_bench.metrics import common

SPANS = ('quotients',)


def read(run):
    return common.span_seconds_per_prove(run, SPANS)
