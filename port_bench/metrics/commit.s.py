"""commit.s: seconds a prove in the commitments (ops/ntt.py,
stark/jit_lde.py, crypto/merkle.py): spans main LDE, aux LDE, main
merkle, aux merkle, segmentify, quot merkle; summed over the traced
window, over the number of proves."""

from port_bench.metrics import common

SPANS = ('main LDE', 'aux LDE', 'main merkle', 'aux merkle', 'segmentify', 'quot merkle')


def read(run):
    return common.span_seconds_per_prove(run, SPANS)
