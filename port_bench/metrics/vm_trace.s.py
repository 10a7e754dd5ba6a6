"""vm_trace.s: seconds a prove in the VM trace (vm/machine.py,
vm/native.py): the top-level span VM trace, summed over the traced
window, over the number of proves; None where no prove has the span."""

from port_bench.metrics import common

SPAN = "VM trace"


def read(run):
    if not any(SPAN in s.spans for s in common.proved(run)):
        return None
    return common.span_seconds_per_prove(run, (SPAN,))
