"""outside_spans.s: seconds a prove outside the port's top-level stage
spans: the VM trace (vm/) and whatever prover glue no span covers; the
step's prove seconds less its top-level spans, summed over the traced
window, over the number of proves."""

from port_bench.metrics import common


def read(run):
    steps = [s for s in common.proved(run) if s.spans]
    if not steps:
        return None
    return sum(s.prove_s - sum(s.spans.values()) for s in steps) / len(steps)
