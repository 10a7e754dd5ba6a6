"""device_reads.count: the host's blocking reads of CUDA tensors a prove
(ops/gf.py, the port's device-to-host boundary): the profiler's
`device reads` counter over the traced window's sessions, over their
number."""

from port_bench.metrics import program_totals


def read(run):
    return program_totals.per_prove(run, "device reads")
