"""device_reads.s: seconds a prove the host sat blocked in its reads of
CUDA tensors (ops/gf.py): the profiler's `device reads.s` counter over the
traced window's sessions, over their number."""

from port_bench.metrics import program_totals


def read(run):
    return program_totals.per_prove(run, "device reads.s")
