"""setup_s: seconds from the process's start to the first timed step
(imports, inputs, the kernels' build or load, the AIR, warm-up)."""


def read(run):
    return run.setup_s
