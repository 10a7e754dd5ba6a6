"""peak_gib: torch.cuda.max_memory_allocated over the window (reset after
set-up), in GiB: it decides the largest padded height one card proves."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30
