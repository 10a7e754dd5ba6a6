"""prove_s: the window's prove seconds (the VM trace and Stark.prove, the
card synchronised), summed over every step, over the number of steps."""


def read(run):
    if not run.steps:
        return None
    return sum(s.prove_s for s in run.steps) / len(run.steps)
