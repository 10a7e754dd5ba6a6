"""verify_s: the window's verify seconds, summed over every step that had
a proof to verify, over the number of those steps."""


def read(run):
    steps = [s for s in run.steps if s.proof is not None]
    if not steps:
        return None
    return sum(s.verify_s for s in steps) / len(steps)
