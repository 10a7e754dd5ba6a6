"""Plain models of the configurations' programs: the public output each
gives for its public input, worked out without a VM."""

from __future__ import annotations

from .bfe import P


def fibonacci(public_input: list) -> list:
    """spin's program (the reference's fibonacci loop): from the stack
    (a, b) = (0, 1) it steps (a, b) -> (b, a + b) n times, n the public
    input, and writes b: the (n + 1)-th Fibonacci number mod p."""
    (n,) = public_input
    a, b = 0, 1
    for _ in range(n):
        a, b = b, (a + b) % P
    return [b]


MODELS = {"fibonacci": fibonacci}
