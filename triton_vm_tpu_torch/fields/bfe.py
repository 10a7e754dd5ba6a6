"""Scalar (host-side) Goldilocks base-field semantics.

The Goldilocks prime field F_p with p = 2^64 - 2^32 + 1 is the base field of
Triton VM (reference: triton-vm/src/lib.rs:5-6; the arithmetic
itself lives in the external `twenty-first` crate, whose canonical-value
semantics are reproduced here).

Host-side code (VM interpreter, Fiat-Shamir transcript, parameter derivation)
uses plain Python integers in [0, p); the int64 tensor implementation
lives in `triton_vm_tpu_torch.ops.gf` and is tested against this
module.
"""

from __future__ import annotations

P = 0xFFFF_FFFF_0000_0001  # 2^64 - 2^32 + 1
EPS = 0xFFFF_FFFF  # 2^32 - 1 == 2^64 mod P
R = EPS  # Montgomery radix 2^64 reduced mod P (used by the Tip5 S-box)
R_INV = pow(R, P - 2, P)  # 2^-64 mod P
GENERATOR = 7  # smallest generator of F_p^* (twenty-first convention)
MAX_TWO_ADICITY = 32  # largest 2-power order of a root of unity


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in F_p")
    return pow(a, P - 2, P)


def div(a: int, b: int) -> int:
    return mul(a, inv(b))


def mod_pow(a: int, e: int) -> int:
    return pow(a, e, P) if e >= 0 else pow(inv(a), -e, P)


def primitive_root_of_unity(order: int) -> int:
    """Canonical root of unity of the given power-of-2 order.

    Derived as GENERATOR^((p-1)/order); for order 2^32 this equals
    0x185629dcda58878c, matching the tabulated roots of `twenty-first`
    used throughout the reference (e.g. arithmetic_domain.rs:101-108).
    """
    if order < 1 or order & (order - 1):
        raise ValueError(f"order must be a power of two, got {order}")
    if order > 1 << MAX_TWO_ADICITY:
        raise ValueError(f"no root of unity of order {order}")
    return pow(GENERATOR, (P - 1) // order, P)


def batch_inverse(values: list[int]) -> list[int]:
    """Montgomery batch inversion; O(n) muls + one inversion."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        if v % P == 0:
            raise ZeroDivisionError("batch_inverse: zero element")
        prefix[i + 1] = prefix[i] * v % P
    acc = inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * acc % P
        acc = acc * values[i] % P
    return out
