"""Scalar (host-side) degree-3 extension field F_p[x]/(x^3 - x + 1).

Reproduces the `XFieldElement` semantics of the `twenty-first` crate as used
by the reference prover (e.g. triton-vm/src/stark.rs:427-433).
An XFE is a tuple (c0, c1, c2) of Python ints: c0 + c1*x + c2*x^2.

The Shah polynomial x^3 - x + 1 gives the reduction rules
    x^3 = x - 1,   x^4 = x^2 - x.
"""

from __future__ import annotations

from . import bfe
from .bfe import P

XFE = tuple  # (c0, c1, c2)

ZERO = (0, 0, 0)
ONE = (1, 0, 0)
X = (0, 1, 0)


def lift(b: int) -> XFE:
    """Embed a base-field element into the extension field."""
    return (b % P, 0, 0)


def unlift(a: XFE) -> int:
    if a[1] or a[2]:
        raise ValueError(f"{a} is not in the base field")
    return a[0]


def add(a: XFE, b: XFE) -> XFE:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P)


def sub(a: XFE, b: XFE) -> XFE:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P)


def neg(a: XFE) -> XFE:
    return (-a[0] % P, -a[1] % P, -a[2] % P)


def mul(a: XFE, b: XFE) -> XFE:
    a0, a1, a2 = a
    b0, b1, b2 = b
    # schoolbook product c0..c4, then reduce by x^3 = x - 1, x^4 = x^2 - x
    c0 = a0 * b0
    c1 = a0 * b1 + a1 * b0
    c2 = a0 * b2 + a1 * b1 + a2 * b0
    c3 = a1 * b2 + a2 * b1
    c4 = a2 * b2
    return ((c0 - c3) % P, (c1 + c3 - c4) % P, (c2 + c4) % P)


def bfe_mul(a: XFE, s: int) -> XFE:
    return (a[0] * s % P, a[1] * s % P, a[2] * s % P)


def mod_pow(a: XFE, e: int) -> XFE:
    if e < 0:
        return mod_pow(inv(a), -e)
    result = ONE
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a: XFE) -> XFE:
    """Inverse via the norm map: a^-1 = phi(a)*phi^2(a) / N(a), with
    phi the Frobenius x -> x^p and N(a) = a*phi(a)*phi^2(a) in F_p."""
    if a == ZERO:
        raise ZeroDivisionError("inverse of zero in F_p^3")
    ap = _frobenius(a)
    app = _frobenius(ap)
    adj = mul(ap, app)
    norm = mul(a, adj)  # lies in the base field
    n = unlift(norm)
    return bfe_mul(adj, bfe.inv(n))


def _xpow_mod_shah(e: int) -> XFE:
    return mod_pow(X, e)


_XP = None
_XP2 = None


def _frobenius_consts():
    global _XP, _XP2
    if _XP is None:
        _XP = _xpow_mod_shah(P)
        _XP2 = mul(_XP, _XP)
    return _XP, _XP2


def _frobenius(a: XFE) -> XFE:
    """phi(a) = a0 + a1*x^p + a2*x^2p (all coefficients in F_p are fixed)."""
    xp, xp2 = _frobenius_consts()
    t = bfe_mul(xp, a[1])
    u = bfe_mul(xp2, a[2])
    return ((a[0] + t[0] + u[0]) % P, (t[1] + u[1]) % P, (t[2] + u[2]) % P)
