"""Host-side polynomial algebra over F_p and F_p^3.

Replaces the `twenty-first` `Polynomial` API surface the reference uses
(fast_coset_evaluate/interpolate, zerofier, formal derivative, scale,
divide, xgcd, barycentric_evaluate — see SURVEY.md §2.1). Host code paths
only ever touch small polynomials (verifier work, FRI last polynomial,
parameter derivation); the big transforms live in `triton_vm_tpu_torch.ops.ntt`.

A polynomial is a list of coefficients, low-order first. Two field flavors:
`bfe` polynomials hold Python ints; `xfe` polynomials hold (c0,c1,c2)
tuples. The `F` parameter is the corresponding field module
(`triton_vm_tpu_torch.fields.bfe` or `.xfe`).
"""

from __future__ import annotations

from . import bfe as _bfe
from . import xfe as _xfe
from .bfe import P


def _zero(F):
    return 0 if F is _bfe else _xfe.ZERO


def _one(F):
    return 1 if F is _bfe else _xfe.ONE


def trim(c, F=_bfe):
    z = _zero(F)
    n = len(c)
    while n > 0 and c[n - 1] == z:
        n -= 1
    return list(c[:n])


def degree(c, F=_bfe) -> int:
    """Degree; -1 for the zero polynomial (matching twenty-first)."""
    return len(trim(c, F)) - 1


def add(a, b, F=_bfe):
    n = max(len(a), len(b))
    z = _zero(F)
    return [F.add(a[i] if i < len(a) else z, b[i] if i < len(b) else z)
            for i in range(n)]


def sub(a, b, F=_bfe):
    n = max(len(a), len(b))
    z = _zero(F)
    return [F.sub(a[i] if i < len(a) else z, b[i] if i < len(b) else z)
            for i in range(n)]


def neg(a, F=_bfe):
    return [F.neg(x) for x in a]


def mul(a, b, F=_bfe):
    if not a or not b:
        return []
    z = _zero(F)
    out = [z] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == z:
            continue
        for j, y in enumerate(b):
            out[i + j] = F.add(out[i + j], F.mul(x, y))
    return out


def scalar_mul(a, s, F=_bfe):
    return [F.mul(x, s) for x in a]


def shift(a, n: int, F=_bfe):
    """Multiply by x^n."""
    return [_zero(F)] * n + list(a)


def evaluate(a, x, F=_bfe):
    """Horner evaluation."""
    acc = _zero(F)
    for c in reversed(a):
        acc = F.add(F.mul(acc, x), c)
    return acc


def batch_evaluate(a, xs, F=_bfe):
    return [evaluate(a, x, F) for x in xs]


def zerofier(roots, F=_bfe):
    """prod (x - r) over the given roots."""
    acc = [_one(F)]
    for r in roots:
        acc = mul(acc, [F.neg(r), _one(F)], F)
    return acc


def formal_derivative(a, F=_bfe):
    if F is _bfe:
        return [c * i % P for i, c in enumerate(a)][1:]
    return [_xfe.bfe_mul(c, i % P) for i, c in enumerate(a)][1:]


def scale(a, alpha, F=_bfe):
    """Substitute x -> alpha*x: coefficient i gets alpha^i."""
    out = []
    pw = _one(F)
    for c in a:
        out.append(F.mul(c, pw))
        pw = F.mul(pw, alpha)
    return out


def divide(num, den, F=_bfe):
    """Polynomial long division -> (quotient, remainder)."""
    den = trim(den, F)
    if not den:
        raise ZeroDivisionError("polynomial division by zero")
    num = trim(num, F)
    z = _zero(F)
    dlead_inv = F.inv(den[-1])
    quot = [z] * max(0, len(num) - len(den) + 1)
    rem = list(num)
    while len(rem) >= len(den) and trim(rem, F):
        rem = trim(rem, F)
        if len(rem) < len(den):
            break
        k = len(rem) - len(den)
        q = F.mul(rem[-1], dlead_inv)
        quot[k] = q
        for i, d in enumerate(den):
            rem[k + i] = F.sub(rem[k + i], F.mul(q, d))
        rem = rem[:-1]
    return trim(quot, F), trim(rem, F)


def xgcd(a, b, F=_bfe):
    """Extended Euclid: returns (g, u, v) with u*a + v*b = g, g monic."""
    r0, r1 = trim(a, F), trim(b, F)
    s0, s1 = [_one(F)], []
    t0, t1 = [], [_one(F)]
    while r1:
        q, r = divide(r0, r1, F)
        r0, r1 = r1, r
        s0, s1 = s1, sub(s0, mul(q, s1, F), F)
        t0, t1 = t1, sub(t0, mul(q, t1, F), F)
    if r0:
        lead_inv = F.inv(r0[-1])
        r0 = scalar_mul(r0, lead_inv, F)
        s0 = scalar_mul(s0, lead_inv, F)
        t0 = scalar_mul(t0, lead_inv, F)
    return trim(r0, F), trim(s0, F), trim(t0, F)


def interpolate(xs, ys, F=_bfe):
    """Lagrange interpolation (host, O(n^2)); small inputs only."""
    assert len(xs) == len(ys)
    if not xs:
        return []
    z = zerofier(xs, F)
    out = [_zero(F)] * len(xs)
    for xi, yi in zip(xs, ys):
        num, rem = divide(z, [F.neg(xi), _one(F)], F)
        assert not rem
        denom = evaluate(num, xi, F)
        term = scalar_mul(num, F.mul(yi, F.inv(denom)), F)
        out = add(out, term, F)
    return trim(out, F)


def barycentric_evaluate(codeword, z, F=_xfe):
    """Evaluate the interpolant of `codeword` over the unit root domain
    {omega^i} (offset 1, length = len(codeword)) at the point z, using the
    barycentric formula
        f(z) = (z^n - 1)/n * sum_i  omega^i * y_i / (z - omega^i).
    Matches twenty-first's `barycentric_evaluate` used by the FRI verifier
    (triton-vm/src/low_degree_test/fri.rs:609-615).
    codeword: list of XFE (or BFE lifted by caller); z: XFE.
    """
    n = len(codeword)
    w = _bfe.primitive_root_of_unity(n) if n > 1 else 1
    terms = []
    wi = 1
    for _ in range(n):
        terms.append(_xfe.sub(z, _xfe.lift(wi)))
        wi = wi * w % P
    invs = _batch_inv_xfe(terms)
    acc = _xfe.ZERO
    wi = 1
    for yi, inv_term in zip(codeword, invs):
        y = yi if isinstance(yi, tuple) else _xfe.lift(yi)
        acc = _xfe.add(acc, _xfe.bfe_mul(_xfe.mul(y, inv_term), wi))
        wi = wi * w % P
    zn = _xfe.mod_pow(z, n)
    front = _xfe.bfe_mul(_xfe.sub(zn, _xfe.ONE), _bfe.inv(n % P))
    return _xfe.mul(front, acc)


def _batch_inv_xfe(values):
    n = len(values)
    prefix = [_xfe.ONE] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = _xfe.mul(prefix[i], v)
    acc = _xfe.inv(prefix[n])
    out = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = _xfe.mul(prefix[i], acc)
        acc = _xfe.mul(acc, values[i])
    return out
