"""Vectorized HOST field arithmetic (numpy u64, no device round-trip).

The verifier's per-query work (combination-codeword linear sums and DEEP
updates over t ~ 173 revealed rows x 470 columns) was scalar Python XFE
arithmetic — fine at 2^10, hopeless for the fast-verification design
goal (README.md:46-76 of the reference; BASELINE config 5's recursive
verifier). These helpers run the same algebra as fields/bfe.py /
fields/xfe.py on whole arrays: 32-bit-split schoolbook products with the
Goldilocks 2^64 == 2^32 - 1 reduction, everything in wrapping u64 numpy
ops (mirrors the device gf/gfx kernels).

Layouts: BFE arrays are plain u64 ndarrays of canonical residues;
XFE arrays are u64 ndarrays with a trailing axis of size 3 holding the
coefficients of 1, x, x^2 (same order as fields/xfe.py tuples).
"""

from __future__ import annotations

import numpy as np

from ..fields import bfe

P = 0xFFFFFFFF00000001
_P = np.uint64(P)
_MASK = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def bfe_add(a, b):
    r = a + b
    r = r + (r < a).astype(np.uint64) * _MASK  # +2^64 == +(2^32 - 1)
    return np.where(r >= _P, r - _P, r)


def bfe_sub(a, b):
    r = a - b
    r = r - (a < b).astype(np.uint64) * _MASK  # -2^64 == -(2^32 - 1)
    return np.where(r >= _P, r - _P, r)


def bfe_mul(a, b):
    """(a * b) mod p elementwise; a, b broadcastable u64 arrays of
    canonical residues."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    a0, a1 = a & _MASK, a >> _S32
    b0, b1 = b & _MASK, b >> _S32
    lo = a0 * b0
    hi = a1 * b1
    mid = a1 * b0
    mid2 = a0 * b1
    mid = mid + mid2
    mid_c = (mid < mid2).astype(np.uint64)
    x_lo = lo + (mid << _S32)
    c0 = (x_lo < lo).astype(np.uint64)
    x_hi = hi + (mid >> _S32) + (mid_c << _S32) + c0
    hi0, hi1 = x_hi & _MASK, x_hi >> _S32
    t = x_lo - hi1
    t = t - (x_lo < hi1).astype(np.uint64) * _MASK
    u = hi0 * _MASK
    r = t + u
    r = r + (r < u).astype(np.uint64) * _MASK
    return np.where(r >= _P, r - _P, r)


# Calls of `powers_u64` with more than 2^12 words since the last reset:
# a prove on the card builds no power table longer than that on the host
# (ops/gf.py::power_tables); chip_smoke.py reads it as it reads the
# kernels' launch counts.
long_tables = {"powers_u64": 0}
LONG_TABLE_WORDS = 1 << 12


def powers_u64(base: int, offset: int, n: int):
    """[offset * base^i for i < n] as u64, by log-doubling: log2(n)
    vectorized block products instead of an O(n) Python loop."""
    if n > LONG_TABLE_WORDS:
        long_tables["powers_u64"] += 1
    out = np.empty(max(n, 1), np.uint64)
    out[0] = offset % P
    k = 1
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = bfe_mul(out[:m], np.uint64(pow(base, k, P)))
        k *= 2
    return out[:n]


def bfe_sum(a, axis):
    """Mod-p sum along `axis` by log-depth halving (a u64 accumulator
    overflows after two terms; halving keeps every add in-range)."""
    a = np.moveaxis(np.asarray(a, np.uint64), axis, 0)
    while a.shape[0] > 1:
        n = a.shape[0]
        half = n // 2
        head = bfe_add(a[:half], a[half:2 * half])
        a = head if n % 2 == 0 else np.concatenate([head, a[-1:]])
    return a[0]


def xfe_mul(a, b):
    """XFE product on (..., 3) arrays: schoolbook c0..c4, reduce by
    x^3 = x - 1, x^4 = x^2 - x (fields/xfe.py:46-55)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c0 = bfe_mul(a0, b0)
    c1 = bfe_add(bfe_mul(a0, b1), bfe_mul(a1, b0))
    c2 = bfe_add(bfe_add(bfe_mul(a0, b2), bfe_mul(a1, b1)),
                 bfe_mul(a2, b0))
    c3 = bfe_add(bfe_mul(a1, b2), bfe_mul(a2, b1))
    c4 = bfe_mul(a2, b2)
    return np.stack([bfe_sub(c0, c3),
                     bfe_sub(bfe_add(c1, c3), c4),
                     bfe_add(c2, c4)], axis=-1)


def xfe_inv(a):
    """1 / a elementwise on (..., 3) arrays, by the norm map: a^-1 =
    adj(M) e_0 / N(a) for the matrix M of the product by a (x^3 = x - 1),
    N(a) = det M in the base field, so all norms take one
    `bfe.batch_inverse`. Raises ZeroDivisionError if any a is zero, as
    fields/xfe.py's `inv` does."""
    a = np.asarray(a, np.uint64)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    s = bfe_add(a0, a2)
    adj0 = bfe_sub(bfe_mul(s, s), bfe_mul(bfe_sub(a1, a2), a1))
    adj1 = bfe_sub(bfe_mul(bfe_sub(a1, a2), a2), bfe_mul(a1, s))
    adj2 = bfe_sub(bfe_mul(a1, a1), bfe_mul(s, a2))
    norm = bfe_sub(bfe_mul(a0, adj0),
                   bfe_add(bfe_mul(a2, adj1), bfe_mul(a1, adj2)))
    norm_inv = np.asarray(bfe.batch_inverse(
        [int(n) for n in norm.reshape(-1)]), np.uint64).reshape(norm.shape)
    return xfe_bfe_mul(np.stack([adj0, adj1, adj2], -1), norm_inv)


def bfe_pow(a, e: int):
    """a^e elementwise for a u64 array of base-field words and e >= 0."""
    a = np.asarray(a, np.uint64)
    out = np.ones_like(a)
    for bit in bin(e)[2:]:
        out = bfe_mul(out, out)
        if bit == "1":
            out = bfe_mul(out, a)
    return out


def xfe_bfe_mul(a, s):
    """XFE (..., 3) times BFE (...) (broadcast over the trailing axis)."""
    return bfe_mul(a, np.asarray(s, np.uint64)[..., None])


def xfe_add(a, b):
    return bfe_add(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def xfe_sub(a, b):
    return bfe_sub(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def xfe_sum(a, axis):
    """Mod-p XFE sum along `axis` (not the trailing coefficient axis)."""
    return bfe_sum(a, axis)


def lift(a):
    """BFE (...) u64 -> XFE (..., 3) with zero x / x^2 coefficients."""
    a = np.asarray(a, np.uint64)
    out = np.zeros(a.shape + (3,), np.uint64)
    out[..., 0] = a
    return out


def to_tuples(arr):
    """(n, 3) u64 -> list of XFE tuples."""
    return [tuple(int(c) for c in row) for row in np.asarray(arr)]
