"""Field arithmetic on numpy u64 arrays: the algebra of bfe.py and
xfe.py on whole arrays, by 32-bit-split schoolbook products with the
Goldilocks reduction 2^64 == 2^32 - 1 in wrapping u64 operations.

Layouts: BFE arrays are plain u64 ndarrays of canonical residues;
XFE arrays are u64 ndarrays with a trailing axis of size 3 holding the
coefficients of 1, x, x^2 (same order as fields/xfe.py tuples).
"""

from __future__ import annotations

import numpy as np

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
    x^3 = x - 1, x^4 = x^2 - x (xfe.mul)."""
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
