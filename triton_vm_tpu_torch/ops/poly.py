"""Polynomial products, subproduct trees and multipoint evaluation on
tensors, over Goldilocks.

A polynomial is an int64 tensor of coefficients, low order first
(ops/gf.py's bit patterns); leading axes batch. Products go through the
NTTs of ops/ntt.py, so a product of degree-n polynomials costs
O(n log n) and a tree over N points O(N log^2 N):

- `subproduct_tree`: the monic products of aligned blocks of 2^k points,
  level by level, each stored without its leading 1;
- `evaluate_at_points`: Bernstein's scaled remainder tree. One power
  series inversion at the root, then a middle product per level; no
  division per node;
- `lagrange_combination`: sum_i c_i prod_{j != i} (x - x_j) bottom up;
- `bezout_coefficients`: the RAM table's Bezout coefficient polynomials
  (triton-vm/src/table/ram.rs:162-206, which uses twenty-first's fast
  zerofier, multipoint evaluation and interpolation), the same
  coefficients as the O(N^2) host version `tables/master._bezout_plain`.
"""

from __future__ import annotations

import torch

from . import gf, ntt


def _cyclic(a, b, length: int):
    """a * b mod (x^length - 1), both zero-padded to `length` (a power of
    two); leading axes broadcast."""
    return ntt.intt(gf.mul(ntt.ntt(a.contiguous(), length=length),
                           ntt.ntt(b.contiguous(), length=length)))


def mul(a, b):
    """Products of a (..., la) and b (..., lb): (..., la + lb - 1)."""
    n = a.shape[-1] + b.shape[-1] - 1
    return _cyclic(a, b, 1 << (n - 1).bit_length())[..., :n]


def inverse_series(h, n: int):
    """g with g * h = 1 mod t^n, for h (n,) with h[0] = 1: Newton's
    iteration g <- g - g (h g - 1), doubling the precision each step."""
    g = h.new_ones(1)
    p = 1
    while p < n:
        p2 = min(2 * p, n)
        e = mul(h[:p2], g)[:p2]
        e[0] = 0  # h g - 1: (h g)[0] = h[0] g[0] = 1
        g = gf.sub(torch.cat([g, g.new_zeros(p2 - p)]), mul(g, e)[:p2])
        p = p2
    return g


def subproduct_tree(points):
    """points (N,), N a power of two -> levels: levels[k] (N >> k, 2^k)
    holds, for each aligned block of 2^k points, the monic product of
    (x - x_i) over the block without its leading 1. The product of two
    monic halves is x^2m + x^m (a + b) + a b, a and b their low parts of
    degree < m, so a b fits a cyclic product of length 2m exactly."""
    levels = [gf.neg(points)[:, None]]
    while levels[-1].shape[0] > 1:
        z = levels[-1]
        m = z.shape[1]
        a, b = z[0::2], z[1::2]
        low = _cyclic(a, b, 2 * m)
        low[:, m:] = gf.add(low[:, m:], gf.add(a, b))
        levels.append(low)
    return levels


def evaluate_at_points(f, levels):
    """f (N,) of degree < N at the N points of the subproduct tree.

    Scaled remainder tree: node v keeps y_v, the first 2^k coefficients
    in 1/x of (f mod Z_v) / Z_v. At the root it is f times the inverse of
    the reversed Z; a child's is the parent's times the sibling's Z,
    whose coefficients at x^-1 .. x^-d are a middle product (cyclic of
    length 2d, clear of the wrap-around). At a leaf Z = x - x_i, and
    y = f(x_i) / (x - x_i) starts with f(x_i)."""
    n = levels[0].shape[0]
    root = levels[-1][0]
    rev = torch.cat([root.new_ones(1), root.flip(0)])
    y = mul(inverse_series(rev[:n], n), f.flip(0))[:n][None]   # (1, n)
    for k in range(len(levels) - 2, -1, -1):
        d = 1 << k
        # each child's sibling's low part, reversed: (n / 2d, 2, d)
        sib = levels[k].view(-1, 2, d).flip(1).flip(2)
        conv = ntt.intt(gf.mul(ntt.ntt(y.contiguous(), length=2 * d)[:, None],
                               ntt.ntt(sib.contiguous(), length=2 * d)))
        # y_c[m] = y_u[m + d] + sum_i Zs_low[i] y_u[m + i]
        y = gf.add(y[:, None, d:], conv[..., d - 1:2 * d - 1]).reshape(-1, d)
    return y[:, 0]


def lagrange_combination(c, levels):
    """c (N,) -> F: F[k] (N >> k, 2^k) holds, for each aligned block of
    2^k points, sum_i c_i prod_{j != i} (x - x_j) over the block (degree
    < 2^k). F_u = F_l Z_r + F_r Z_l = F_l Zr_low + F_r Zl_low + x^d (F_l
    + F_r), each product of degree < 2d."""
    out = [c[:, None]]
    for k in range(len(levels) - 1):
        d = 1 << k
        fv = out[-1].view(-1, 2, d)
        prod = _cyclic(fv, levels[k].view(-1, 2, d).flip(1), 2 * d)
        fu = gf.add(prod[:, 0], prod[:, 1])
        fu[:, d:] = gf.add(fu[:, d:], gf.add(fv[:, 0], fv[:, 1]))
        out.append(fu)
    return out


def _blocks_of_prefix(n: int, num_levels: int):
    """(level, block index) of the aligned blocks that tile [0, n), one
    per set bit of n."""
    return [(k, (n >> (k + 1)) << 1) for k in range(num_levels)
            if n >> k & 1]


def bezout_coefficients(roots):
    """(a, b), each (N,) coefficients, with a rp + b rp' = 1 for rp the
    product of (x - r) over the N distinct roots (N >= 1), b of degree <
    N interpolating 1 / rp'(r) and a of degree < N - 1 (padded with a
    zero), as ram.rs:162-206 computes them.

    The roots are padded with zeros to a power of two; the padding only
    enters through subtrees that do not hold a root, so rp and b are
    formed from the aligned blocks that tile the N roots."""
    n = roots.shape[0]
    size = 1 << (n - 1).bit_length()
    points = roots.new_zeros(size)
    points[:n] = roots
    levels = subproduct_tree(points)
    blocks = _blocks_of_prefix(n, len(levels))

    # each block's monic product, and the products of the first j blocks
    pieces = [torch.cat([levels[k][i], roots.new_ones(1)]) for k, i in blocks]
    prefix = [pieces[0]]
    for z in pieces[1:]:
        prefix.append(mul(prefix[-1], z))
    rp = prefix[-1]                                        # (n + 1,)
    fd = gf.mul(rp[1:], torch.arange(1, n + 1, dtype=rp.dtype,
                                     device=rp.device))    # rp', (n,)
    fd_at = evaluate_at_points(torch.cat([fd, fd.new_zeros(size - n)]),
                               levels)[:n]
    # b = sum_i (1 / rp'(r_i)) prod_{j != i} (x - r_j) / rp'(r_i)
    c = roots.new_zeros(size)
    c[:n] = gf.batch_inverse(gf.mul(fd_at, fd_at))
    comb = lagrange_combination(c, levels)
    b = comb[blocks[0][0]][blocks[0][1]]
    for (k, i), z, zb in zip(blocks[1:], pieces[1:], prefix):
        b = gf.add(mul(b, z), mul(comb[k][i], zb))
    num = gf.neg(mul(fd, b))                               # 1 - rp' b
    num[0] = gf.add(num[0], torch.ones_like(num[0]))
    if n == 1:
        a = b.new_zeros(0)
    else:
        # num = a rp exactly, deg a <= n - 2: reversed, rev(a) = rev(num)
        # / rev(rp) mod t^(n - 1)
        inv = inverse_series(rp.flip(0)[:n - 1], n - 1)
        a = mul(num.flip(0)[:n - 1], inv)[:n - 1].flip(0)
        if not gf.equal(mul(a, rp), num):
            raise ArithmeticError("the RAM pointers are not distinct: "
                                  "a rp + b rp' != 1")
    a = torch.cat([a, a.new_zeros(1)])
    return a, b
