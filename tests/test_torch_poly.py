"""The port's tensor polynomial arithmetic (triton_vm_tpu_torch.ops.poly)
and the RAM table's fast Bezout coefficients on the CPU: products,
Newton inversion, the subproduct tree and the scaled remainder tree
against the host list polynomials of fields/poly.py, and
`bezout_coefficient_polynomials_coefficients` against its O(N^2) plain
version and the JAX package's function, word for word."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.tables import master as jmt
from triton_vm_tpu_torch.fields import poly as hpoly
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf
from triton_vm_tpu_torch.ops import poly
from triton_vm_tpu_torch.tables import master as mt

torch.set_num_threads(2)


def _field(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(
        0, P, size=n, dtype=np.uint64)]


def _t(vals):
    return gf.from_u64(np.asarray(vals, np.uint64), "cpu")


def _ints(t):
    return gf.to_u64(t).tolist()


def _distinct_roots(seed, n):
    """n distinct roots: half near 2^50 (RAM pointers of the recursive
    verifier), the rest anywhere in the field, edge values included."""
    rng = np.random.default_rng(seed)
    roots = {0, 1, P - 1, (1 << 50) - 1, 1 << 50} if n >= 17 else set()
    while len(roots) < n:
        roots.add(int(rng.integers((1 << 50) - 4096, (1 << 50) + 4096))
                  if len(roots) % 2 else int(rng.integers(0, P,
                                                          dtype=np.uint64)))
    return sorted(roots)[:n]


@pytest.mark.parametrize("la,lb", [(1, 1), (1, 7), (5, 3), (16, 16),
                                   (33, 100)])
def test_mul_equals_host(la, lb):
    a, b = _field(la, la), _field(lb + 100, lb)
    assert _ints(poly.mul(_t(a), _t(b))) == hpoly.mul(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 37, 64])
def test_inverse_series(n):
    h = [1] + _field(n, n - 1)
    g = _ints(poly.inverse_series(_t(h), n))
    prod = hpoly.mul(h, g)[:n]
    assert prod == [1] + [0] * (n - 1)


@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_subproduct_tree_and_remainder_tree(k):
    n = 1 << k
    pts = _field(7 + k, n)
    levels = poly.subproduct_tree(_t(pts))
    assert len(levels) == k + 1
    for lv, z in enumerate(levels):
        d = 1 << lv
        for i in range(n >> lv):
            want = hpoly.zerofier(pts[i * d:(i + 1) * d])
            assert _ints(z[i]) + [1] == want
    f = _field(99 + k, n)
    got = _ints(poly.evaluate_at_points(_t(f), levels))
    assert got == hpoly.batch_evaluate(f, pts)


def test_lagrange_combination_equals_host():
    n = 16
    pts, c = _field(3, n), _field(4, n)
    comb = poly.lagrange_combination(_t(c), poly.subproduct_tree(_t(pts)))
    want = [0] * n
    for i in range(n):
        term = hpoly.scalar_mul(
            hpoly.zerofier(pts[:i] + pts[i + 1:]), c[i])
        want = hpoly.add(want, term)
    assert _ints(comb[-1][0]) == want


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 256])
def test_bezout_equals_plain_and_jax(n):
    roots = _distinct_roots(n, n)
    got = mt.bezout_coefficient_polynomials_coefficients(roots, "cpu")
    assert got == mt._bezout_plain(roots)
    ja, jb = jmt.bezout_coefficient_polynomials_coefficients(roots)
    assert got == ([int(x) for x in ja], [int(x) for x in jb])
    a, b = got
    assert len(a) == len(b) == n
    assert all(type(x) is int for x in a + b)


def test_bezout_identity_at_points():
    """a rp + b rp' = 1 checked at random points, at a size (3000 roots)
    where the plain version would take minutes: rp(x) = prod (x - r) and
    rp'(x) = rp(x) sum 1 / (x - r)."""
    roots = _distinct_roots(5, 3000)
    a, b = mt.bezout_coefficient_polynomials_coefficients(roots, "cpu")
    for x in _field(11, 3):
        rp, s = 1, 0
        for r in roots:
            rp = rp * (x - r) % P
            s = (s + pow(x - r, P - 2, P)) % P
        lhs = (hpoly.evaluate(a, x) * rp
               + hpoly.evaluate(b, x) * rp * s) % P
        assert lhs == 1


def test_bezout_refuses_repeated_roots():
    with pytest.raises(ArithmeticError):
        mt.bezout_coefficient_polynomials_coefficients([5, 9, 5], "cpu")


def test_bezout_runs_on_the_named_device():
    """No quiet move to the host: on a CUDA device it runs on the card, or
    raises where there is none."""
    roots = [3, 4, 1 << 45]
    if torch.cuda.is_available():
        assert (mt.bezout_coefficient_polynomials_coefficients(roots, "cuda")
                == mt._bezout_plain(roots))
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mt.bezout_coefficient_polynomials_coefficients(roots, "cuda")
