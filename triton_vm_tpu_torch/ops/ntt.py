"""NTT, iNTT and coset low-degree extension over Goldilocks, on tensors.

Transforms run along the last axis and batch over every leading axis
(columns, and the 3 coefficients of an XFE tensor). The algorithm is the
textbook iterative radix-2 network: a bit-reversal gather, then log2(n)
butterfly stages over a (..., blocks, 2, half) view. Any correct
transform gives the same field elements as `triton_vm_tpu.ops.ntt`
(tests/test_torch_ntt.py).

The leading axes are transformed a block of rows at a time
(`gf.block_rows`), each block written into one preallocated output, so a
transform's temporaries stay a few GB however many columns it has.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import bfe
from ..fields.bfe import P
from . import gf
from .npfield import powers_u64


@functools.lru_cache(maxsize=None)
def bitrev_indices(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


_DEVICE_CACHE: dict = {}


def _cached(key, make):
    """Small per-device constant tables (twiddles, bit-reversal maps)."""
    t = _DEVICE_CACHE.get(key)
    if t is None:
        t = _DEVICE_CACHE[key] = make()
    return t


def _twiddles(n: int, root: int, device):
    """root^j for j < n/2."""
    return _cached(("tw", n, root, str(device)),
                   lambda: gf.from_u64(powers_u64(root, 1, n // 2), device))


def _scales(n: int, base: int, factor: int, device):
    """factor * base^i for i < n."""
    return _cached(("sc", n, base, factor, str(device)),
                   lambda: gf.from_u64(powers_u64(base, factor, n), device))


def _transform(x, root: int):
    """Natural-order input -> natural-order output: out_k = sum_i
    x_i root^(ik), root a primitive n-th root of unity."""
    n = x.shape[-1]
    if n == 1:
        return x
    batch = x.shape[:-1]
    br = _cached(("br", n, str(x.device)),
                 lambda: torch.as_tensor(bitrev_indices(n), device=x.device))
    x = x.index_select(-1, br)
    w_all = _twiddles(n, root, x.device)
    m = 1
    while m < n:
        xs = x.reshape(*batch, n // (2 * m), 2, m)
        u = xs[..., 0, :]
        t = gf.mul(xs[..., 1, :], w_all[::n // (2 * m)])
        x = torch.stack([gf.add(u, t), gf.sub(u, t)], dim=-2).reshape(
            *batch, n)
        m *= 2
    return x


def _blockwise(fn, x, length: int):
    """fn over blocks of the rows of x (..., n), each block's result
    (rows, length) written into one new tensor (..., length). The leading
    axes of x must merge into one view (no copy is made)."""
    out = torch.empty(x.shape[:-1] + (length,), dtype=x.dtype,
                      device=x.device)
    rows, dst = x.view(-1, x.shape[-1]), out.view(-1, length)
    step = gf.block_rows(max(x.shape[-1], length))
    for s in range(0, rows.shape[0], step):
        dst[s:s + step] = fn(rows[s:s + step])
    return out


def _ntt_rows(coeffs, offset: int, length: int):
    n = coeffs.shape[-1]
    if offset % P != 1:
        coeffs = gf.mul(coeffs, _scales(n, offset, 1, coeffs.device))
    if length != n:
        padded = torch.zeros(coeffs.shape[:-1] + (length,),
                             dtype=coeffs.dtype, device=coeffs.device)
        padded[..., :n] = coeffs
        coeffs = padded
    return _transform(coeffs, bfe.primitive_root_of_unity(length))


def _intt_rows(values, offset: int):
    n = values.shape[-1]
    c = _transform(values, bfe.inv(bfe.primitive_root_of_unity(n)))
    return gf.mul(c, _scales(n, bfe.inv(offset), bfe.inv(n % P),
                             values.device))


def ntt(coeffs, offset: int = 1, length: int | None = None):
    """Natural-order coefficients (..., n) -> values on offset *
    <omega_length> of the polynomial they give (length >= n, by default
    n): the coefficients zero-padded to `length`, then transformed."""
    length = length or coeffs.shape[-1]
    assert length >= coeffs.shape[-1]
    return _blockwise(lambda b: _ntt_rows(b, offset, length), coeffs, length)


def intt(values, offset: int = 1):
    """Values on offset * <omega_n> -> natural-order coefficients."""
    return _blockwise(lambda b: _intt_rows(b, offset), values,
                      values.shape[-1])


def lde(values, expansion: int, in_offset: int = 1, out_offset: int = 7):
    """Values on in_offset * <omega_n> -> values of the same polynomial on
    out_offset * <omega_{expansion * n}> (arithmetic_domain.rs:203-212)."""
    length = values.shape[-1] * expansion
    return _blockwise(
        lambda b: _ntt_rows(_intt_rows(b, in_offset), out_offset, length),
        values, length)
