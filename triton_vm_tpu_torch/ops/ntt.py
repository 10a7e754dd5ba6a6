"""NTT, iNTT and coset low-degree extension over Goldilocks, on tensors.

Transforms run along the last axis and batch over every leading axis
(columns, and the 3 coefficients of an XFE tensor). Every transform goes
through one dispatch point, `_rows`, which takes each scale as a pair
(base, factor), word i times factor * base^i: a tensor on the card
launches K4, the hand-written kernel of csrc/ntt.cu (ops/ntt_cuda.py),
with the coset scale and the zero-padding fused into its load and the
iNTT's offset^-i / n into its store, each power formed in the kernel from
two 2^12-word tables; a tensor on the CPU takes the plain version,
`_rows_plain`: the scales as n-word tables (`_scales`) multiplied with
`gf.mul`, then `_transform_plain`, the textbook iterative
radix-2 network (a bit-reversal gather, then log2(n) butterfly stages over
a (..., blocks, 2, half) view). There is no fallback from the kernel. Any
correct transform gives the same field elements as `triton_vm_tpu.ops.ntt`
(tests/test_torch_ntt.py, tests/test_torch_ntt_kernel.py).

On the CPU the leading axes are transformed a block of rows at a time
(`gf.block_rows`), each block written into one preallocated output, so a
transform's temporaries stay a few GB however many columns it has. K4
writes the whole output in place and needs no temporary; only `lde`'s
coefficients between its two launches are blocked on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import bfe
from ..fields.bfe import P
from . import gf, ntt_cuda
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
    """factor * base^i for i < n: the plain version's scale tables."""
    return _cached(("sc", n, base, factor, str(device)),
                   lambda: gf.from_u64(powers_u64(base, factor, n), device))


def _transform_plain(x, root: int):
    """Natural-order input -> natural-order output: out_k = sum_i
    x_i root^(ik), root a primitive n-th root of unity. The radix-2
    network in eager torch: K4's plain version."""
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


def _rows_plain(x, root: int, length: int, pre=None, post=None):
    """What K4 computes, in eager torch: post * NTT_root of the rows of
    pre * x (..., n_in) zero-padded to `length`; pre and post each a scale
    (base, factor), word i times factor * base^i, or None."""
    if pre is not None:
        x = gf.mul(x, _scales(x.shape[-1], *pre, x.device))
    if length != x.shape[-1]:
        padded = torch.zeros(x.shape[:-1] + (length,), dtype=x.dtype,
                             device=x.device)
        padded[..., :x.shape[-1]] = x
        x = padded
    x = _transform_plain(x, root)
    return x if post is None else gf.mul(x, _scales(length, *post, x.device))


def _rows(x, root: int, length: int, pre=None, post=None, out=None):
    """The one dispatch point of every transform: `_rows_plain` over the
    rows of x (rows, n_in), written into `out` (rows, length) if given.
    A tensor on the CPU takes the plain version; any other launches K4
    (ops/ntt_cuda.py), which raises on what it cannot take."""
    if x.device.type != "cpu":
        return ntt_cuda.ntt_rows(x, root, length, pre, post, out)
    y = _rows_plain(x, root, length, pre, post)
    if out is None:
        return y
    out.copy_(y)
    return out


def _transform(x, root: int):
    """Natural-order input -> natural-order output along the last axis,
    root a primitive n-th root of unity (ops/ntt_sharded.py passes its
    own); the identity at n = 1."""
    n = x.shape[-1]
    if n == 1:
        return x
    return _rows(x.reshape(-1, n), root, n).view(x.shape)


def _blockwise(fn, x, length: int, step: int):
    """fn(block, out_block) over blocks of `step` rows of x (..., n), each
    block's result (rows, length) written into one new tensor (...,
    length). The leading axes of x must merge into one view (no copy is
    made)."""
    out = torch.empty(x.shape[:-1] + (length,), dtype=x.dtype,
                      device=x.device)
    rows, dst = x.view(-1, x.shape[-1]), out.view(-1, length)
    for s in range(0, rows.shape[0], step):
        fn(rows[s:s + step], dst[s:s + step])
    return out


def _step(x, length: int, kernel_words: int = 0) -> int:
    """Rows a block: on the CPU as many as keep the plain version's
    temporaries under gf.WORK_BYTES; on the card K4 writes the output in
    place and needs no temporary, so all of them, unless the caller holds
    `kernel_words` words a row of its own between two launches (lde's
    coefficients), which then stay under gf.WORK_BYTES."""
    if x.device.type == "cpu":
        return gf.block_rows(max(x.shape[-1], length))
    if kernel_words:
        return max(1, gf.WORK_BYTES // (8 * kernel_words))
    return max(1, x.numel() // max(1, x.shape[-1]))


def _coset_scale(offset: int):
    """offset^i: the coset NTT's input scale (None on the subgroup)."""
    return None if offset % P == 1 else (offset % P, 1)


def _unscale(n: int, offset: int):
    """offset^-i / n: the iNTT's output scale."""
    return bfe.inv(offset), bfe.inv(n % P)


def ntt(coeffs, offset: int = 1, length: int | None = None):
    """Natural-order coefficients (..., n) -> values on offset *
    <omega_length> of the polynomial they give (length >= n, by default
    n): the coefficients zero-padded to `length`, then transformed."""
    n = coeffs.shape[-1]
    length = length or n
    assert length >= n
    root = bfe.primitive_root_of_unity(length)
    pre = _coset_scale(offset)
    return _blockwise(lambda b, o: _rows(b, root, length, pre, out=o),
                      coeffs, length, _step(coeffs, length))


def intt(values, offset: int = 1):
    """Values on offset * <omega_n> -> natural-order coefficients."""
    n = values.shape[-1]
    root = bfe.inv(bfe.primitive_root_of_unity(n))
    post = _unscale(n, offset)
    return _blockwise(lambda b, o: _rows(b, root, n, post=post, out=o),
                      values, n, _step(values, n))


def lde(values, expansion: int, in_offset: int = 1, out_offset: int = 7):
    """Values on in_offset * <omega_n> -> values of the same polynomial on
    out_offset * <omega_{expansion * n}> (arithmetic_domain.rs:203-212)."""
    n = values.shape[-1]
    length = n * expansion
    inv_root = bfe.inv(bfe.primitive_root_of_unity(n))
    root = bfe.primitive_root_of_unity(length)
    post, pre = _unscale(n, in_offset), _coset_scale(out_offset)
    return _blockwise(
        lambda b, o: _rows(_rows(b, inv_root, n, post=post), root, length,
                           pre, out=o),
        values, length, _step(values, length, kernel_words=n))
