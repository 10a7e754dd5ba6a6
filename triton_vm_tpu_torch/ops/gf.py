"""Goldilocks arithmetic on int64 tensors.

A base-field element is a `torch.int64` holding the canonical u64 bit
pattern of a value in [0, p), p = 2^64 - 2^32 + 1. Values at or above 2^63
are negative as int64; every operation here works on the bit pattern:

- additions and products wrap mod 2^64 (two's complement);
- `>>` is arithmetic, so every right shift is masked;
- unsigned order is signed order after flipping the sign bit (`_ult`).

Reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). Every function keeps
its outputs canonical. The counterpart of `triton_vm_tpu.ops.gf`, held
against it element for element (tests/test_torch_field.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fields.bfe import P
from ..utils import profiler

I64 = torch.int64
EPS = 0xFFFF_FFFF          # 2^32 - 1 == 2^64 mod p
MASK32 = 0xFFFF_FFFF
P_I64 = P - (1 << 64)      # p as a (negative) int64 bit pattern
_SIGN = -(1 << 63)
_P_FLIPPED = P ^ (1 << 63)  # p in the sign-flipped order of _ult

# Bytes that the temporaries of one block of a whole-table operation (the
# transforms of ops/ntt.py, the column reductions of ops/kernels.py) may
# take: a few GB of an 80 GB card, whatever the table's size.
WORK_BYTES = 2 << 30
# int64 temporaries that one word of such a block holds at the peak of
# `mul` (the limbs, partial products and carries of _mul128 and
# _reduce128, and the operands): one NTT of a (379, 2^15) table raised the
# CPU's resident set by 13 times the table's size.
TEMPS_PER_WORD = 16


def block_rows(row_words: int) -> int:
    """Rows of `row_words` field words each that one block may hold, so
    that its temporaries stay under WORK_BYTES (at least one row)."""
    return max(1, WORK_BYTES // (TEMPS_PER_WORD * 8 * row_words))


def to_i64(x: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def _ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _hi32(a):
    return (a >> 32) & MASK32


def _canon(x):
    """One conditional subtraction of p: any u64 pattern -> [0, p)."""
    return torch.where((x ^ _SIGN) < _P_FLIPPED, x, x - P_I64)


def _reduce128(lo, hi):
    """(hi * 2^64 + lo) mod p, canonical."""
    hi_hi = _hi32(hi)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPS, t0)
    t1 = hi_lo * EPS
    r = t0 + t1
    r = torch.where(_ult(r, t1), r + EPS, r)
    return _canon(r)


def _mul128(a, b):
    """Full 64x64 -> 128-bit product as (lo, hi) int64 bit patterns."""
    a0, a1 = a & MASK32, _hi32(a)
    b0, b1 = b & MASK32, _hi32(b)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    mid_carry = _ult(mid, lh).to(I64)
    lo = ll + (mid << 32)
    c0 = _ult(lo, ll).to(I64)
    hi = hh + _hi32(mid) + (mid_carry << 32) + c0
    return lo, hi


# ------------------------------------------------------------- host I/O

def from_u64(arr, device="cpu"):
    """numpy uint64 (or a list of ints) -> int64 tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64))
    return torch.from_numpy(a.view(np.int64)).to(device)


def to_u64(t) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bit patterns. The port's
    device-to-host boundary: reading a CUDA tensor blocks the host until
    the card has computed it, and while a profiler session is open each
    such read is counted (`profiler.device_read`)."""
    if not profiler.recording() or t.device.type != "cuda":
        return t.detach().cpu().numpy().view(np.uint64)
    t0 = time.perf_counter()
    out = t.detach().cpu().numpy().view(np.uint64)
    profiler.device_read(out.nbytes, time.perf_counter() - t0)
    return out


def equal(a, b) -> bool:
    """torch.equal: on a card, a blocking read of one flag, counted as
    `to_u64` counts its reads."""
    if not profiler.recording() or a.device.type != "cuda":
        return torch.equal(a, b)
    t0 = time.perf_counter()
    out = torch.equal(a, b)
    profiler.device_read(1, time.perf_counter() - t0)
    return out


def full(shape, value: int, device="cpu"):
    return torch.full(shape, to_i64(value % P), dtype=I64, device=device)


# ----------------------------------------------------------- arithmetic

def add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + EPS, s)
    return _canon(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - EPS, d)


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def mul(a, b):
    return _reduce128(*_mul128(a, b))


def mul_const(a, k: int):
    """Multiply by a Python-int constant."""
    return mul(a, torch.tensor(to_i64(k % P), dtype=I64, device=a.device))


def pow_const(a, e: int):
    """a**e for a static non-negative integer exponent."""
    if e < 0:
        raise ValueError("negative exponent; invert first")
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a):
    """Fermat inversion a^(p-2); inputs must be nonzero."""
    return pow_const(a, P - 2)


def reduce_sum(v, axis: int):
    """Exact sum mod p over one axis.

    Each element splits into 32-bit halves; the halves sum exactly in
    int64 (below 2^31 terms), and the two sums, each below 2^63 < p, are
    canonical and recombine as lo + hi * 2^32."""
    if v.shape[axis] >= 1 << 31:
        raise ValueError("reduce_sum axis too long")
    lo = (v & MASK32).sum(dim=axis)
    hi = _hi32(v).sum(dim=axis)
    return add(lo, mul_const(hi, 1 << 32))


def batch_inverse(v):
    """Elementwise inverse with zeros mapped to zero (twenty-first's
    `batch_inversion` convention)."""
    zero = v == 0
    out = inv(torch.where(zero, torch.ones_like(v), v))
    return torch.where(zero, torch.zeros_like(v), out)


# The split of a power's exponent, csrc/goldilocks.cuh's kPowBits:
# offset * base^e = lo[e mod 2^12] * hi[e >> 12] for e < 2^24.
POW_BITS = 12
MAX_POWER_WORDS = 1 << 2 * POW_BITS
_POWER_TABLES: dict = {}


def power_tables(base: int, offset: int = 1, device="cpu"):
    """(lo, hi), two int64 tensors of 2^12 words on `device` (cached per
    base, offset and device): lo[j] = offset * base^j and hi[j] =
    base^(2^12 j), so offset * base^e = lo[e mod 2^12] * hi[e >> 12] for
    every e < 2^24. K3 and K4 read them in the kernel; `powers` gathers
    them on the card."""
    from .npfield import powers_u64

    key = (base % P, offset % P, str(device))
    t = _POWER_TABLES.get(key)
    if t is None:
        n = 1 << POW_BITS
        t = _POWER_TABLES[key] = (
            from_u64(powers_u64(base, offset, n), device),
            from_u64(powers_u64(pow(base, n, P), 1, n), device))
    return t


def table_powers(base: int, n: int, offset: int = 1, device="cpu"):
    """[offset * base^i for i < n] from the two tables of `power_tables`,
    gathered and multiplied once on `device` (n <= 2^24)."""
    if n > MAX_POWER_WORDS:
        raise ValueError(f"powers: {n} words exceed the tables' "
                         f"{MAX_POWER_WORDS}")
    lo, hi = power_tables(base, offset, device)
    e = torch.arange(n, device=device)
    return mul(lo[e & ((1 << POW_BITS) - 1)], hi[e >> POW_BITS])


def powers(base: int, n: int, offset: int = 1, device="cpu"):
    """[offset * base^i for i < n] as an int64 tensor: on the CPU the host
    ladder (`npfield.powers_u64`), elsewhere `table_powers`, so no n-word
    table is built on the host."""
    from .npfield import powers_u64

    if torch.device(device).type == "cpu":
        return from_u64(powers_u64(base, offset, n), device)
    return table_powers(base, n, offset, device)
