"""Tip5 in plain Python: permutation, sponge, digests and Fiat-Shamir
sampling (spec: tips/tip-0005/tip-0005.md; the reference consumes it
through `twenty-first`, e.g. triton-vm/src/proof_stream.rs:40-103).

Constants are derived, not copied:
  * LOOKUP_TABLE[i] = ((i+1)^3 mod 257) - 1  (Fermat cube map, offset 1)
  * MDS_MATRIX_FIRST_COLUMN = SHA-256("Tip5") as 16 little-endian u16s
  * ROUND_CONSTANTS[i] = Blake3("Tip5" || byte(i))[:16] as LE integer,
    reduced mod p, times R^-1 (R = 2^64 mod p)
"""

from __future__ import annotations

import hashlib

import numpy as np

from .bfe import P, R, R_INV
from . import npfield as nf
from .blake3_mini import blake3_digest16

STATE_SIZE = 16
RATE = 10
CAPACITY = 6
DIGEST_LEN = 5
NUM_ROUNDS = 5
NUM_SPLIT_AND_LOOKUP = 4

LOOKUP_TABLE = tuple(((i + 1) ** 3 % 257) - 1 for i in range(256))

MDS_MATRIX_FIRST_COLUMN = tuple(
    int.from_bytes(hashlib.sha256(b"Tip5").digest()[2 * i: 2 * i + 2], "little")
    for i in range(STATE_SIZE)
)

ROUND_CONSTANTS = tuple(
    int.from_bytes(blake3_digest16(b"Tip5" + bytes([i])), "little") % P * R_INV % P
    for i in range(STATE_SIZE * NUM_ROUNDS)
)


_SBOX_BYTES = tuple(LOOKUP_TABLE)
# row i of the circulant MDS matrix: entry j is the first column's (i - j)
_MDS_ROWS = tuple(tuple(MDS_MATRIX_FIRST_COLUMN[(i - j) % STATE_SIZE]
                        for j in range(STATE_SIZE))
                  for i in range(STATE_SIZE))
_RC_ROWS = tuple(ROUND_CONSTANTS[r * STATE_SIZE:(r + 1) * STATE_SIZE]
                 for r in range(NUM_ROUNDS))


_SBOX_TRANSLATION = bytes.maketrans(bytes(range(256)), bytes(_SBOX_BYTES))


def split_and_lookup(x: int) -> int:
    """S: x -> R^-1 * rho(L^8(sigma(R*x))) via the Montgomery byte view."""
    raw = (x * R % P).to_bytes(8, "little").translate(_SBOX_TRANSLATION)
    return int.from_bytes(raw, "little") * R_INV % P


def permutation(state):
    """The Tip5 permutation of 16 field elements (tip-0005.md): five
    rounds of S-box layer, circulant MDS and round constants."""
    s = list(state)
    for rc in _RC_ROWS:
        for i in range(NUM_SPLIT_AND_LOOKUP):
            s[i] = split_and_lookup(s[i])
        for i in range(NUM_SPLIT_AND_LOOKUP, STATE_SIZE):
            x = s[i]
            x2 = x * x % P
            s[i] = x2 * x2 % P * x2 % P * x % P
        s = [(sum(c * v for c, v in zip(row, s)) + k) % P
             for row, k in zip(_MDS_ROWS, rc)]
    return s


# ------------------------------------------------ batched (numpy u64)

_MDS_I64 = np.array(_MDS_ROWS, dtype=np.int64)
_SBOX_U8 = np.array(_SBOX_BYTES, dtype=np.uint8)
_MASK32 = np.uint64(0xFFFFFFFF)
_P64 = np.uint64(P)


def permutation_batch(states):
    """The permutation of every row of a (B, 16) u64 array."""
    s = np.array(states, dtype=np.uint64)
    for rc in _RC_ROWS:
        raw = nf.bfe_mul(s[:, :NUM_SPLIT_AND_LOOKUP], np.uint64(R))
        looked = _SBOX_U8[np.ascontiguousarray(raw).view(np.uint8)]
        looked = looked.view(np.uint64).reshape(raw.shape)
        looked = np.where(looked >= _P64, looked - _P64, looked)
        s[:, :NUM_SPLIT_AND_LOOKUP] = nf.bfe_mul(looked, np.uint64(R_INV))
        x = s[:, NUM_SPLIT_AND_LOOKUP:]
        x2 = nf.bfe_mul(x, x)
        x4 = nf.bfe_mul(x2, x2)
        s[:, NUM_SPLIT_AND_LOOKUP:] = nf.bfe_mul(nf.bfe_mul(x4, x2), x)
        # MDS on the 32-bit halves: each dot product stays below 2^52
        lo = (s & _MASK32).astype(np.int64) @ _MDS_I64.T
        hi = (s >> np.uint64(32)).astype(np.int64) @ _MDS_I64.T
        hi = hi.astype(np.uint64)
        # hi * 2^32 = hi1 * 2^64 + hi0 * 2^32 == hi1 (2^32 - 1) + hi0 2^32
        top = (hi & _MASK32) << np.uint64(32)
        top = np.where(top >= _P64, top - _P64, top)
        acc = nf.bfe_add(top, (hi >> np.uint64(32)) * _MASK32)
        acc = nf.bfe_add(acc, lo.astype(np.uint64))
        s = nf.bfe_add(acc, np.array(rc, dtype=np.uint64))
    return s


def hash_varlen_rows(rows):
    """hash_varlen of every row of a (B, n) u64 array: (B, 5)."""
    rows = np.asarray(rows, dtype=np.uint64)
    b, n = rows.shape
    padded = np.zeros((b, (n // RATE + 1) * RATE), dtype=np.uint64)
    padded[:, :n] = rows
    padded[:, n] = 1
    state = np.zeros((b, STATE_SIZE), dtype=np.uint64)
    for i in range(0, padded.shape[1], RATE):
        state[:, :RATE] = padded[:, i:i + RATE]
        state = permutation_batch(state)
    return state[:, :DIGEST_LEN]


def hash_pairs(left, right):
    """hash_pair of every row of two (B, 5) u64 arrays: (B, 5)."""
    left = np.asarray(left, dtype=np.uint64)
    state = np.ones((left.shape[0], STATE_SIZE), dtype=np.uint64)
    state[:, :DIGEST_LEN] = left
    state[:, DIGEST_LEN:2 * DIGEST_LEN] = right
    return permutation_batch(state)[:, :DIGEST_LEN]


def hash_10(input_10):
    """Fixed-length hashing: capacity initialized to 1, one permutation,
    digest = first 5 state elements."""
    assert len(input_10) == RATE
    state = list(input_10) + [1] * CAPACITY
    return permutation(state)[:DIGEST_LEN]


def hash_pair(left, right):
    assert len(left) == DIGEST_LEN and len(right) == DIGEST_LEN
    return hash_10(list(left) + list(right))


def hash_varlen(elements):
    sponge = Tip5Sponge()
    sponge.pad_and_absorb_all(elements)
    return sponge.squeeze()[:DIGEST_LEN]


class Tip5Sponge:
    """Overwrite-mode sponge over the Tip5 permutation (variable-length
    flavor: state starts all-zero; padding = 1 then 0s to a RATE multiple)."""

    def __init__(self):
        self.state = [0] * STATE_SIZE

    def absorb(self, chunk):
        assert len(chunk) == RATE
        self.state[:RATE] = [c % P for c in chunk]
        self.state = permutation(self.state)

    def pad_and_absorb_all(self, elements):
        elements = list(elements)
        elements.append(1)
        while len(elements) % RATE:
            elements.append(0)
        for i in range(0, len(elements), RATE):
            self.absorb(elements[i:i + RATE])

    def squeeze(self):
        out = self.state[:RATE]
        self.state = permutation(self.state)
        return out

    # ---------------------------------------------------- FS sampling
    def sample_scalars(self, n: int):
        """n XFEs; squeezes ceil(3n/RATE) times, consumes 3 BFEs per XFE
        (twenty-first `Sponge::sample_scalars` semantics)."""
        num_elements = 3 * n
        elements = []
        while len(elements) < num_elements:
            elements.extend(self.squeeze())
        return [tuple(elements[3 * i: 3 * i + 3]) for i in range(n)]

    def sample_indices(self, upper_bound: int, n: int):
        """n indices below the power-of-2 upper_bound. Squeezed elements
        equal to p-1 are rejected; otherwise index = low bits of the
        canonical value (twenty-first `Sponge::sample_indices`)."""
        assert upper_bound & (upper_bound - 1) == 0
        indices = []
        pending = []
        while len(indices) < n:
            if not pending:
                pending = list(self.squeeze())
            element = pending.pop(0)
            if element != P - 1:
                indices.append((element & 0xFFFFFFFF) % upper_bound)
        return indices
