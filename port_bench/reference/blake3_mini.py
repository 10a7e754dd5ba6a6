"""Minimal single-block Blake3 — only what Tip5 round-constant derivation
needs (hashing 5-byte inputs; see tips/tip-0005/tip-0005.md "Remaining
Specifications"). Implements the full compression function per the public
Blake3 spec; inputs must fit in one 64-byte block of one chunk.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
ROOT = 8

_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(v, a, b, c, d, mx, my):
    v[a] = (v[a] + v[b] + mx) & _M32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + my) & _M32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, block_words, counter, block_len, flags):
    v = list(h) + list(IV[:4]) + [
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[i] for i in MSG_PERMUTATION]
    return [(v[i] ^ v[i + 8]) & _M32 for i in range(8)]


def blake3_digest16(data: bytes) -> bytes:
    """First 16 bytes of the Blake3 hash of a short (<=64 byte) input."""
    assert len(data) <= 64, "single-block mini-Blake3 only"
    block = data + b"\x00" * (64 - len(data))
    words = struct.unpack("<16I", block)
    out = _compress(IV, words, 0, len(data), CHUNK_START | CHUNK_END | ROOT)
    return struct.pack("<4I", *out[:4])
