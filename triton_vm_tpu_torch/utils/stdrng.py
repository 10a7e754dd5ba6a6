"""rand::StdRng (ChaCha12) reimplementation for prover-randomness parity.

The reference seeds one `StdRng` per randomizer polynomial via byte-wise
little-endian seed offsetting (master_table.rs:631-663; the offset scheme
is `offset_seeds` below) and draws field elements with `rng.random()`
(master_table.rs:429-433).

This module implements the ChaCha12 stream exactly as `rand_chacha`
does: DJB's original variant with a 64-bit block counter in state words
12-13 and a 64-bit stream id (zero for `from_seed`) in words 14-15;
`next_u32` consumes output words sequentially, `next_u64` is
low-word-first. BFieldElement sampling follows twenty-first's
`Distribution<BFieldElement>`: draw a u64, reduce mod p (AUDIT.md item 1
tracks validation against Rust-generated vectors)."""

from __future__ import annotations

import struct

from ..fields.bfe import P

_CONSTANTS = struct.unpack("<4I", b"expand 32-byte k")
_ROUNDS = 12
_MASK = 0xFFFFFFFF


def _rotl(v, n):
    return ((v << n) | (v >> (32 - n))) & _MASK


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 7)


class ChaCha12Rng:
    """rand_chacha::ChaCha12Rng from a 32-byte seed."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = struct.unpack("<8I", seed)
        self._counter = 0  # 64-bit block counter
        self._buf: list[int] = []

    def _block(self) -> list[int]:
        state = list(_CONSTANTS) + list(self._key) + [
            self._counter & _MASK, (self._counter >> 32) & _MASK, 0, 0]
        ws = state[:]
        for _ in range(_ROUNDS // 2):
            _quarter(ws, 0, 4, 8, 12)
            _quarter(ws, 1, 5, 9, 13)
            _quarter(ws, 2, 6, 10, 14)
            _quarter(ws, 3, 7, 11, 15)
            _quarter(ws, 0, 5, 10, 15)
            _quarter(ws, 1, 6, 11, 12)
            _quarter(ws, 2, 7, 8, 13)
            _quarter(ws, 3, 4, 9, 14)
        out = [(w + s) & _MASK for w, s in zip(ws, state)]
        self._counter += 1
        return out

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = self._block()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    # -- field-element sampling (twenty-first Distribution impls) --------

    def random_range_u64_inclusive(self, low: int, high: int) -> int:
        """rand 0.9+ `Rng::random_range(low..=high)` for u64: Canon's
        method (uniform_int.rs `sample_single_inclusive`) — one widening
        multiply, plus one bias-correction draw when the low-order product
        exceeds `range.wrapping_neg()`."""
        range_ = (high - low + 1) & _MASK64
        if range_ == 0:
            return self.next_u64()
        v = self.next_u64() * range_
        result, lo_order = v >> 64, v & _MASK64
        if lo_order > (-range_) & _MASK64:
            new_hi_order = (self.next_u64() * range_) >> 64
            if lo_order + new_hi_order > _MASK64:
                result += 1
        return (low + result) & _MASK64

    def random_bfe(self) -> int:
        """twenty-first `Distribution<BFieldElement>`:
        `rng.random_range(0..=BFieldElement::MAX)` with MAX = P - 1."""
        return self.random_range_u64_inclusive(0, P - 1)

    def random_bfes(self, n: int) -> list[int]:
        return [self.random_bfe() for _ in range(n)]

    def random_xfes(self, n: int) -> list[tuple]:
        flat = self.random_bfes(3 * n)
        return [tuple(flat[3 * i:3 * i + 3]) for i in range(n)]

    def random_u8_array(self, n: int) -> bytes:
        """rand `StandardUniform` for `[u8; N]`: each byte is an
        independent `next_u32() as u8` draw (distr/integer.rs)."""
        return bytes(self.next_u32() & 0xFF for _ in range(n))


_MASK64 = 0xFFFFFFFFFFFFFFFF


# ------------------------------------------------ batched keystream (numpy)

def _chacha12_blocks_batch(keys, counters):
    """Vectorized ChaCha12 blocks: keys (B, 8) uint32, counters (B,)
    uint64 -> (B, 16) uint32 output words. Bit-exact with ChaCha12Rng."""
    import numpy as np

    B = keys.shape[0]
    state = np.empty((B, 16), np.uint32)
    state[:, 0:4] = np.array(_CONSTANTS, np.uint32)
    state[:, 4:12] = keys
    state[:, 12] = (counters & 0xFFFFFFFF).astype(np.uint32)
    state[:, 13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[:, 14:16] = 0
    ws = state.copy()

    def rotl(v, n):
        return (v << np.uint32(n)) | (v >> np.uint32(32 - n))

    def quarter(a, b, c, d):
        ws[:, a] += ws[:, b]
        ws[:, d] = rotl(ws[:, d] ^ ws[:, a], 16)
        ws[:, c] += ws[:, d]
        ws[:, b] = rotl(ws[:, b] ^ ws[:, c], 12)
        ws[:, a] += ws[:, b]
        ws[:, d] = rotl(ws[:, d] ^ ws[:, a], 8)
        ws[:, c] += ws[:, d]
        ws[:, b] = rotl(ws[:, b] ^ ws[:, c], 7)

    with np.errstate(over="ignore"):
        for _ in range(_ROUNDS // 2):
            quarter(0, 4, 8, 12)
            quarter(1, 5, 9, 13)
            quarter(2, 6, 10, 14)
            quarter(3, 7, 11, 15)
            quarter(0, 5, 10, 15)
            quarter(1, 6, 11, 12)
            quarter(2, 7, 8, 13)
            quarter(3, 4, 9, 14)
        return ws + state


def _u64_streams(seeds: list[bytes], num_u64: int):
    """The first `num_u64` u64 keystream words for each 32-byte seed,
    as a (len(seeds), num_u64) object array (exact ints)."""
    import numpy as np

    B = len(seeds)
    m = -(-num_u64 * 2 // 16)  # blocks per key
    keys = np.frombuffer(b"".join(seeds), np.uint32).reshape(B, 8)
    keys_rep = np.repeat(keys, m, axis=0)
    counters = np.tile(np.arange(m, dtype=np.uint64), B)
    blocks = _chacha12_blocks_batch(keys_rep, counters)  # (B*m, 16)
    words = blocks.reshape(B, m * 16).astype(object)
    u64s = words[:, 0::2] | (words[:, 1::2] << 32)  # low word first
    return u64s[:, :num_u64]


# Canon's bias zone for range P: a draw whose first product has its low
# half above it takes the bias-correction branch (a second u64 word)
_BIAS_ZONE = (-P) & _MASK64  # 2^32 - 1


def drbg_bfes_batch(seed: bytes, offsets, n: int):
    """Batched `_drbg_bfes`: one row of n BFEs per offset, drawn exactly
    as `StdRng::from_seed(offset_rng_seed(seed, offset))` + n times
    `rng.random::<BFieldElement>()`. Returns (len(offsets), n) object
    array of ints.

    The vectorized fast path assumes every Canon draw takes the
    bias-correction branch (probability 1 - 2^-32 per draw); rows where
    any draw would not are recomputed with the scalar reference path."""
    import numpy as np

    seeds = offset_seeds(seed, offsets)
    streams = _u64_streams(seeds, 2 * n)
    v = streams[:, 0::2]
    v2 = streams[:, 1::2]
    prod = v * P
    hi, lo = prod >> 64, prod & _MASK64
    biased = lo > _BIAS_ZONE
    hi2 = (v2 * P) >> 64
    overflow = (lo + hi2) > _MASK64
    out = hi + (biased & overflow)
    bad = ~biased.all(axis=1)
    for i in np.nonzero(bad)[0]:
        out[i] = ChaCha12Rng(seeds[int(i)]).random_bfes(n)
    return out


def drbg_xfes_batch(seed: bytes, offsets, n: int):
    """Batched XFE draws: (len(offsets), n, 3) object array."""
    flat = drbg_bfes_batch(seed, offsets, 3 * n)
    return flat.reshape(len(list(offsets)), n, 3)


def offset_seeds(seed: bytes, offsets) -> list[bytes]:
    """The 32-byte seed of each offset's stream (master_table.rs:631-663:
    the seed read as a little-endian integer plus the offset, wrapping)."""
    return [_offset_seed_bytes(seed, o) for o in offsets]


def _offset_seed_bytes(seed: bytes, offset: int) -> bytes:
    total = (int.from_bytes(seed, "little") + offset) % (1 << (8 * len(seed)))
    return total.to_bytes(len(seed), "little")


def seed_from_u64(state: int) -> bytes:
    """rand_core `SeedableRng::seed_from_u64` default implementation:
    PCG32 steps fill the 32-byte seed in 4-byte little-endian chunks."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    out = bytearray()
    for _ in range(8):
        state = (state * mul + inc) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK
        out += struct.pack("<I", x)
    return bytes(out)


def std_rng_seed_from_u64(state: int) -> bytes:
    """`StdRng::seed_from_u64(state).random::<[u8; 32]>()` — the pattern
    the reference's pinned-seed tests use to derive a prover seed
    (proof.rs:212-216, stark.rs:2446-2448)."""
    return ChaCha12Rng(seed_from_u64(state)).random_u8_array(32)
