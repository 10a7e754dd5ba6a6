"""The port's rand::StdRng (ChaCha12): the keystream, the batched numpy
draws of `utils/stdrng`, and the randomizer wrapper `ops/stdrng_cuda`
(its layouts, its exact-row path) on the CPU, all against the scalar
`ChaCha12Rng`; one case marked `cuda` holds the kernel to the plain
version on a card. This file imports nothing of JAX, so on a machine
without it run `python -m pytest --noconftest tests/test_torch_stdrng.py`.
"""

import numpy as np
import pytest
import torch

from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf, stdrng_cuda
from triton_vm_tpu_torch.utils import profiler, stdrng
from triton_vm_tpu_torch.utils.stdrng import ChaCha12Rng

SEED = bytes(range(32))


def _scalar_rows(seed, offsets, total):
    return np.array([ChaCha12Rng(s).random_bfes(total)
                     for s in stdrng.offset_seeds(seed, offsets)],
                    np.uint64).reshape(len(offsets), total)


def test_chacha12_zero_key_ecrypt_vector():
    r = ChaCha12Rng(bytes(32))
    ks = b"".join(r.next_u32().to_bytes(4, "little") for _ in range(8))
    assert ks.hex() == ("9bf49a6a0755f953811fce125f2683d5"
                        "0429c3bb49e074147e0089a52eae155f")


def test_next_u64_is_low_word_first():
    a, b = ChaCha12Rng(bytes(32)), ChaCha12Rng(bytes(32))
    lo, hi = b.next_u32(), b.next_u32()
    assert a.next_u64() == lo | (hi << 32)


def test_rand_stdrng_value_stability_vector():
    """rand's rngs/std.rs `test_stdrng_construction` known answer."""
    seed = bytes([1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0]
                 + [0] * 16)
    assert ChaCha12Rng(seed).next_u64() == 10719222850664546238


def test_offset_seeds_are_wrapping_little_endian_sums():
    seed = bytes([0xFF] * 4 + [0] * 28)
    assert stdrng.offset_seeds(seed, [1])[0][:5] == bytes([0, 0, 0, 0, 1])
    top = bytes([0xFF] * 32)
    assert stdrng.offset_seeds(top, [0, 1, 2]) == [top, bytes(32),
                                                   bytes([1]) + bytes(31)]


@pytest.mark.parametrize("offsets,n", [
    (range(5), 17),           # 17 draws: a last ChaCha block of one draw
    ([0, 3, 470], 9),
    ([379, 471], 1),
    (range(2), 4 * 16 + 2),   # across a block boundary, then half a block
])
def test_batched_draws_match_scalar(offsets, n):
    offsets = list(offsets)
    for seed in (SEED, bytes(reversed(range(32))), bytes([0xFF] * 32)):
        want = _scalar_rows(seed, offsets, n)
        got = stdrng.drbg_bfes_batch(seed, offsets, n).astype(np.uint64)
        assert np.array_equal(got, want)
        xfes = stdrng.drbg_xfes_batch(seed, offsets, n).astype(np.uint64)
        assert np.array_equal(xfes.reshape(len(offsets), 3 * n),
                              _scalar_rows(seed, offsets, 3 * n))
    assert (got < P).all()


# the prover's four calls, cut to a small padded height: main (379 rows of
# ntr BFEs), aux (91 rows of ntr XFEs), the batch randomizer (one row of h
# XFEs) and the quotient randomizer (one row of n_qr XFEs)
LAYOUTS = {"main": (range(379), 7, False),
           "aux": (range(379, 470), 7, True),
           "batch": ([470], 64, True),
           "quotient": ([471], 40, True)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_wrapper_layouts_on_the_cpu(layout):
    offsets, n, xfe = LAYOUTS[layout]
    offsets = list(offsets)
    got = stdrng_cuda.draw(SEED, offsets, n, xfe=xfe, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    want = _scalar_rows(SEED, offsets, 3 * n if xfe else n)
    if xfe:
        # draw 3i + k of row b at [b, k, i]: row b is an XFE tensor (3, n)
        assert got.shape == (len(offsets), 3, n)
        want = want.reshape(len(offsets), n, 3).transpose(0, 2, 1)
    else:
        assert got.shape == (len(offsets), n)
    assert np.array_equal(gf.to_u64(got), want)


def test_exact_row_path_forced_by_the_bias_flag(monkeypatch):
    """With Canon's bias zone widened to half of all u64 values, most rows
    hold a draw that the vectorized path would take outside the bias
    branch; each such row must be redrawn exactly, equal to the scalar
    draws."""
    offsets, n = list(range(12)), 3
    seeds = stdrng.offset_seeds(SEED, offsets)
    monkeypatch.setattr(stdrng, "_BIAS_ZONE", 1 << 63)
    lo = (stdrng._u64_streams(seeds, 2 * n)[:, 0::2] * P) & ((1 << 64) - 1)
    flagged = int((lo <= stdrng._BIAS_ZONE).any(axis=1).sum())
    assert 0 < flagged < len(offsets)
    want = _scalar_rows(SEED, offsets, n)
    assert np.array_equal(
        stdrng.drbg_bfes_batch(SEED, offsets, n).astype(np.uint64), want)
    got = stdrng_cuda.draw(SEED, offsets, n, device="cpu")
    assert np.array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("xfe", [False, True])
def test_settle_redraws_the_flagged_rows_and_counts(xfe):
    """The host half of a card call: rows the kernel flagged (here made
    wrong on purpose) are redrawn exactly; the draws and the redrawn rows
    are counted in an open profiler session."""
    offsets, n = list(range(379, 385)), 5
    seeds = stdrng.offset_seeds(SEED, offsets)
    want = stdrng_cuda.draw_plain(SEED, offsets, n, xfe)
    out = want.clone()
    out[1] = 7
    out[4] = 0
    flags = torch.tensor([0, 1, 0, 0, 1, 0])
    profiler.start("settle")
    try:
        got = stdrng_cuda.settle(out, flags, seeds, n, xfe)
    finally:
        prof = profiler.finish()
    assert torch.equal(got, want)
    total = 3 * n if xfe else n
    assert prof.counts[stdrng_cuda.DRAWS] == len(offsets) * total
    assert prof.counts[stdrng_cuda.EXACT_ROWS] == 2


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    # the main path's shapes at padded height 2^16: main, aux, the batch
    # randomizer, the quotient randomizer (ntr 240, n_qr 1205)
    for offsets, n, xfe in [(range(379), 240, False),
                            (range(379, 470), 240, True),
                            ([470], 1 << 16, True), ([471], 1205, True),
                            (range(3), 1, False), ([5], 2, True)]:
        offsets = list(offsets)
        for seed in (SEED, bytes([0xFF] * 32)):
            before = stdrng_cuda.launches["chacha12_bfe"]
            got = stdrng_cuda.draw(seed, offsets, n, xfe=xfe, device=dev)
            assert stdrng_cuda.launches["chacha12_bfe"] == before + 1
            want = stdrng_cuda.draw_plain(seed, offsets, n, xfe, dev)
            assert got.device.type == "cuda"
            assert torch.equal(got, want)
