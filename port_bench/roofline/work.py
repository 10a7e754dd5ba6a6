"""The operations and bytes each of the port's kernels K1-K4 needs for a
call, and the least time the card could take for it.

Frozen copies, so that a later change to the port cannot move the
yardstick:
  K1, K2  chip_smoke.py:296-308 and :524, :594 (PR 3's count): 7040
          32-bit integer multiplies a Tip5 permutation (per round the 48
          products of the x^7 chains, 4 partial products each, and the
          256 MDS taps on 2 halves, 2 each); K1 reads and writes 16 words
          a state, K2 reads each row once and writes 5 words, running
          ceil((n + 1) / 10) permutations a row of n words.
  K3      ops/quotient_cuda.py:395-426 (`work`): the main and aux columns
          the row tape reads plus its 3 output words a row, 8 bytes each;
          the tape's Goldilocks products plus log2(h) + 11 for the point,
          the zerofiers and three inverses, 8 int32 multiplies a product.
          The tape's counts (652 words, 10992 products a row) are those of
          `air/compile.quotient_row_tape()` at the port's commit 11c701f.
  K4      ops/ntt_cuda.py:345-354 (`work`): each row's n_in words read and
          `length` written, 8 bytes each; length/2 log2(length) butterfly
          products a row plus one a scaled word, 8 int32 multiplies each.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
INT32_OPS_PER_PERMUTATION = 5 * (48 * 4 * 2 + 256 * 2 * 2)
INT32_OPS_PER_PRODUCT = 8
RATE = 10
K3_WORDS_PER_ROW = 652
K3_TAPE_PRODUCTS_PER_ROW = 10992


def k1(batch: int) -> tuple[int, int]:
    """(bytes, int32 multiplies) of `batch` permutations."""
    return 2 * 16 * 8 * batch, INT32_OPS_PER_PERMUTATION * batch


def k2(rows: int, width: int) -> tuple[int, int]:
    """(bytes, int32 multiplies) of the sponge of `rows` rows of `width`."""
    perms = rows * ((width + RATE) // RATE)
    return 8 * rows * (width + 5), INT32_OPS_PER_PERMUTATION * perms


def k3(rows: int, trace_len: int) -> tuple[int, int]:
    """(bytes, int32 multiplies) of the quotient at `rows` points."""
    products = K3_TAPE_PRODUCTS_PER_ROW + trace_len.bit_length() + 10
    return 8 * K3_WORDS_PER_ROW * rows, INT32_OPS_PER_PRODUCT * products * rows


def k4(rows: int, n_in: int, length: int,
       scaled_words: int = 0) -> tuple[int, int]:
    """(bytes, int32 multiplies) of a transform of `rows` rows."""
    products = length // 2 * (length.bit_length() - 1) + scaled_words
    return 8 * rows * (n_in + length), INT32_OPS_PER_PRODUCT * rows * products


WORK = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}


def bound_s(kernel: str, shape: dict) -> float:
    """The least seconds the card could take for one call: the larger of
    its bytes over HBM bandwidth and its multiplies over the integer
    pipes' peak."""
    nbytes, ops = WORK[kernel](**shape)
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["int32_mul_per_s"])
