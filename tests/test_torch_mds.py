"""The MDS layer of the port's Tip5 (triton_vm_tpu_torch.ops.tip5_cuda:
`_mds_half`, `_mds`; csrc/tip5.cu computes the same circulant of the
32-bit halves on the FP64 pipe): against the direct circulant in Python
integers at random and worst-case inputs, the worst case's room in a
double's significand, and the plain permutation at the same worst cases
against the JAX package's Pallas kernel (interpret mode) and its scalar
oracle."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.crypto import tip5
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import tip5_pallas
from triton_vm_tpu_torch.ops import gf, tip5_cuda

torch.set_num_threads(2)

C = tip5.MDS_MATRIX_FIRST_COLUMN
HALF = 2**32 - 1


def _circulant(x):
    """16 x 16 circulant product in Python integers, per column of x."""
    return [[sum(C[k] * int(x[(i - k) % 16][b]) for k in range(16))
             for b in range(len(x[0]))] for i in range(16)]


HALVES = {
    "every half 2^32-1": [HALF] * 16,
    "alternating 0, 2^32-1": [0, HALF] * 8,
    "alternating 2^32-1, 0": [HALF, 0] * 8,
    "zero": [0] * 16,
}


@pytest.mark.parametrize("case", sorted(HALVES) + ["random"])
def test_mds_half_matches_direct_circulant(case):
    if case == "random":
        x = np.random.default_rng(3).integers(0, 2**32, (16, 8),
                                              dtype=np.int64)
    else:
        x = np.array([HALVES[case]], dtype=np.int64).T
    got = tip5_cuda._mds_half(torch.from_numpy(x)).tolist()
    assert got == _circulant(x.tolist())


def test_mds_half_worst_case_fits_a_double():
    """Halves are below 2^32 and c_k >= 0, so every partial sum lies in
    [0, (2^32 - 1) * sum(c)], below 2^52: exact in a double (53-bit
    significand) whatever the order of the FMAs."""
    worst = HALF * sum(C)
    assert worst < 2**52
    x = torch.full((16, 1), HALF, dtype=torch.int64)
    assert tip5_cuda._mds_half(x).flatten().tolist() == [worst] * 16


def _words(cols):
    return np.array(cols, dtype=np.uint64).T.copy()


@pytest.mark.parametrize("case", ["every half 2^32-1", "alternating",
                                  "p-1", "random"])
def test_plain_mds_matches_direct_mod_p(case):
    """`_mds` reduces 16 * out / 16 to the field. Its inputs inside the
    kernel are any u64 representatives, so words up to 2^64 - 1 count."""
    cols = {"every half 2^32-1": [[2**64 - 1] * 16],
            "alternating": [[0, 2**64 - 1] * 8, [2**64 - 1, 0] * 8],
            "p-1": [[P - 1] * 16],
            "random": np.random.default_rng(4).integers(
                0, 2**64, (6, 16), dtype=np.uint64).tolist()}[case]
    s = _words(cols)
    got = gf.to_u64(tip5_cuda._mds(gf.from_u64(s)))
    want = [[v % P for v in row] for row in _circulant(s.astype(object))]
    assert got.tolist() == want


WORST_STATES = {
    "p-1": [P - 1] * 16,
    "low half 2^32-1": [2**32 - 1] * 16,
    "alternating 0, p-1": [0, P - 1] * 8,
    "alternating p-1, 0": [P - 1, 0] * 8,
    "alternating 0, 2^32-1": [0, 2**32 - 1] * 8,
}


@pytest.mark.parametrize("name", sorted(WORST_STATES))
def test_plain_permutation_worst_cases_match_jax(name):
    s = _words([WORST_STATES[name]])
    got = gf.to_u64(tip5_cuda.permutation_plain(gf.from_u64(s)))
    want = jgf.to_u64(tip5_pallas.permutation(jgf.from_u64(s)))
    assert np.array_equal(got, want)
    assert [int(v) for v in got[:, 0]] == tip5.permutation_python(
        WORST_STATES[name])
