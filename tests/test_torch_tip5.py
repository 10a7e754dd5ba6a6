"""The port's Tip5 (triton_vm_tpu_torch.ops.tip5_cuda / tip5_kernel,
crypto.merkle): the plain torch versions of the two CUDA kernels against
the JAX package's Pallas kernels run in interpret mode and against the
scalar host oracles, and the Merkle tree against the JAX package's.

The CUDA kernels themselves run only on a card: test_torch_cuda.py holds
each against its plain version there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_vm_tpu.crypto import merkle as jmerkle
from triton_vm_tpu.crypto import tip5
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import tip5_pallas
from triton_vm_tpu_torch.crypto import merkle
from triton_vm_tpu_torch.ops import gf, tip5_cuda, tip5_kernel

torch.set_num_threads(2)

CU_SOURCE = (Path(tip5_cuda.__file__).resolve().parent.parent / "csrc"
             / "tip5.cu").read_text()


def _states(seed, b):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, P, (16, b), dtype=np.uint64)
    s[:, 0] = [0, 1, P - 1, 2**32, 2**63, P - 2**32, 2**32 - 1, P - 2,
               0, 0, 1, 1, P - 1, P - 1, 2**63 - 1, 5]
    return s


def test_plain_permutation_matches_pallas_interpret():
    """A ragged batch (130 states: the kernel pads its lanes to 1024)."""
    s = _states(130, 130)
    got = gf.to_u64(tip5_cuda.permutation_plain(gf.from_u64(s)))
    want = jgf.to_u64(tip5_pallas.permutation(jgf.from_u64(s)))
    assert np.array_equal(got, want)


def test_plain_permutation_matches_host_oracle():
    s = _states(3, 6)
    got = gf.to_u64(tip5_kernel.permutation(gf.from_u64(s)))
    for j in range(s.shape[1]):
        assert ([int(x) for x in got[:, j]]
                == tip5.permutation_python([int(x) for x in s[:, j]]))


def _rows(seed, b, n):
    return np.random.default_rng(seed).integers(0, P, (b, n), dtype=np.uint64)


def test_sponge_reads_strided_row_views():
    """Rows of a column-major block, strided as the commit stage reads an
    LDE, hash like their contiguous copy."""
    cols = gf.from_u64(_rows(9, 17, 33))        # (n=17, B=33) column-major
    view = cols.T[::2]                           # (17, 17) strides (2, 33)
    assert view.stride() == (2, 33)
    assert torch.equal(tip5_kernel.sponge_absorb_rows(view),
                       tip5_kernel.sponge_absorb_rows(view.contiguous()))


@pytest.mark.parametrize("fn", ["permutation", "sponge_absorb_rows"])
def test_wrappers_refuse_non_cuda_non_cpu_tensors(fn):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, never sent to the plain version."""
    t = torch.empty((16, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tip5_cuda, fn)(t)


def test_kernel_source_constants_match_tip5():
    """The literal tables of csrc/tip5.cu are tip5.py's constants."""
    mds = re.search(r"kMds\[kState\] = \{(.*?)\};", CU_SOURCE, re.S).group(1)
    assert [int(x) for x in re.findall(r"\d+", mds)] == list(
        tip5.MDS_MATRIX_FIRST_COLUMN)
    rc = re.search(r"kRoundConstants\[kRounds \* kState\] = \{(.*?)\};",
                   CU_SOURCE, re.S).group(1)
    assert [int(x, 16) for x in re.findall(r"0x([0-9A-F]+)ull", rc)] == list(
        tip5.ROUND_CONSTANTS)


@pytest.mark.parametrize("n", [1, 2, 64])
def test_merkle_root_and_auth_structure_match_jax(n):
    leaves = _rows(n + 40, n, 5)
    tree = merkle.MerkleTree(leaves)
    ref = jmerkle.MerkleTree(leaves)
    assert tree.root() == ref.root()
    for idx in ([0], [n - 1], sorted({0, n // 2, n - 1, n // 3})):
        assert (tree.authentication_structure(idx)
                == ref.authentication_structure(idx))
    assert tree.node(2 * n - 1) == tuple(int(x) for x in leaves[n - 1])


def test_commit_rows_heap_matches_jax_merkle():
    rows = _rows(50, 32, 15)
    digests, heap = tip5_kernel.commit_rows(gf.from_u64(rows))
    tree = merkle.MerkleTree.from_flat(heap, 32)
    ref = jmerkle.MerkleTree(
        np.array([tip5.hash_varlen([int(x) for x in r]) for r in rows],
                 np.uint64))
    assert tree.root() == ref.root()
    assert tree.authentication_structure([3, 17]) == \
        ref.authentication_structure([3, 17])
