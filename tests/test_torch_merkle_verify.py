"""The verifier's Merkle path checks (triton_vm_tpu_torch.crypto.merkle:
`verify_authentication_structure`, `verify_authentication_structures`,
`partial_tree_nodes`, `auth_structure_node_indices`) against the JAX
package's functions of the same names: trees of 2^1 to 2^12 leaves, index
sets of one leaf, every leaf, adjacent siblings, repeated indices with
differing digests and none, each as given and tampered (a word of an
authentication node, a leaf digest, the root, one authentication node too
many or too few). The card's level-by-level rebuild runs here through
K1's plain version on CPU tensors; the `merkle hashed nodes` counter."""

import functools

import numpy as np
import pytest
import torch

from triton_vm_tpu.crypto import merkle as jmerkle
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu_torch.crypto import merkle
from triton_vm_tpu_torch.ops import gf
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)

KINDS = ["one", "all", "siblings", "duplicates", "empty"]
TAMPERS = ["auth word", "leaf", "root", "auth extra", "auth missing"]


@functools.lru_cache(maxsize=None)
def _tree(log2_n, seed):
    """Leaf digests (n, 5) u64 and the port's tree over them (held equal to
    the JAX package's in test_torch_tip5.py)."""
    leaves = np.random.default_rng(seed).integers(
        0, P, (1 << log2_n, 5), dtype=np.uint64)
    return leaves, merkle.MerkleTree(leaves)


def _digest(row):
    return tuple(int(x) for x in row)


def _opening(log2_n, kind, seed=0):
    """(root, n, indices, leaf digests, authentication structure) for one
    kind of index set. `duplicates` repeats two leaves, the earlier copy
    with a wrong digest: the last digest given is the one that counts."""
    n = 1 << log2_n
    leaves, tree = _tree(log2_n, 1000 * log2_n + seed)
    rng = np.random.default_rng(seed)
    if kind == "one":
        idx = [int(rng.integers(0, n))]
    elif kind == "all":
        idx = [int(i) for i in rng.permutation(n)]
    elif kind == "siblings":
        a = int(rng.integers(0, n // 2)) * 2
        idx = [a + 1, a] + [int(i) for i in rng.integers(0, n, 3)]
    elif kind == "duplicates":
        idx = [int(i) for i in rng.integers(0, n, 4)]
        idx = idx + [idx[0], idx[2]]
    else:
        idx = []
    digests = [_digest(leaves[i]) for i in idx]
    if kind == "duplicates":
        digests[0] = (digests[0][0] ^ 1,) + digests[0][1:]
        digests[2] = _digest(leaves[(idx[2] + 1) % n])
    return tree.root(), n, idx, digests, tree.authentication_structure(idx)


def _tamper(opening, how):
    root, n, idx, digests, auth = opening
    digests, auth = list(digests), list(auth)
    if how == "auth word":
        auth[len(auth) // 2] = ((auth[len(auth) // 2][0] + 1) % P,) + tuple(
            auth[len(auth) // 2][1:])
    elif how == "leaf":
        digests[-1] = digests[-1][:4] + ((digests[-1][4] + 7) % P,)
    elif how == "root":
        root = (root[0],) + ((root[1] + 1) % P,) + tuple(root[2:])
    elif how == "auth extra":
        auth.append(tuple(range(5)))
    else:
        auth.pop()
    return root, n, idx, digests, auth


def _same_as_jax(opening):
    root, n, idx, digests, auth = opening
    want = jmerkle.verify_authentication_structure(root, n, idx, digests,
                                                   auth)
    assert merkle.verify_authentication_structure(
        root, n, idx, digests, auth) == want
    assert merkle.partial_tree_nodes(n, idx, digests, auth) == \
        jmerkle.partial_tree_nodes(n, idx, digests, auth)
    return want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("log2_n", range(1, 13))
def test_opening_judged_as_jax_judges_it(log2_n, kind):
    opening = _opening(log2_n, kind)
    _, n, idx, _, _ = opening
    assert merkle.auth_structure_node_indices(n, idx) == \
        jmerkle.auth_structure_node_indices(n, idx)
    assert _same_as_jax(opening)


def _tamper_cases():
    for log2_n in (1, 2, 5, 9, 12):
        for kind in KINDS[:4]:
            for how in TAMPERS:
                if how in ("auth word", "auth missing") and (
                        kind == "all" or (kind != "one" and log2_n <= 2)):
                    continue  # every leaf revealed: no authentication node
                yield log2_n, kind, how


@pytest.mark.parametrize("log2_n, kind, how", list(_tamper_cases()))
def test_tampered_opening_rejected_as_jax_rejects_it(log2_n, kind, how):
    assert not _same_as_jax(_tamper(_opening(log2_n, kind, seed=1), how))


@pytest.mark.parametrize("how", ["auth extra", "leaf count"])
def test_empty_opening_with_stray_items(how):
    root, n, idx, digests, auth = _opening(4, "empty")
    if how == "auth extra":
        auth = [tuple(range(5))]
    else:
        digests = [tuple(range(5))]
    assert not _same_as_jax((root, n, idx, digests, auth))


def test_single_leaf_tree_is_its_own_root():
    leaves, tree = _tree(0, 3)
    digest = _digest(leaves[0])
    assert tree.root() == digest
    assert merkle.verify_authentication_structure(digest, 1, [0, 0],
                                                  [digest, digest], [])
    assert merkle.partial_tree_nodes(1, [0], [digest], []) == {1: digest}


def test_leaf_index_outside_the_tree_raises():
    with pytest.raises(AssertionError):
        merkle.verify_authentication_structure((0,) * 5, 8, [8],
                                               [(0,) * 5], [])


def _batch(seed):
    """Openings of trees of 2^0 to 2^9 leaves, a third of them tampered."""
    out = []
    for j, log2_n in enumerate(range(10)):
        kind = ("one", "siblings", "duplicates", "all")[j % 4]
        opening = _opening(log2_n, kind, seed)
        if j % 3 == 2:
            opening = _tamper(opening, ("leaf", "root", "auth word")[j // 3])
        out.append(opening)
    return out


@pytest.mark.parametrize("leaves_as", ["lists", "tensors"])
def test_batched_verdicts_equal_jax_one_tree_at_a_time(leaves_as):
    batch = _batch(5)
    want = [jmerkle.verify_authentication_structure(*o) for o in batch]
    assert True in want and False in want
    if leaves_as == "tensors":
        batch = [(r, n, i, gf.from_u64(np.asarray(d, np.uint64).T), a)
                 for r, n, i, d, a in batch]
    assert merkle.verify_authentication_structures(batch, "cpu") == want


def test_card_rebuild_equals_the_roots_through_plain_k1():
    """`_rebuild_on_device` (the card's route: one node buffer, one
    hash_pairs a step over every tree, one read of the roots) on CPU
    tensors, where hash_pairs runs K1's plain version: each tree's
    rebuilt root is the root the JAX package's partial tree reaches,
    leaves given as lists or as tensors already on the device."""
    batch = [o for o in _batch(7) if o[2]]
    plans = [merkle._TreePlan(n, idx) for _, n, idx, _, _ in batch]
    n_in, steps, roots = merkle._plan(plans)
    cpu = torch.device("cpu")
    for as_tensor in (False, True):
        items = [((r, n, i, gf.from_u64(np.asarray(d, np.uint64).T)
                   if as_tensor and j % 2 else d, a), p)
                 for j, ((r, n, i, d, a), p) in enumerate(zip(batch, plans))]
        got = merkle._rebuild_on_device(items, n_in, steps, roots, cpu)
        for g, (_, n, idx, d, a) in zip(got, batch):
            ref = jmerkle.partial_tree_nodes(n, idx, d, a)
            assert _digest(g) == tuple(ref[merkle.ROOT_INDEX])


def test_hashed_nodes_counted_on_the_innermost_span():
    """Each tree counts the parents it computes: the JAX package's partial
    tree less the leaves and the authentication nodes."""
    batch = [o for o in _batch(9) if o[2]]
    want = 0
    for _, n, idx, d, a in batch:
        want += len(jmerkle.partial_tree_nodes(n, idx, d, a)) - \
            len(set(idx)) - len(a)
    before = profiler.totals().count(merkle.HASHED_NODES)
    profiler.start("merkle")
    try:
        with profiler.span("check"):
            merkle.verify_authentication_structures(batch, "cpu")
    finally:
        profile = profiler.finish()
    (interval,) = profile.intervals()
    assert interval.counts == {merkle.HASHED_NODES: want}
    assert profiler.totals().count(merkle.HASHED_NODES) - before == want
