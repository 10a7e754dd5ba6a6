"""Merkle inclusion proofs over Tip5 digests (twenty-first's
`MerkleTreeInclusionProof::verify`, as triton-vm/src/stark.rs:1608-1674
uses it), checked level by level with the batched hash.

Node indexing: 1-based heap layout, root at 1, leaf i at num_leafs + i,
children of k at 2k and 2k + 1. An authentication structure lists the
node digests the leaves need, deduplicated, in descending node index.
"""

from __future__ import annotations

import numpy as np

from . import tip5

ROOT_INDEX = 1


def auth_structure_node_indices(num_leafs: int, leaf_indices) -> list[int]:
    needed, computable = set(), set()
    for leaf_index in leaf_indices:
        if not 0 <= leaf_index < num_leafs:
            raise ValueError("leaf index out of range")
        node = leaf_index + num_leafs
        while node > ROOT_INDEX:
            computable.add(node)
            needed.add(node ^ 1)
            node //= 2
    return sorted(needed - computable, reverse=True)


def verify(root, num_leafs: int, leaf_indices, leaf_digests,
           auth_structure) -> bool:
    """Whether the leaves' digests, with the structure's nodes, hash up to
    `root`."""
    leaf_indices = list(leaf_indices)
    if len(leaf_indices) != len(leaf_digests):
        return False
    if not leaf_indices:
        return not auth_structure
    needed = auth_structure_node_indices(num_leafs, leaf_indices)
    if len(needed) != len(auth_structure):
        return False
    nodes = {i + num_leafs: tuple(int(x) for x in d)
             for i, d in zip(leaf_indices, leaf_digests)}
    nodes.update({i: tuple(int(x) for x in d)
                  for i, d in zip(needed, auth_structure)})
    level = sorted({i // 2 for i in nodes if i >= num_leafs})
    while level and level[0] >= ROOT_INDEX:
        left = np.array([nodes[2 * k] for k in level], dtype=np.uint64)
        right = np.array([nodes[2 * k + 1] for k in level], dtype=np.uint64)
        for k, d in zip(level, tip5.hash_pairs(left, right).tolist()):
            nodes[k] = tuple(d)
        if level == [ROOT_INDEX]:
            break
        level = sorted({k // 2 for k in level})
    return nodes.get(ROOT_INDEX) == tuple(int(x) for x in root)


def root_of(leaf_digests) -> tuple:
    """The root of the tree over (n, 5) leaf digests, n a power of two."""
    layer = np.asarray(leaf_digests, dtype=np.uint64)
    while layer.shape[0] > 1:
        layer = tip5.hash_pairs(layer[0::2], layer[1::2])
    return tuple(int(x) for x in layer[0])
