"""Merkle tree over Tip5 digests with de-duplicated authentication structures.

Replaces `twenty-first`'s `MerkleTree` (`par_new`, `root`,
`authentication_structure`, `MerkleTreeInclusionProof::verify`) as used by
the reference at triton-vm/src/table/master_table.rs:443-453
and stark.rs:1608-1674.

Node indexing: 1-based heap layout — root at 1, leaf i at num_leafs + i,
children of k at 2k / 2k+1. Authentication structures list the needed node
digests in DESCENDING node-index order.

Layer hashing runs batched on the tree's device (ops.tip5_kernel). The
verifier's path checks rebuild each partial tree level by level from a
plan of buffer positions (`_plan`), made on the host from the leaf
indices alone: on a card one K1 pair hash a level over a device node
buffer and one read of the roots, on the CPU the native scalar Tip5 pair
by pair. Parents computed are counted as `merkle hashed nodes` on the
innermost open profiler span.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import tip5_kernel
from ..utils import profiler

ROOT_INDEX = 1
HASHED_NODES = "merkle hashed nodes"


class MerkleTree:
    """The tree lives on its device as a heap-ordered int64 tensor
    (5, 2n - 1): node k (1-based) in column k - 1. Node reads are one
    batched gather; a proof only opens the root and a few thousand
    authentication nodes."""

    def __init__(self, leaf_digests, device="cpu"):
        """leaf_digests: numpy (n, 5) u64, or an int64 tensor (5, n)."""
        from ..ops import gf

        if isinstance(leaf_digests, np.ndarray):
            leaf_digests = gf.from_u64(leaf_digests.T, device)
        n = leaf_digests.shape[-1]
        assert n >= 1 and (n & (n - 1)) == 0, "leaf count must be a power of 2"
        self._flat = tip5_kernel.merkle_flat(leaf_digests)
        self.num_leafs = n
        self._root = None

    @classmethod
    def from_flat(cls, flat, num_leafs: int) -> "MerkleTree":
        """Adopt a precomputed heap-ordered node tensor (5, 2n - 1)."""
        self = cls.__new__(cls)
        self._flat = flat
        self.num_leafs = num_leafs
        self._root = None
        return self

    def _nodes(self, indices) -> list[tuple]:
        """Digests at 1-based heap node indices: one gather + readback."""
        from ..ops import gf

        indices = np.asarray(list(indices), np.int64)
        if indices.size == 0:
            return []
        idx = torch.as_tensor(indices - 1, device=self._flat.device)
        sel = gf.to_u64(self._flat.index_select(1, idx))  # (5, k)
        return [tuple(int(x) for x in sel[:, j]) for j in range(sel.shape[1])]

    def node(self, index: int) -> tuple:
        return self._nodes([index])[0]

    def root(self) -> tuple:
        if self._root is None:
            self._root = self.node(ROOT_INDEX)
        return self._root

    def authentication_structure(self, leaf_indices) -> list[tuple]:
        idxs = auth_structure_node_indices(self.num_leafs, leaf_indices)
        return self._nodes(idxs)


def auth_structure_node_indices(num_leafs: int, leaf_indices) -> list[int]:
    """Node indices revealed for the given leaves, deduplicated, in
    descending order (twenty-first convention)."""
    return _TreePlan(num_leafs, leaf_indices).auth_nodes.tolist()


class _TreePlan:
    """One partial tree's reconstruction in tree-local buffer positions:
    the leaves [0, k) as given, the authentication nodes [k, k + a) in the
    structure's descending order, then each level's parents in ascending
    node order. `levels` holds a (left, right) pair of position arrays a
    level, from the leaves up; `nodes` the node index at every position."""

    def __init__(self, num_leafs: int, leaf_indices):
        idx = np.asarray(list(leaf_indices), np.int64)
        assert ((0 <= idx) & (idx < num_leafs)).all()
        k = idx.size
        leaves = idx + num_leafs
        # where a leaf index repeats, the last digest given wins
        cur, last = np.unique(leaves[::-1], return_index=True)
        cur_pos = k - 1 - last
        # every node at one depth: each level's known nodes are its
        # computed ones and their siblings, the authentication nodes
        path, needs = [cur], []
        while cur.size and cur[0] > ROOT_INDEX:
            needs.append(np.setdiff1d(cur ^ 1, cur))
            cur = np.unique(cur >> 1)
            path.append(cur)
        self.auth_nodes = np.concatenate(
            [need[::-1] for need in needs] or [np.zeros(0, np.int64)])
        self.num_leaves, self.num_auth = k, self.auth_nodes.size
        self.levels = []
        a_off, base = k, k + self.num_auth
        for j, need in enumerate(needs):
            known = np.concatenate([path[j], need])
            pos = np.concatenate([cur_pos,
                                  a_off + np.arange(need.size)[::-1]])
            a_off += need.size
            # the known nodes are exactly both children of every parent
            pos = pos[np.argsort(known)]
            self.levels.append((pos[0::2], pos[1::2]))
            cur_pos = base + np.arange(path[j + 1].size)
            base += path[j + 1].size
        self.root_pos = int(cur_pos[0]) if k else None
        self.nodes = np.concatenate([leaves, self.auth_nodes] + path[1:])


def _plan(trees):
    """A batch of tree plans laid into one node buffer: every tree's leaves
    and authentication nodes first, tree after tree, then step s's parents
    of every tree together (step s: the s-th level above the leaves).
    Returns (input columns, [(left, right) global positions] a step,
    [the root's global position] a tree)."""
    n_in = sum(t.num_leaves + t.num_auth for t in trees)
    n_steps = max(len(t.levels) for t in trees)
    step_sizes = [sum(t.levels[s][0].size for t in trees
                      if s < len(t.levels)) for s in range(n_steps)]
    step_base = n_in + np.cumsum([0] + step_sizes)
    steps = [([], []) for _ in range(n_steps)]
    roots, in_off, filled = [], 0, [0] * n_steps
    for t in trees:
        # tree-local position -> global position
        parts = [in_off + np.arange(t.num_leaves + t.num_auth)]
        in_off += t.num_leaves + t.num_auth
        for s, (lp, _) in enumerate(t.levels):
            parts.append(step_base[s] + filled[s] + np.arange(lp.size))
            filled[s] += lp.size
        remap = np.concatenate(parts)
        for s, (lp, rp) in enumerate(t.levels):
            steps[s][0].append(remap[lp])
            steps[s][1].append(remap[rp])
        roots.append(int(remap[t.root_pos]))
    return n_in, [(np.concatenate(lp), np.concatenate(rp))
                  for lp, rp in steps], roots


def _hash_host(buf: list, steps) -> list:
    """Each step's parents appended to the buffer of digests: the native
    scalar Tip5, pair by pair."""
    from . import tip5

    for lp, rp in steps:
        buf.extend(tuple(tip5.hash_pair(buf[l], buf[r]))
                   for l, r in zip(lp.tolist(), rp.tolist()))
    return buf


def _host_digests(digests) -> list:
    """Digests as tuples of ints: a (5, k) tensor is read column by column."""
    if torch.is_tensor(digests):
        from ..ops import gf

        return [tuple(int(x) for x in d) for d in gf.to_u64(digests).T]
    return [tuple(d) for d in digests]


def _shaped(num_leafs, leaf_indices, leaf_digests, auth_structure):
    """The tree's plan, or False where the structure cannot fit the
    revealed leaves (a count that differs), True where there are none."""
    leaf_indices = list(leaf_indices)
    k = (leaf_digests.shape[1] if torch.is_tensor(leaf_digests)
         else len(leaf_digests))
    if len(leaf_indices) != k:
        return False
    if not leaf_indices:
        return len(auth_structure) == 0
    plan = _TreePlan(num_leafs, leaf_indices)
    return plan if plan.num_auth == len(auth_structure) else False


def partial_tree_nodes(
    num_leafs: int, leaf_indices, leaf_digests, auth_structure
) -> dict | None:
    """All tree nodes recoverable from an authentication structure:
    {node_index: digest}, or None if the structure is malformed. Every
    node on a revealed leaf's root path — and each such node's sibling —
    is present, so per-leaf sibling paths can be read out of the result
    (used by models/recursive_verifier.py to feed `merkle_step`). Hashed
    on the host, whatever the digests' device."""
    plan = _shaped(num_leafs, leaf_indices, leaf_digests, auth_structure)
    if plan is True:
        return {}
    if plan is False:
        return None
    _, steps, _ = _plan([plan])
    buf = _hash_host(_host_digests(leaf_digests)
                     + _host_digests(auth_structure), steps)
    profiler.count(HASHED_NODES, len(buf) - plan.num_leaves - plan.num_auth)
    return dict(zip(plan.nodes.tolist(), buf))


def verify_authentication_structure(
    root: tuple, num_leafs: int, leaf_indices, leaf_digests, auth_structure
) -> bool:
    """MerkleTreeInclusionProof::verify equivalent. `leaf_digests`: a list
    of digests (rebuilt on the host) or a (5, k) int64 tensor, whose
    device decides where the tree is rebuilt."""
    return verify_authentication_structures(
        [(root, num_leafs, leaf_indices, leaf_digests, auth_structure)])[0]


def verify_authentication_structures(trees, device="cpu") -> list[bool]:
    """Several path checks as one batch: trees is a list of (root,
    num_leafs, leaf_indices, leaf_digests, auth_structure); the device is
    `device`, or that of leaf digests given as a tensor. On a CUDA device
    every tree is rebuilt in one node buffer, one K1 launch a step for all
    trees, and the roots are read back once; on the CPU with the scalar
    Tip5. A verdict a tree."""
    for t in trees:
        if torch.is_tensor(t[3]):
            device = t[3].device
    device = torch.device(device)
    verdicts = [_shaped(*t[1:]) for t in trees]
    todo = [j for j, v in enumerate(verdicts) if not isinstance(v, bool)]
    if not todo:
        return verdicts
    batch = [(trees[j], verdicts[j]) for j in todo]
    n_in, steps, roots = _plan([plan for _, plan in batch])
    profiler.count(HASHED_NODES, sum(lp.size for lp, _ in steps))
    if device.type == "cuda":
        got = _rebuild_on_device(batch, n_in, steps, roots, device)
    else:
        buf = []
        for t, _ in batch:
            buf += _host_digests(t[3]) + _host_digests(t[4])
        buf = _hash_host(buf, steps)
        got = [buf[r] for r in roots]
    for j, root in zip(todo, got):
        verdicts[j] = (tuple(int(x) for x in root)
                       == tuple(int(x) for x in trees[j][0]))
    return verdicts


def _rebuild_on_device(batch, n_in, steps, roots, device) -> list:
    """The batch's roots rebuilt on the card: the inputs uploaded once
    (leaf digests already on the card copied in place), every step one
    gather of its (left, right) columns, one `hash_pairs` and a write, and
    one read of all roots."""
    from ..ops import gf

    n_out = sum(lp.size for lp, _ in steps)
    host = np.zeros((n_in, 5), np.uint64)
    on_card, off = [], 0
    for t, plan in batch:
        leaves, auth = t[3], t[4]
        if torch.is_tensor(leaves):
            on_card.append((off, leaves))
        elif plan.num_leaves:
            host[off:off + plan.num_leaves] = np.asarray(leaves, np.uint64)
        off += plan.num_leaves
        if plan.num_auth:
            host[off:off + plan.num_auth] = np.asarray(auth, np.uint64)
        off += plan.num_auth
    buf = torch.empty((5, n_in + n_out), dtype=torch.int64, device=device)
    buf[:, :n_in] = gf.from_u64(host.T, device)
    for off, leaves in on_card:
        buf[:, off:off + leaves.shape[1]] = leaves
    idx = torch.as_tensor(np.concatenate(
        [np.concatenate(s) for s in steps] + [np.asarray(roots, np.int64)]),
        device=device)
    at, out = 0, n_in
    for lp, _ in steps:
        m = lp.size
        both = buf.index_select(1, idx[at:at + 2 * m])
        buf[:, out:out + m] = tip5_kernel.hash_pairs(both[:, :m], both[:, m:])
        at, out = at + 2 * m, out + m
    return list(gf.to_u64(buf.index_select(1, idx[at:])).T)
