"""The prover's hot paths sharded over a mesh of torch devices.

The counterpart of `triton_vm_tpu.parallel.mesh`, which turns the
reference's rayon parallelism into mesh axes (SURVEY.md §2.5):

- P1/P2 (stark.rs:867-878,992-1003 / master_table.rs:279-315):
  column-parallel interpolation and LDE; columns sharded over the mesh,
  each shard transforms its block, no exchange. The column axis is padded
  with zero columns to a multiple of the mesh.
- P3 (master_table.rs:455-503): row-parallel Tip5 row hashing. The
  cols->rows reshard is one all-to-all; each shard's K2 launch hashes
  its block of L / D rows, read column-major as received, and its K1
  launches fold that block into a subtree; the top log2(D) layers are
  hashed on the lead device.
- P4 (master_table.rs:1302-1359): row-parallel quotient evaluation; the
  AIR tapes run on each shard's block of rows, plus a halo of the next
  shard's first rows for the transition constraints' next row.
- P7 (stark.rs:611-626): column reductions (out-of-domain rows, the
  weighted column sum) on each shard's columns; the partial sums meet on
  the lead device, where modular addition makes their order irrelevant.

Every function takes an explicit `sharding.Mesh` and runs each shard's
work on its device; on a CPU mesh all shards are on the CPU, which is
how the tests run. Pad columns never reach a digest: they are dropped
before the rows are exchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gf, kernels, ntt, quotient_cuda, tip5_kernel
from .sharding import Mesh, Sharded, all_to_all, gather, place, replicate


def default_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of n shards (by default one per visible card, or one for a
    CPU device) starting at `device` (sharding.place)."""
    device = torch.device(device)
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
    return place(n_devices, device)


def shard_columns(mesh: Mesh, cols) -> Sharded:
    """Columns (nc, ...) split over the mesh along axis 0, which is padded
    with zero columns to a multiple of mesh.size (the JAX prover's
    prover.py:373-374,421-422); only a part that holds pads is copied
    where it stays on the same device."""
    nc = cols.shape[0]
    s = -(-nc // mesh.size)
    parts = []
    for i, dev in enumerate(mesh.devices):
        real = max(0, min(s, nc - i * s))
        part = cols[min(i * s, nc):min(i * s, nc) + real].to(dev)
        if real < s:
            pad = torch.zeros((s - real,) + tuple(cols.shape[1:]),
                              dtype=cols.dtype, device=dev)
            part = torch.cat([part, pad])
        parts.append(part)
    return Sharded(mesh, parts, 0, nc)


def sharded_lde(mesh: Mesh, cols, expansion: int, in_offset: int = 1,
                out_offset: int = 7) -> Sharded:
    """P1/P2: column-parallel low-degree extension of cols (nc, h) (or
    (nc, 3, h)), column-sharded (`shard_columns`) -> (nc, h * expansion),
    column-sharded, pad columns included."""
    return shard_columns(mesh, cols).map(
        lambda p: ntt.lde(p, expansion, in_offset, out_offset))


def sharded_commit(mesh: Mesh, cols, rand, trace_dom, eval_dom):
    """P1/P2 for the commit stage: `prover._commit_bfe` on each shard's
    columns. cols int64 (nc, ..., h) and rand (nc, ..., ntr) on any
    device. Returns the committed coefficients (nc, ..., n) and codewords
    (nc, ..., E), each column-sharded with its pad columns."""
    from ..stark.prover import _commit_bfe

    cols, rand = shard_columns(mesh, cols), shard_columns(mesh, rand)
    out = [_commit_bfe(c, r, trace_dom, eval_dom)
           for c, r in zip(cols.parts, rand.parts)]
    return (Sharded(mesh, [o[0] for o in out], 0, cols.size),
            Sharded(mesh, [o[1] for o in out], 0, cols.size))


def sharded_row_hash(mesh: Mesh, cols: Sharded) -> Sharded:
    """P3: the Tip5 digest of every row of a column-sharded (nc, L)
    table: the pad columns dropped, the cols->rows all-to-all, then one
    K2 launch a shard over its (nc, L / D) block, read column-major.
    Returns the digests (5, L), row-sharded."""
    rows = all_to_all(cols, split_axis=-1, concat_axis=0)
    return rows.map(lambda blk: tip5_kernel.sponge_absorb_rows(blk.T))


def sharded_merkle_layers(mesh: Mesh, digests: Sharded):
    """P3: the Merkle tree over row-sharded leaf digests (5, L): each
    shard's K1 launches fold its contiguous leaf block into a subtree, the
    subtrees' layers are copied into the heap on the lead device (shard
    s's part of a layer is a contiguous slice of it), and the top
    log2(D) layers are hashed there. Returns the heap-ordered node tensor
    (5, 2L - 1) that `MerkleTree.from_flat` adopts."""
    d = mesh.size
    m = digests.parts[0].shape[1]
    num_leafs = m * d
    heap = torch.empty((digests.parts[0].shape[0], 2 * num_leafs - 1),
                       dtype=torch.int64, device=mesh.lead)
    for s, part in enumerate(digests.parts):
        sub = tip5_kernel.merkle_flat(part)
        w = m
        while w >= 1:
            # width w in the subtree, w * d in the tree
            lo = w * d - 1 + s * w
            heap[:, lo:lo + w].copy_(sub[:, w - 1:2 * w - 1])
            w //= 2
    heap[:, :2 * d - 1] = tip5_kernel.merkle_flat(heap[:, d - 1:2 * d - 1])
    return heap


def quotient_chunk_rows(mesh: Mesh, device) -> int:
    """K3's rows a launch sequence on a shard on `device`: the card's
    quotient_cuda.CHUNK_ROWS split among the shards that share it (all of
    them on a one-card host; a shard with a card of its own keeps all of
    it), so that a card holds no more of K3's state than a one-device
    prove."""
    return quotient_cuda.CHUNK_ROWS // sum(d == device
                                           for d in mesh.devices)


def sharded_quotients(mesh: Mesh, main_q: Sharded, aux_q: Sharded,
                      trace_dom, quot_dom, challenges, quot_weights):
    """P4: the combined quotient (`prover._all_quotients_combined_device`)
    with the quotient-domain rows sharded. main_q (NM, Q) and aux_q
    (NA, 3, Q), column-sharded, are resharded to rows, each shard's
    block followed by a halo of unit = Q / h rows, the first rows of the
    next shard (cyclically: the last shard's halo is shard 0's first
    rows), since a row's next row lies unit rows ahead. Returns XFE
    (3, Q) on the lead device."""
    from ..stark import prover

    q = quot_dom.length
    unit = q // trace_dom.length
    main_r = all_to_all(main_q, -1, 0, halo=unit)
    aux_r = all_to_all(aux_q, -1, 0, halo=unit)
    block = q // mesh.size
    ch, ws = prover._quotient_inputs(challenges, quot_weights, mesh.lead)
    chs = replicate(mesh, ch)
    wss = [replicate(mesh, w) for w in ws]          # [phase][shard]
    outs = []
    for j, dev in enumerate(mesh.devices):
        points = quotient_cuda.Points(quot_dom.generator, quot_dom.offset,
                                      block, start=j * block)
        outs.append(prover._quotients_on_rows(
            main_r.parts[j], aux_r.parts[j].permute(1, 0, 2), points, unit,
            trace_dom, chs[j], [w[j] for w in wss],
            quotient_chunk_rows(mesh, dev)))
    return gather(Sharded(mesh, outs, 1), mesh.lead)


def sharded_ood_stage(mesh: Mesh, main: Sharded, aux: Sharded, segs, alpha,
                      omega_alpha, apk, zapk, xs_l):
    """P7: `kernels.ood_stage_fn` with the committed polynomials'
    coefficients column-sharded (main (NM, n), aux (NA, 3, n)): each
    shard evaluates its columns at alpha and omega * alpha, the rows meet
    on the lead device; the quotient segments (on the lead device) as
    there."""
    lead = mesh.lead
    pts = torch.stack([alpha, omega_alpha], dim=1)
    m12, a12 = [], []
    for m, a in zip(main.unpadded().parts, aux.unpadded().parts):
        mv, av = kernels.poly_eval_multi(m, a.permute(1, 0, 2),
                                         pts.to(m.device))
        m12.append(mv.to(lead))
        a12.append(av.to(lead))
    m12, a12 = torch.cat(m12, dim=2), torch.cat(a12, dim=2)
    s12 = kernels._bary_eval_multi(segs, xs_l,
                                   torch.stack([apk, zapk], dim=1))
    return (m12[:, 0], a12[:, 0], m12[:, 1], a12[:, 1], s12[:, 0],
            s12[:, 1])


def sharded_weighted_column_sum(mesh: Mesh, main: Sharded, aux: Sharded,
                                w_main, w_aux):
    """P7: `kernels.weighted_column_sum` over column-sharded main (NM, n)
    and aux (NA, 3, n): each shard sums its columns against its slice of
    the weights (XFE (3, NM), (3, NA)), the partial codewords are added on
    the lead device. Returns XFE (3, n) there."""
    total = None
    for (m, (ms, mn)), (a, (as_, an)) in zip(
            zip(main.parts, main.extents()), zip(aux.parts, aux.extents())):
        dev = m.device
        part = kernels.weighted_column_sum(
            m[:mn], a[:an].permute(1, 0, 2), w_main[:, ms:ms + mn].to(dev),
            w_aux[:, as_:as_ + an].to(dev)).to(mesh.lead)
        total = part if total is None else gf.add(total, part)
    return total


def gather_rows(x: Sharded, axis: int, indices, device):
    """Entries `indices` along `axis` of every real column of a
    column-sharded table, gathered on `device` (the revealed rows)."""
    idx = np.asarray(indices, np.int64)
    return gather(x.map(lambda p: p.index_select(
        axis, torch.as_tensor(idx, device=p.device))), device)
