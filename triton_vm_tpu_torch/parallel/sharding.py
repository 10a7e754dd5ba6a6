"""Mesh activation, sharded values and the exchanges between shards.

The counterpart of `triton_vm_tpu.parallel.sharding`. The JAX package
places the prover's stage inputs over a 1-D device mesh and lets GSPMD
insert the collectives. Here one Python process drives every shard
itself: a `Mesh` is a tuple of D torch devices, a `Sharded` value holds
D per-shard tensors and the axis they split, and an exchange is a set of
device-to-device copies (`Tensor.to`, `copy_` into a preallocated block;
PyTorch orders each against the current streams of both devices). The
Fiat-Shamir transcript stays one sequence on the host. All math is exact
mod-p arithmetic, so a sharded proof equals the single-device proof word
for word (tests/test_torch_mesh_prover.py).

Activation: TVM_MESH=<n> (n > 1, a power of two) shards the prover of a
`Stark` on device `dev` over n shards; unset, 0 or 1 means no mesh. Shard
i of a Stark on `cuda:k` sits on `cuda:((k + i) % device_count)`; for a
CPU Stark every shard is on the CPU. Shard 0, the Stark's own device, is
the lead device: what is not sharded runs there.

One deliberate difference from the JAX package: where fewer than n
devices are visible, several shards share one device (the JAX package
raises). A one-card host thus runs every line of the sharded path, as the
JAX package's tests run its mesh on 8 virtual CPU devices. A mesh that
cannot be built (n not a power of two) raises; it never drops to one
shard.
"""

from __future__ import annotations

import os

import torch


class Mesh:
    """D torch devices, D a power of two; a device may appear more than
    once. devices[0] is the lead device."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        d = len(self.devices)
        if d < 1 or d & (d - 1):
            raise ValueError(f"a mesh needs a power-of-two number of "
                             f"shards, got {d}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def place(n: int, device) -> Mesh:
    """n shards starting at `device`: CUDA shard i on cuda:((k + i) %
    device_count) for device cuda:k, every shard on the CPU for a CPU
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        return Mesh([device] * n)
    k = device.index if device.index is not None \
        else torch.cuda.current_device()
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", (k + i) % count) for i in range(n)])


def active_mesh(device) -> Mesh | None:
    """The mesh TVM_MESH asks for a prover on `device`, or None (unset, 0
    or 1). Raises for an n that is not a power of two."""
    n = int(os.environ.get("TVM_MESH", "0") or 0)
    if n <= 1:
        return None
    return place(n, device)


class Sharded:
    """A tensor split along `axis` into one part per shard of `mesh`, part
    i on mesh.devices[i]. `size` is the logical length along `axis`: the
    parts may hold pad entries past it (zero columns that make the column
    axis divide the mesh), which `unpadded` and `gather` drop."""

    def __init__(self, mesh: Mesh, parts, axis: int, size: int | None = None):
        self.mesh = mesh
        self.parts = list(parts)
        self.axis = axis % self.parts[0].dim()
        total = sum(p.shape[self.axis] for p in self.parts)
        self.size = total if size is None else size

    def map(self, fn, axis: int | None = None) -> "Sharded":
        """fn on every part. Without `axis`, fn keeps the sharded axis and
        its length (pad entries included); with it, the results are
        sharded along `axis` and hold no pad entries."""
        parts = [fn(p) for p in self.parts]
        if axis is None:
            return Sharded(self.mesh, parts, self.axis, self.size)
        return Sharded(self.mesh, parts, axis)

    def extents(self) -> list[tuple[int, int]]:
        """(start, length) of each part's real entries along the axis."""
        out, start = [], 0
        for p in self.parts:
            n = p.shape[self.axis]
            out.append((start, max(0, min(n, self.size - start))))
            start += n
        return out

    def unpadded(self) -> "Sharded":
        """The parts without their pad entries (a view of each)."""
        return Sharded(self.mesh, [
            p.narrow(self.axis, 0, n)
            for p, (_, n) in zip(self.parts, self.extents())], self.axis)


def shard(mesh: Mesh, t, axis: int) -> Sharded:
    """Split t along `axis` into mesh.size equal parts; the axis must
    divide (a row axis is never padded)."""
    n = t.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis of length {n} does not divide a mesh of "
                         f"{mesh.size}")
    s = n // mesh.size
    return Sharded(mesh, [t.narrow(axis, i * s, s).to(d)
                          for i, d in enumerate(mesh.devices)], axis)


def replicate(mesh: Mesh, t) -> list:
    """t on every shard's device (the same tensor where t is there)."""
    return [t.to(d) for d in mesh.devices]


def gather(x: Sharded, device):
    """The logical tensor of `x` on one device: its real entries
    concatenated along the sharded axis."""
    return torch.cat([p.to(device) for p in x.unpadded().parts], x.axis)


def all_to_all(x: Sharded, split_axis: int, concat_axis: int,
               halo: int = 0) -> Sharded:
    """The block transpose (`jax.lax.all_to_all`, tiled): every part's real
    entries are split along `split_axis` into mesh.size chunks, and shard j
    receives chunk j of every part, concatenated along `concat_axis` in
    shard order, into one preallocated block. With `halo`, chunk j is
    followed by the first `halo` entries of chunk (j + 1) % mesh.size, so
    a row's successor up to `halo` rows ahead lies in its block (the wrap
    gives the last shard the first rows of shard 0). Returns the blocks,
    sharded along `split_axis`."""
    mesh = x.mesh
    parts = x.unpadded().parts
    nd = parts[0].dim()
    split_axis %= nd
    concat_axis %= nd
    total = parts[0].shape[split_axis]
    if total % mesh.size:
        raise ValueError(f"axis of length {total} does not divide a mesh of "
                         f"{mesh.size}")
    c = total // mesh.size
    if halo > c:
        raise ValueError(f"halo of {halo} exceeds a block of {c}")
    widths = [p.shape[concat_axis] for p in parts]
    shape = list(parts[0].shape)
    shape[split_axis] = c + halo
    shape[concat_axis] = sum(widths)
    out = []
    for j, dev in enumerate(mesh.devices):
        block = torch.empty(shape, dtype=parts[0].dtype, device=dev)
        off = 0
        nxt = (j + 1) % mesh.size * c
        for p, w in zip(parts, widths):
            dst = block.narrow(concat_axis, off, w)
            dst.narrow(split_axis, 0, c).copy_(p.narrow(split_axis, j * c, c))
            if halo:
                dst.narrow(split_axis, c, halo).copy_(
                    p.narrow(split_axis, nxt, halo))
            off += w
        out.append(block)
    return Sharded(mesh, out, split_axis)
