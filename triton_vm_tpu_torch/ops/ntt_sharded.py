"""Intra-column sharded NTT: one tall transform spread over a mesh.

The counterpart of `triton_vm_tpu.ops.ntt_sharded`. Column sharding
(parallel/mesh.py) stops helping where one column is taller than the
table is wide (STIR's codewords); this is the six-step transform, n = D
x n2 over D shards, input x_j in natural order, j = j1 n2 + j2:

1. block transpose (all-to-all): shard d holds x[every j1, j2 block d];
2. length-D NTTs over j1 (root w^n2) and the twiddle w^(j2 k1);
3. row gather (all-to-all): shard k1 holds A[k1, every j2];
4. one local length-n2 NTT a shard (root w^D): the bulk of the work;
5. block transpose (all-to-all) and a local transpose: the natural-order
   output, block-sharded over the mesh.

The coset prescale offset^j comes first; the inverse runs the same
network with inverted roots, and its 1/n and offset^-j fold into one
natural-order postscale. The local transforms go through `ntt._transform`
with an explicit root (K4 on a shard's card, the radix-2 network on the
CPU), so every element equals the single-device `ntt.ntt` / `ntt.intt`
(exact arithmetic; tests/test_torch_ntt_sharded.py). The exchanges are the copies of
`parallel.sharding.all_to_all`; a shard's twiddle and scale tables are
built on its device, cached per (n, D, shard, offset, direction, device).
Transforms run along the last axis and batch over the leading ones (the
3 coefficients of an XFE column in one pass).
"""

from __future__ import annotations

import os

import numpy as np

from ..fields import bfe
from ..fields.bfe import P
from ..parallel import sharding
from . import gf, ntt
from .npfield import powers_u64

# Six-step transforms since the last reset, one per call of `ntt_sharded`
# or `intt_sharded`.
launches = {"ntt_sharded": 0}


def reset_launch_counts():
    launches["ntt_sharded"] = 0


def _twiddles(n: int, d: int, s: int, inverse: bool, device):
    """Shard s's twiddles, laid out (n2 / d, d): W[j2', k1] = w^(j2 k1),
    j2 = s n2 / d + j2', w the (inverted for the inverse) n-th root."""
    def make():
        n2 = n // d
        c = n2 // d
        w = bfe.primitive_root_of_unity(n)
        if inverse:
            w = bfe.inv(w)
        cols = [powers_u64(pow(w, k1, P), pow(w, k1 * s * c, P), c)
                for k1 in range(d)]
        return gf.from_u64(np.stack(cols, axis=1), device)

    return ntt._cached(("6tw", n, d, s, inverse, str(device)), make)


def _scales(n: int, d: int, s: int, offset: int, inverse: bool, device):
    """Shard s's natural block of the coset scale: offset^j (forward) or
    offset^-j / n (inverse), j in [s n2, (s + 1) n2)."""
    def make():
        n2 = n // d
        base = bfe.inv(offset) if inverse else offset % P
        first = pow(base, s * n2, P)
        if inverse:
            first = first * bfe.inv(n % P) % P
        return gf.from_u64(powers_u64(base, first, n2), device)

    return ntt._cached(("6sc", n, d, s, offset, inverse, str(device)), make)


def _six_step(v, mesh, offset: int, inverse: bool):
    n = v.shape[-1]
    d = mesh.size
    if n % (d * d):
        raise ValueError(f"n={n} not divisible by mesh^2={d * d}")
    n2 = n // d
    w = bfe.primitive_root_of_unity(n)
    if inverse:
        w = bfe.inv(w)
    root_d, root_n2 = pow(w, n2, P), pow(w, d, P)
    devs = mesh.devices

    def scaled(x):
        return sharding.Sharded(mesh, [
            gf.mul(p, _scales(n, d, s, offset, inverse, dev))
            for s, (p, dev) in enumerate(zip(x.parts, devs))], -1)

    x = sharding.shard(mesh, v, -1)
    if not inverse and offset % P != 1:
        x = scaled(x)
    # 1. block transpose: shard s gets (..., n2 / d, d) = x[j1, j2 block s]
    x = sharding.all_to_all(x.map(lambda p: p.unsqueeze(-1), axis=-2),
                            -2, -1)
    # 2. length-d NTTs over j1, then the twiddles
    x = sharding.Sharded(mesh, [
        gf.mul(ntt._transform(p, root_d), _twiddles(n, d, s, inverse, dev))
        for s, (p, dev) in enumerate(zip(x.parts, devs))], -2)
    # 3. row gather: shard k1 gets (..., n2) = A[k1, every j2]
    x = sharding.all_to_all(x, -1, -2).map(lambda p: p.squeeze(-1), axis=-1)
    # 4. the bulk: one local length-n2 NTT
    x = x.map(lambda p: ntt._transform(p, root_n2))
    # 5. block transpose + local transpose: natural order, block-sharded
    x = sharding.all_to_all(x.map(lambda p: p.unsqueeze(-1), axis=-2),
                            -2, -1)
    x = x.map(lambda p: p.reshape(*p.shape[:-2], n2), axis=-1)
    if inverse:
        x = scaled(x)
    launches["ntt_sharded"] += 1
    return x


def ntt_sharded(coeffs, mesh, offset: int = 1):
    """Forward NTT of length-n columns (..., n) spread over `mesh`:
    natural-order coefficients -> natural-order values on the coset
    offset * <omega_n>, block-sharded along the last axis (a
    `sharding.Sharded`). Equal to `ntt.ntt`. Needs n % D^2 == 0."""
    return _six_step(coeffs, mesh, offset, inverse=False)


def intt_sharded(values, mesh, offset: int = 1):
    """Inverse NTT spread over `mesh`: natural-order values on the coset
    -> natural-order coefficients, block-sharded. Equal to `ntt.intt`."""
    return _six_step(values, mesh, offset, inverse=True)


def _intra_threshold() -> int:
    return int(os.environ.get("TVM_INTRA_NTT_MIN", str(1 << 18)))


def _select_mesh(n: int, device):
    """The active mesh, if intra-column sharding applies at length n: tall
    enough to pay for the exchanges (TVM_INTRA_NTT_MIN, default 2^18) and
    block-splittable (n % D^2 == 0)."""
    mesh = sharding.active_mesh(device)
    if (mesh is not None and n >= _intra_threshold()
            and n % (mesh.size * mesh.size) == 0):
        return mesh
    return None


def xfe_ntt_auto(coeffs, offset: int = 1):
    """Forward NTT of an XFE column (3, n) on its device; the butterflies
    spread over the active mesh when the column is tall. Equal either
    way."""
    mesh = _select_mesh(coeffs.shape[-1], coeffs.device)
    if mesh is not None:
        return sharding.gather(ntt_sharded(coeffs, mesh, offset),
                               coeffs.device)
    return ntt.ntt(coeffs, offset)


def xfe_intt_auto(values, offset: int = 1):
    """Inverse NTT of an XFE column (3, n); mesh-spread when tall."""
    mesh = _select_mesh(values.shape[-1], values.device)
    if mesh is not None:
        return sharding.gather(intt_sharded(values, mesh, offset),
                               values.device)
    return ntt.intt(values, offset)
