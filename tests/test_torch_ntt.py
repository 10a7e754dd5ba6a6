"""The port's NTT, iNTT and coset LDE (triton_vm_tpu_torch.ops.ntt) and
its commit-stage LDE against the JAX package's (triton_vm_tpu.ops.ntt,
stark.prover._commit_bfe_fn / _commit_xfe_fn): exact equality on narrow
column batches."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import ntt as jntt
from triton_vm_tpu_torch.ops import gf, ntt

torch.set_num_threads(2)


def _cols(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


@pytest.mark.parametrize("n", [1, 2, 16, 256])
@pytest.mark.parametrize("offset", [1, 7])
def test_ntt_and_intt_match_jax(n, offset):
    a = _cols(n, (5, n))
    assert np.array_equal(gf.to_u64(ntt.ntt(gf.from_u64(a), offset)),
                          jgf.to_u64(jntt.ntt(jgf.from_u64(a), offset)))
    assert np.array_equal(gf.to_u64(ntt.intt(gf.from_u64(a), offset)),
                          jgf.to_u64(jntt.intt(jgf.from_u64(a), offset)))


def test_intt_inverts_ntt_over_leading_axes():
    """XFE-shaped batches (3, cols, n) transform along the last axis."""
    a = gf.from_u64(_cols(3, (3, 4, 64)))
    assert torch.equal(ntt.intt(ntt.ntt(a, 7), 7), a)


@pytest.mark.parametrize("n,expansion,in_off,out_off",
                         [(8, 4, 1, 7), (64, 8, 1, 7), (32, 2, 7, 3)])
def test_lde_matches_jax(n, expansion, in_off, out_off):
    a = _cols(n + expansion, (6, n))
    got = gf.to_u64(ntt.lde(gf.from_u64(a), expansion, in_off, out_off))
    want = jgf.to_u64(jntt.lde(jgf.from_u64(a), expansion, in_off, out_off))
    assert np.array_equal(got, want)


def test_commit_lde_matches_jax_commit_stage():
    """The committed codewords (trace LDE + zerofier-times-randomizer,
    formed in the coefficient domain here, pointwise in the JAX package)
    are the same field elements, for base and extension columns."""
    from triton_vm_tpu.stark import prover as jprover
    from triton_vm_tpu.stark.arithmetic_domain import Domain
    from triton_vm_tpu_torch.stark import prover

    h, E, ntr, nc = 32, 256, 5, 4
    trace_dom, eval_dom = Domain(h), Domain(E, 7)
    cols, rand = _cols(1, (nc, h)), _cols(2, (nc, ntr))
    zv = jgf.from_u64(jprover._trace_zerofier_values(trace_dom, eval_dom))
    want, _ = jprover._commit_bfe_fn(h, E, E, 7, ntr, nc)(
        jgf.from_u64(cols), jgf.from_u64(rand), zv)
    _, got = prover._commit_bfe(gf.from_u64(cols), gf.from_u64(rand),
                                trace_dom, eval_dom)
    assert np.array_equal(gf.to_u64(got), jgf.to_u64(want))

    xcols, xrand = _cols(3, (nc, 3, h)), _cols(4, (nc, 3, ntr))
    want3, _ = jprover._commit_xfe_fn(h, E, E, 7, ntr, nc)(
        tuple(jgf.from_u64(xcols[:, c]) for c in range(3)),
        tuple(jgf.from_u64(xrand[:, c]) for c in range(3)), zv)
    _, got3 = prover._commit_bfe(gf.from_u64(xcols), gf.from_u64(xrand),
                                 trace_dom, eval_dom)     # (nc, 3, E)
    for c in range(3):
        assert np.array_equal(gf.to_u64(got3[:, c]), jgf.to_u64(want3[c]))
