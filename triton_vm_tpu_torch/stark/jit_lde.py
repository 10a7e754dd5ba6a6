"""Just-in-time (memory-light) low-degree extension: the committed
codewords coset by coset, never the whole (num_cols, E) table.

The counterpart of `triton_vm_tpu.stark.jit_lde` (the reference's
cache-or-JIT trade, master_table.rs:258-322, and its coset-looped JIT
quotients, stark.rs:880-980). Each table is kept as the coefficients of
its committed polynomials, int64 (..., n) on the device, n the randomized
trace length: the trace interpolant plus Z_trace * r, degree below
h + ntr <= n (`committed_coefficients`, which the cached path's commit
shares). The evaluation domain (length E = m * n) is then m cosets:

- the points with index = t (mod m) form the coset offset * g^t * <g^m>,
  g generating the length-E subgroup and g^m of order n, so a coset's
  values are one length-n NTT of the coefficients with that offset;
- the transition constraints' next row lies unit = Q / h positions ahead
  on the quotient domain; unit is a multiple of m, so inside a coset the
  next row is a roll by unit / m;
- a coset's rows are the columns t::m of the (5, E) leaf digests; where
  the LDT domain is a subgroup of the evaluation domain (stride E / L),
  only the cosets with t % stride == 0 hold LDT rows.

Peak memory is the coefficients plus one coset of each table, O(num_cols *
n) instead of O(num_cols * E). Spans within the prover's stages time each
coset loop, synchronised on CUDA, and the counter `JIT cosets` counts one
per coset transform of a table's coefficients (in a session only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.bfe import P
from ..ops import gf, ntt, tip5_kernel
from ..utils import profiler
from .arithmetic_domain import Domain

JIT_COSETS = "JIT cosets"


def committed_coefficients(cols, rand, trace_dom, n):
    """Coefficients of the committed polynomial of every trace column
    (master_table.rs:258-322): the trace interpolant plus Z_trace(x) *
    r(x), Z_trace = x^h - offset^h, formed in the coefficient domain
    (x^h r(x) - offset^h r(x)).

    cols: int64 (..., h) trace values on trace_dom; rand: int64 (..., ntr)
    randomizer coefficients; n >= h + ntr. Returns int64 (..., n)."""
    h = trace_dom.length
    ntr = rand.shape[-1]
    assert h + ntr <= n
    coeffs = torch.zeros(cols.shape[:-1] + (n,), dtype=torch.int64,
                         device=cols.device)
    coeffs[..., :h] = ntt.intt(cols, trace_dom.offset)
    coeffs[..., h:h + ntr] = gf.add(coeffs[..., h:h + ntr], rand)
    off_h = pow(trace_dom.offset, h, P)
    coeffs[..., :ntr] = gf.sub(coeffs[..., :ntr], gf.mul_const(rand, off_h))
    return coeffs


def cosets(dom, n):
    """(t, offset) of each of the dom.length // n cosets of <g^m> in
    `dom`: coset t holds the points of index t + m j, j < n."""
    m = dom.length // n
    return [(t, dom.offset * pow(dom.generator, t, P) % P) for t in range(m)]


def committed_digests(coeffs, eval_dom, ldt_len):
    """Leaf digests (5, L) of a table's committed codeword on the LDT
    domain, one coset at a time. coeffs: the committed polynomials
    (`committed_coefficients`), int64 (nc, n) for the main table or
    (nc, 3, n) for the aux table, an XFE column's 3 coefficient
    polynomials side by side, so a row of the flattened (3 nc, n) coset
    is the committed row [col0.c0, col0.c1, col0.c2, col1.c0, ...]."""
    n = coeffs.shape[-1]
    m = eval_dom.length // n
    stride = eval_dom.length // ldt_len
    dev = coeffs.device
    digests = torch.empty((5, ldt_len), dtype=torch.int64, device=dev)
    for t, offset in cosets(eval_dom, n):
        if t % stride:
            continue
        with profiler.device_span("JIT coset NTT", "LDE", dev):
            values = ntt.ntt(coeffs, offset).view(-1, n)
            profiler.count(JIT_COSETS)
        with profiler.device_span("JIT coset hash", "LDE", dev):
            # the K2 row sponge reads the column-major coset in place
            digests[:, t // stride::m // stride] = \
                tip5_kernel.sponge_absorb_rows(values.T)
        del values
    return digests


def reveal_rows(coeffs, eval_dom, ldt_len, indices):
    """Committed values at the LDT `indices`, read back as numpy u64
    (..., k): (nc, k) from main coefficients (nc, n), (nc, 3, k) from aux
    coefficients (nc, 3, n). Only the cosets that hold a revealed row are
    evaluated."""
    n = coeffs.shape[-1]
    m = eval_dom.length // n
    stride = eval_dom.length // ldt_len
    dev = coeffs.device
    g = np.asarray(indices, np.int64) * stride   # evaluation-domain index
    out = torch.empty(coeffs.shape[:-1] + (len(g),), dtype=torch.int64,
                      device=dev)
    for t, offset in cosets(eval_dom, n):
        pos = np.nonzero(g % m == t)[0]
        if not len(pos):
            continue
        with profiler.device_span("JIT coset NTT", "LDE", dev):
            values = ntt.ntt(coeffs, offset)
            profiler.count(JIT_COSETS)
        rows = torch.as_tensor(g[pos] // m, device=dev)
        out[..., torch.as_tensor(pos, device=dev)] = \
            values.index_select(-1, rows)
        del values
    return gf.to_u64(out)


# the JAX module's names: one function serves both tables here
committed_digests_bfe = committed_digests_xfe = committed_digests
reveal_rows_bfe = reveal_rows_xfe = reveal_rows


def quotient_codeword_jit(main_coeffs, aux_coeffs, trace_dom, quot_dom,
                          challenges, quot_weights):
    """The all-quotients codeword on the quotient domain, one coset at a
    time (stark.rs:880-980): each coset's main and aux values, then the
    AIR tapes over them in row chunks, the next row a roll by unit / m.
    main_coeffs int64 (NM, n), aux_coeffs int64 (NA, 3, n). Returns XFE
    (3, Q) on the coefficients' device."""
    from . import prover

    n = main_coeffs.shape[-1]
    Q = quot_dom.length
    m = Q // n
    unit = Q // trace_dom.length
    assert unit % m == 0, "next-row shift must stay inside a coset"
    dev = main_coeffs.device
    ch, ws = prover._quotient_inputs(challenges, quot_weights, dev)
    out = torch.empty((3, Q), dtype=torch.int64, device=dev)
    for t, offset in cosets(quot_dom, n):
        with profiler.device_span("JIT coset NTT", "LDE", dev):
            main_c = ntt.ntt(main_coeffs, offset)
            aux_c = ntt.ntt(aux_coeffs, offset).permute(1, 0, 2)
            profiler.count(JIT_COSETS, 2)
        with profiler.device_span("JIT coset quotients", "LDE", dev):
            out[:, t::m] = prover._quotients_on_domain(
                main_c, aux_c, Domain(n, offset), unit // m,
                trace_dom, ch, ws)
        del main_c, aux_c
    return out
