"""Inputs and oracle for K3 (csrc/quotient.cu) on the card: random rows
at the master AIR's full widths (379 main, 91 aux columns) and K3's plain
version over them. chip_smoke.py's kernels phase and the card-only cases
of tests/test_torch_cuda.py hold K3 against it with these.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air import compile as aircomp
from ..fields import bfe
from ..fields.bfe import P
from ..ops import gf, quotient_cuda

NUM_MAIN, NUM_AUX, NUM_CHALLENGES = 379, 91, 63
EDGE = (0, 1, P - 1, 2**32)


def make_inputs(rng, n, device, *, halo=0, shift=4, permuted_aux=False,
                edge=False, log2_trace=10, device_draw=False):
    """Keyword arguments of `quotients_on_rows` (all but the tape) for n
    random rows at the master AIR's widths: main (379, M), aux (3, 91, M)
    with M = n + halo (a mesh shard's block and halo, next rows `halo`
    ahead) or M = n (next rows `shift` ahead, cyclically), aux as a permuted
    view of (91, 3, M) storage if asked, every column cycling through 0, 1,
    p - 1 and 2^32 with `edge`; the points offset * g^(start + i) for a
    random g, offset and start (random-looking field elements), a trace
    domain of 2^log2_trace rows, random challenges and weights. With
    `device_draw` main and aux are drawn on `device` (torch's generator,
    seeded from rng), for sizes the host should not draw: words below
    2^63, canonical as drawn (K3's arithmetic does not branch on the
    data)."""
    m = n + halo
    if device_draw:
        gen = torch.Generator(device).manual_seed(int(rng.integers(1 << 62)))

        def draw(shape):
            return torch.randint(0, 2**63 - 1, shape, dtype=torch.int64,
                                 device=device, generator=gen)
    else:
        def draw(shape):
            return gf.from_u64(rng.integers(0, P, shape, dtype=np.uint64),
                               device)
    if edge:
        pattern = np.array(EDGE, np.uint64)
        main = gf.from_u64(pattern[(np.arange(NUM_MAIN)[:, None]
                                    + np.arange(m)) % 4], device)
        aux = gf.from_u64(pattern[(np.arange(3 * NUM_AUX)[:, None]
                                   + np.arange(m)) % 4], device)
    else:
        main, aux = draw((NUM_MAIN, m)), draw((3 * NUM_AUX, m))
    if permuted_aux:
        aux = aux.view(NUM_AUX, 3, m).permute(1, 0, 2)
    else:
        aux = aux.view(3, NUM_AUX, m)
    trace_len = 1 << log2_trace
    return dict(
        main=main, aux=aux,
        points=quotient_cuda.Points(
            *(int(v) for v in rng.integers(2, P, 2, dtype=np.uint64)), n,
            start=int(rng.integers(0, 1 << 20))),
        shift=halo or shift, trace_len=trace_len,
        gen_inv=bfe.inv(bfe.primitive_root_of_unity(trace_len)),
        ch=gf.from_u64(rng.integers(0, P, (3, NUM_CHALLENGES),
                                    dtype=np.uint64), device),
        ws=gf.from_u64(rng.integers(
            0, P, (3, aircomp.quotient_row_tape().num_weights),
            dtype=np.uint64), device))


def k3(inp):
    return quotient_cuda.quotients_on_rows(aircomp.quotient_row_tape(),
                                           **inp)


def plain(inp, chunk=None):
    return quotient_cuda.quotients_on_rows_plain(
        aircomp.quotient_row_tape(), **inp, chunk=chunk)
