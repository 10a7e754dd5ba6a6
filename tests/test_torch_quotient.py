"""The port's quotient tapes (triton_vm_tpu_torch.air.compile.run_tape_scan,
and stark.prover._all_quotients_combined_device over K3's plain version)
against the JAX package's exact host evaluators
(air.evaluate.eval_vectorized_obj and stark.prover._all_quotients_combined)
on a small fibonacci trace, whose witness the JAX package's host
extension builds."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.air.evaluate import eval_vectorized_obj
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu_torch.air import circuit as C
from triton_vm_tpu_torch.air.compile import compile_tape, run_tape_scan
from triton_vm_tpu_torch.air.evaluate import linearize
from triton_vm_tpu_torch.ops import gf

torch.set_num_threads(2)


def test_synthetic_tape_matches_host_evaluator():
    """Mixed base/extension typing, next-row reads, challenges, constants
    and a deep chain that recycles registers."""
    rng = np.random.default_rng(0)
    b = C.Builder()
    x, y = b.input(C.MAIN, 0), b.input(C.NEXT_MAIN, 1)
    a0, a1 = b.input(C.AUX, 0), b.input(C.NEXT_AUX, 2)
    ch = b.challenge(3)
    t = x * y + b.b_constant(17)
    for i in range(12):
        t = t * t + x * b.b_constant(i + 1)
    exprs = [t * ch + a0, (a0 + a1) * (x + y) * ch, x * x * x + y,
             b.x_constant((1, 2, 3)) * a1 + t]
    steps, out_ids = linearize(exprs)
    tape = compile_tape(steps, out_ids)

    B = 37
    main = rng.integers(0, P, (4, B), dtype=np.uint64)
    nmain = rng.integers(0, P, (4, B), dtype=np.uint64)
    aux = rng.integers(0, P, (3, 3, B), dtype=np.uint64)
    naux = rng.integers(0, P, (3, 3, B), dtype=np.uint64)
    chs = rng.integers(0, P, (6, 3), dtype=np.uint64)
    got = gf.to_u64(run_tape_scan(
        tape, gf.from_u64(main), gf.from_u64(aux), gf.from_u64(chs.T),
        gf.from_u64(nmain), gf.from_u64(naux)))             # (3, K, B)
    res = eval_vectorized_obj(
        steps, out_ids, main.astype(object),
        tuple(aux[c].astype(object) for c in range(3)),
        [tuple(int(v) for v in row) for row in chs],
        nmain.astype(object), tuple(naux[c].astype(object) for c in range(3)))
    for k, r in enumerate(res):
        for c in range(3):
            want = np.broadcast_to(np.asarray(r[c], object), (B,))
            assert [int(v) for v in got[c, k]] == [int(v) for v in want]


@pytest.fixture(scope="module")
def fib_trace():
    """Committed main/aux codewords of fibonacci(7) on a quotient domain
    of 2h rows, plus its challenges and constraint weights."""
    from triton_vm_tpu.tables import master as jmt
    from triton_vm_tpu_torch.air.challenges import SAMPLE_COUNT, Challenges
    from triton_vm_tpu_torch.air.master import master_air
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.stark import prover
    from triton_vm_tpu_torch.stark.arithmetic_domain import Domain
    from triton_vm_tpu_torch.stark.proof_stream import Claim
    from triton_vm_tpu_torch.tables import master as mt
    from triton_vm_tpu_torch.vm.machine import VM, PublicInput

    rng = np.random.default_rng(7)
    program = ex.fibonacci()
    aet, output = VM.trace_execution(program, PublicInput([7]))
    claim = Claim.about_program(program).with_input([7]).with_output(output)
    _, ntr, trace_dom, _, _, ldt_dom = prover.Stark(
        device="cpu").derive_domains(aet.padded_height())
    h = trace_dom.length
    main = mt.fill_main_table(aet, padded_height=h, device="cpu")
    jmt.fill_derived_main_columns(main)
    challenges = Challenges(
        [tuple(int(c) for c in row) for row in
         rng.integers(0, P, (SAMPLE_COUNT, 3), dtype=np.uint64)], claim)
    aux = jmt.extend_host(main, challenges)
    jmt.fill_derived_aux_columns(main, aux, challenges.challenges)
    aux[:, prover.NUM_AUX - 1, :] = rng.integers(0, P, (h, 3),
                                                 dtype=np.uint64)
    quot_dom = Domain(2 * h, ldt_dom.offset)
    _, main_q = prover._commit_bfe(
        gf.from_u64(main.T),
        gf.from_u64(rng.integers(0, P, (prover.NUM_MAIN, ntr),
                                 dtype=np.uint64)), trace_dom, quot_dom)
    _, aux_q = prover._commit_bfe(
        gf.from_u64(aux.transpose(1, 2, 0)),
        gf.from_u64(rng.integers(0, P, (prover.NUM_AUX, 3, ntr),
                                 dtype=np.uint64)),
        trace_dom, quot_dom)
    aux_q = aux_q.permute(1, 0, 2)                         # (3, NA, Q)
    n = sum(len(cs) for cs in master_air().constraints.values())
    weights = prover._powers_xfe((3, 1, 4), n)
    return main_q, aux_q, trace_dom, quot_dom, challenges, weights


@pytest.fixture(scope="module")
def host_quotient(fib_trace):
    from triton_vm_tpu.stark.prover import _all_quotients_combined

    main_q, aux_q, trace_dom, quot_dom, challenges, weights = fib_trace
    want = _all_quotients_combined(gf.to_u64(main_q), gf.to_u64(aux_q),
                                   trace_dom, quot_dom, challenges, weights)
    return np.array(want, np.uint64)                        # (Q, 3)


@pytest.mark.parametrize("chunk_rows", [1 << 16, 256])
def test_quotient_codeword_matches_jax_host(fib_trace, host_quotient,
                                            monkeypatch, chunk_rows):
    """Whole-domain and row-chunked row tapes (K3's plain version; next
    rows wrap across chunk edges) give the JAX host quotient codeword."""
    from triton_vm_tpu_torch.ops import quotient_cuda
    from triton_vm_tpu_torch.stark import prover

    monkeypatch.setattr(quotient_cuda, "CHUNK_ROWS", chunk_rows)
    got = prover._all_quotients_combined_device(*fib_trace)  # (3, Q)
    assert np.array_equal(gf.to_u64(got).T, host_quotient)
