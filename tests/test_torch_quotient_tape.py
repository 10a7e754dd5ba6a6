"""The port's row tapes (air/compile.py::compile_row_tape, the program K3
of csrc/quotient.cu runs a row at a time) and K3's plain version
(ops/quotient_cuda.py) against the JAX package's exact host evaluators
(air.evaluate.eval_vectorized_obj, stark.prover._all_quotients_combined)
and the port's level tape (run_tape_scan), word for word. Small sizes: a
synthetic circuit, the master AIR's four phases on 32 random rows,
fibonacci(7)'s quotient domain (its witness from the JAX package's host
extension)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_vm_tpu.air.evaluate import eval_vectorized_obj
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.fields import xfe as jxfe
from triton_vm_tpu_torch.air import circuit as C
from triton_vm_tpu_torch.air import compile as aircomp
from triton_vm_tpu_torch.air.evaluate import linearize
from triton_vm_tpu_torch.ops import gf, gfx, quotient_cuda

torch.set_num_threads(2)


def _field(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def _weighted_host(res, weights, n):
    """sum_k weights[k] * res[k] per row: res from eval_vectorized_obj
    (XFE triples of object arrays or ints), weights numpy (K, 3). Returns
    numpy uint64 (3, n)."""
    out = np.zeros((3, n), np.uint64)
    for i in range(n):
        acc = jxfe.ZERO
        for k, r in enumerate(res):
            v = tuple(int(np.broadcast_to(np.asarray(r[c], object), (n,))[i])
                      for c in range(3))
            acc = jxfe.add(acc, jxfe.mul(tuple(int(w) for w in weights[k]),
                                         v))
        out[:, i] = acc
    return out


def _synthetic(bare):
    """test_torch_quotient.py's synthetic circuit: mixed typing, next-row
    reads, challenges, constants and a deep chain that recycles registers;
    with `bare`, also outputs that are a main column, a next-aux column
    and a challenge, which no binop produces."""
    b = C.Builder()
    x, y = b.input(C.MAIN, 0), b.input(C.NEXT_MAIN, 1)
    a0, a1 = b.input(C.AUX, 0), b.input(C.NEXT_AUX, 2)
    ch = b.challenge(3)
    t = x * y + b.b_constant(17)
    for i in range(12):
        t = t * t + x * b.b_constant(i + 1)
    exprs = [t * ch + a0, (a0 + a1) * (x + y) * ch, x * x * x + y,
             b.x_constant((1, 2, 3)) * a1 + t]
    if bare:
        exprs = [x] + exprs[:2] + [a1, ch] + exprs[2:]
    return linearize(exprs)


@pytest.mark.parametrize("weights", ["unit 0", "unit 1", "unit 2", "unit 3",
                                     "random"])
@pytest.mark.parametrize("bare", [False, True], ids=["binop outputs",
                                                     "bare outputs"])
def test_synthetic_row_tape_matches_host_evaluator(bare, weights):
    """Each output alone (a unit weight) and a random weighting: the row
    tape's weighted sum equals the JAX evaluator's outputs, weighted."""
    rng = np.random.default_rng(0)
    steps, out_ids = _synthetic(bare)
    tape = aircomp.compile_row_tape(steps, out_ids)
    K, B = len(out_ids), 37
    if weights == "random":
        w = _field(rng, (K, 3))
    else:
        w = np.zeros((K, 3), np.uint64)
        w[int(weights.split()[1]) * (K - 1) // 3, 0] = 1
    main = _field(rng, (4, B))
    nmain = np.roll(main, -5, axis=1)
    aux = _field(rng, (3, 3, B))
    naux = np.roll(aux, -5, axis=2)
    chs = _field(rng, (6, 3))
    got = quotient_cuda.run_row_tape_plain(
        tape, gf.from_u64(main), gf.from_u64(aux), gf.from_u64(chs.T),
        gfx.from_u64(w), gf.full((1, B), 1), shift=5)
    res = eval_vectorized_obj(
        steps, out_ids, main.astype(object),
        tuple(aux[c].astype(object) for c in range(3)),
        [tuple(int(v) for v in row) for row in chs],
        nmain.astype(object), tuple(naux[c].astype(object) for c in range(3)))
    assert np.array_equal(gf.to_u64(got), _weighted_host(res, w, B))


def test_row_tape_refuses_a_duplicate_output():
    steps, out_ids = _synthetic(False)
    with pytest.raises(ValueError, match="twice"):
        aircomp.compile_row_tape(steps, out_ids + out_ids[:1])


@pytest.fixture(scope="module")
def phase_rows():
    """32 random rows at the master AIR's widths, their next rows 3 rows
    ahead (cyclically), challenges and weights for every constraint."""
    rng = np.random.default_rng(11)
    n, shift = 32, 3
    main = _field(rng, (379, n))
    aux = _field(rng, (3, 91, n))
    chs = _field(rng, (63, 3))
    return main, aux, chs, n, shift, rng


@pytest.mark.parametrize("phase", aircomp.PHASES)
def test_phase_row_tape_matches_level_tape_and_jax(phase_rows, phase):
    """One phase's row tape, weighted, against the port's level tape
    (run_tape_scan) and the JAX package's host evaluator over its own
    master AIR, weighted the same."""
    from triton_vm_tpu.air.evaluate import linearize as jax_linearize
    from triton_vm_tpu.air.master import master_air as jax_master_air
    from triton_vm_tpu_torch.air.master import master_air

    main, aux, chs, n, shift, rng = phase_rows
    steps, out_ids = linearize(master_air().constraints[phase])
    tape = aircomp.compile_row_tape(steps, out_ids)
    w = _field(np.random.default_rng(len(out_ids)), (len(out_ids), 3))
    ch = gf.from_u64(chs.T)
    got = gf.to_u64(quotient_cuda.run_row_tape_plain(
        tape, gf.from_u64(main), gf.from_u64(aux), ch, gfx.from_u64(w),
        gf.full((1, n), 1), shift))

    nmain = np.roll(main, -shift, axis=1)
    naux = np.roll(aux, -shift, axis=2)
    outs = aircomp.run_tape_scan(
        aircomp.phase_tape(phase), gf.from_u64(main), gf.from_u64(aux), ch,
        gf.from_u64(nmain), gf.from_u64(naux))              # (3, K, n)
    level = gfx.reduce_sum(gfx.mul(outs, gfx.from_u64(w)[:, :, None]), 0)
    assert np.array_equal(got, gf.to_u64(level))

    jsteps, jout = jax_linearize(jax_master_air().constraints[phase])
    res = eval_vectorized_obj(
        jsteps, jout, main.astype(object),
        tuple(aux[c].astype(object) for c in range(3)),
        [tuple(int(v) for v in row) for row in chs],
        nmain.astype(object), tuple(naux[c].astype(object) for c in range(3)))
    assert np.array_equal(got, _weighted_host(res, w, n))


def test_quotient_row_tape_joins_the_phases():
    """Weights and phases follow each other in PHASES order, one
    PHASE_END a phase, and each phase keeps its own instructions."""
    from triton_vm_tpu_torch.air.master import master_air

    air = master_air()
    tape = aircomp.quotient_row_tape()
    parts = [aircomp.compile_row_tape(*linearize(air.constraints[ph]))
             for ph in aircomp.PHASES]
    assert tape.num_weights == sum(len(air.constraints[ph])
                                   for ph in aircomp.PHASES)
    ends = np.nonzero(tape.code[:, 0] == aircomp.PHASE_END)[0]
    assert tape.code[ends, 1].tolist() == [0, 1, 2, 3]
    assert (ends + 1).tolist() == np.cumsum([len(p.code)
                                             for p in parts]).tolist()
    assert tape.num_bregs == max(p.num_bregs for p in parts)
    assert tape.num_xregs == max(p.num_xregs for p in parts)


def test_register_files_fit_the_kernel():
    """The row tape fits what K3's source assumes: four phases (the four
    zerofier words of the kernel's state array, at the generator's
    ZEROFIERS), operand indices within the 16 bits the encoding gives
    them, and a generated state array no larger than the tape's register
    file and st's fixed words (values pass through it only across
    segments)."""
    from triton_vm_tpu_torch.ops import tape_codegen

    src = (Path(quotient_cuda.__file__).resolve().parent.parent / "csrc"
           / "quotient.cu").read_text()
    assert "return QUOTIENT_STATE_WORDS;" in src
    for name, want in (("kAcc", tape_codegen.ACC),
                       ("kTotal", tape_codegen.TOTAL),
                       ("kZerofiers", tape_codegen.ZEROFIERS)):
        assert int(re.search(rf"{name} = (\d+)", src).group(1)) == want
    tape = aircomp.quotient_row_tape()
    gen = tape_codegen.generate(tape)
    assert gen.state_words <= tape.reg_words + tape_codegen.FIXED_WORDS
    assert tape.num_phases == 4
    # operand indices fit the 16 bits the encoding gives them
    assert len(tape.bconsts) < 1 << 16 and len(tape.xconsts) < 1 << 16


# ------------------------------------------------- the combined quotient

@pytest.fixture(scope="module")
def fib_trace():
    """Committed main/aux codewords of fibonacci(7) on a quotient domain
    of 2h rows, plus its challenges and constraint weights (as in
    test_torch_quotient.py)."""
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
        [tuple(int(c) for c in row) for row in _field(rng, (SAMPLE_COUNT,
                                                            3))], claim)
    aux = jmt.extend_host(main, challenges)
    jmt.fill_derived_aux_columns(main, aux, challenges.challenges)
    aux[:, prover.NUM_AUX - 1, :] = _field(rng, (h, 3))
    quot_dom = Domain(2 * h, ldt_dom.offset)
    _, main_q = prover._commit_bfe(
        gf.from_u64(main.T), gf.from_u64(_field(rng, (prover.NUM_MAIN,
                                                      ntr))),
        trace_dom, quot_dom)
    _, aux_q = prover._commit_bfe(
        gf.from_u64(aux.transpose(1, 2, 0)),
        gf.from_u64(_field(rng, (prover.NUM_AUX, 3, ntr))), trace_dom,
        quot_dom)
    aux_q = aux_q.permute(1, 0, 2)             # (3, NA, Q), (NA, 3, Q) storage
    n = sum(len(cs) for cs in master_air().constraints.values())
    weights = prover._powers_xfe((3, 1, 4), n)
    return main_q, aux_q, trace_dom, quot_dom, challenges, weights


@pytest.fixture(scope="module")
def want_quotient(fib_trace):
    """The JAX package's host quotient codeword and the port's prover's
    (`_all_quotients_combined_device`), which must agree: numpy uint64
    (3, Q)."""
    from triton_vm_tpu.stark.prover import _all_quotients_combined
    from triton_vm_tpu_torch.stark import prover

    main_q, aux_q, trace_dom, quot_dom, challenges, weights = fib_trace
    jax = np.array(_all_quotients_combined(
        gf.to_u64(main_q), gf.to_u64(aux_q), trace_dom, quot_dom,
        challenges, weights), np.uint64).T
    port = gf.to_u64(prover._all_quotients_combined_device(*fib_trace))
    assert np.array_equal(jax, port)
    return jax


@pytest.mark.parametrize("case", ["permuted aux", "contiguous",
                                  "strided main", "halo"])
def test_combined_quotient_matches_jax(fib_trace, want_quotient, case):
    """K3's plain version over the whole quotient domain (aux as the
    permuted view the cached path passes, contiguous copies, main as a
    strided view of a twice-as-long table) and over a mesh shard's rows
    followed by its halo (M = N + shift), against the JAX package."""
    from triton_vm_tpu_torch.fields import bfe
    from triton_vm_tpu_torch.stark import prover

    main_q, aux_q, trace_dom, quot_dom, challenges, weights = fib_trace
    Q = quot_dom.length
    shift = Q // trace_dom.length
    ch, ws = prover._quotient_inputs(challenges, weights, "cpu")
    points = quotient_cuda.Points(quot_dom.generator, quot_dom.offset, Q)
    rows = slice(0, Q)
    main, aux = main_q, aux_q
    if case == "contiguous":
        main, aux = main_q.contiguous(), aux_q.contiguous()
    elif case == "strided main":
        wide = torch.zeros((main_q.shape[0], 2 * Q), dtype=torch.int64)
        wide[:, ::2] = main_q
        main = wide[:, ::2]
        assert main.stride() == (2 * Q, 2)
    elif case == "halo":
        # the third of four shards, its block then `shift` rows of the next
        block = Q // 4
        idx = (torch.arange(block + shift) + 2 * block) % Q
        main, aux = main_q[:, idx], aux_q[:, :, idx]
        rows = slice(2 * block, 3 * block)
        points = points._replace(n=block, start=2 * block)
    got = quotient_cuda.quotients_on_rows(
        aircomp.quotient_row_tape(), main, aux, points, shift,
        trace_dom.length,
        bfe.inv(trace_dom.generator), ch, torch.cat(ws, dim=1))
    assert np.array_equal(gf.to_u64(got), want_quotient[:, rows])


def test_zerofier_inverses_match_their_formulas():
    """The plain version's zerofier inverses are each phase's formula:
    1/(x - 1), 1/(x^h - 1), (x - g^-1)/(x^h - 1) and 1/(x - g^-1)."""
    from triton_vm_tpu_torch.fields import bfe

    xs = gf.powers(7, 64, 5)
    g_inv = bfe.inv(bfe.primitive_root_of_unity(16))
    zis = quotient_cuda.zerofier_inverses(xs, 16, g_inv)
    for x, z in zip(gf.to_u64(xs).tolist(), gf.to_u64(zis).T.tolist()):
        xh = pow(x, 16, P)
        assert z == [pow(x - 1, P - 2, P), pow(xh - 1, P - 2, P),
                     (x - g_inv) * pow(xh - 1, P - 2, P) % P,
                     pow(x - g_inv, P - 2, P)]


@pytest.mark.parametrize("how", ["meta tensors", "no toolkit"])
def test_k3_raises_without_a_card(how):
    """Asked for K3 without a card, the wrapper raises; it never runs the
    plain version for a tensor that is not on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs K3")
    tape = aircomp.quotient_row_tape()
    if how == "no toolkit":
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            pytest.skip("a CUDA toolkit is present")
        with pytest.raises(RuntimeError, match="nvcc"):
            quotient_cuda.load()
        return
    meta = dict(dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quotient_cuda.quotients_on_rows(
            tape, torch.empty((379, 8), **meta),
            torch.empty((3, 91, 8), **meta), quotient_cuda.Points(7, 1, 8),
            1, 4, 1, torch.empty((3, 63), **meta),
            torch.empty((3, tape.num_weights), **meta))
