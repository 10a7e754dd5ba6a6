"""The port's device-resident witness (triton_vm_tpu_torch.tables.
extend_device) against the JAX package's host witness, word for word.

The JAX VM and the JAX `fill_main_table` produce the main table of the
every-instruction program, of `u32_mix`, of `hash_chain` input 10
(BASELINE config 3: padded height 2^11, 1,037 cascade and 96 hash rows)
and of bench.py's Merkle authentication path in a tree of height 3
(config 4, its digests divined); the same numpy table and the same
seeded challenges go through the port's `main_witness_dev` /
`aux_witness_dev` on the CPU. All 379 main and 91 aux columns must equal
the JAX package's `fill_derived_main_columns` + `extend_host` +
`fill_derived_aux_columns` + the randomizer write. The log-depth scans
are held against sequential loops, and the transition-phase derived
columns are zero in the last row (substitutions.rs:266-301)."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.air.challenges import SAMPLE_COUNT as JSAMPLE_COUNT
from triton_vm_tpu.air.challenges import Challenges as JChallenges
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.models import example_programs as jex
from triton_vm_tpu.stark.proof_stream import Claim as JClaim
from triton_vm_tpu.tables import master as jmt
from triton_vm_tpu.vm.machine import VM as JVM
from triton_vm_tpu.vm.machine import PublicInput as JPublicInput
from triton_vm_tpu_torch.air import columns
from triton_vm_tpu_torch.air.evaluate import substitution_pairs
from triton_vm_tpu_torch.air.master import master_air
from triton_vm_tpu_torch.fields import xfe
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.ops import gf, gfx
from triton_vm_tpu_torch.tables import extend_device as ed
from triton_vm_tpu_torch.tables import master as mt
from triton_vm_tpu_torch.vm.machine import VM, PublicInput

torch.set_num_threads(2)

NUM_MAIN, NUM_AUX = 379, 91


def _trace(name):
    if name == "every_instruction":
        from tests.test_golden_reference import \
            every_instruction_testable_program

        program, public_input, non_determinism = \
            every_instruction_testable_program()
        aet, output = JVM.trace_execution(program, public_input,
                                          non_determinism)
        return program, list(public_input.individual_tokens), aet, output
    if name == "merkle_auth":
        from tests.test_torch_baseline_configs import jax_merkle_auth

        program, public_input, non_determinism = jax_merkle_auth(3)
        aet, output = JVM.trace_execution(
            program, JPublicInput(public_input), non_determinism)
        return program, public_input, aet, output
    program, public_input = {"u32_mix": (jex.u32_mix(), [50]),
                             "hash_chain": (jex.hash_chain(), [10])}[name]
    aet, output = JVM.trace_execution(program, JPublicInput(public_input))
    return program, public_input, aet, output


@pytest.fixture(scope="module", params=["every_instruction", "u32_mix",
                                        "hash_chain", "merkle_auth"])
def case(request):
    """The JAX host witness of one trace and the port's inputs: the AIR
    main table, the 63 challenges and the batch-randomizer column."""
    program, public_input, aet, output = _trace(request.param)
    claim = (JClaim.about_program(program).with_input(public_input)
             .with_output(output))
    rng = np.random.default_rng(17)
    h = aet.padded_height()
    main_air = jmt.fill_main_table(aet, padded_height=h)
    challenges = JChallenges(
        [tuple(int(c) for c in row) for row in
         rng.integers(0, P, size=(JSAMPLE_COUNT, 3), dtype=np.uint64)],
        claim)
    randomizer = rng.integers(0, P, size=(h, 3), dtype=np.uint64)

    main = main_air.copy()
    jmt.fill_derived_main_columns(main)
    aux_scans = jmt.extend_host(main, challenges)
    aux = aux_scans.copy()
    jmt.fill_derived_aux_columns(main, aux, challenges.challenges)
    aux[:, NUM_AUX - 1, :] = randomizer
    return dict(name=request.param, main_air=main_air,
                challenges=challenges.challenges, randomizer=randomizer,
                main=main, aux_scans=aux_scans, aux=aux)


def _bad_columns(got, want):
    """Columns (axis 1) on which two host tables differ."""
    return [c for c in range(want.shape[1])
            if not np.array_equal(got[:, c], want[:, c])]


def test_main_witness_equals_jax_host(case):
    main_dev = ed.main_witness_dev(case["main_air"], "cpu")
    assert main_dev.shape == (NUM_MAIN, case["main"].shape[0])
    bad = _bad_columns(gf.to_u64(main_dev).T, case["main"])
    assert not bad, f"{case['name']}: main columns differ: {bad}"


def test_aux_witness_equals_jax_host(case):
    main_dev = gf.from_u64(case["main"].T, "cpu")
    aux_dev = ed.aux_witness_dev(main_dev, case["challenges"],
                                 gfx.from_u64(case["randomizer"], "cpu"))
    assert aux_dev.shape == (NUM_AUX, 3, case["main"].shape[0])
    bad = _bad_columns(gf.to_u64(aux_dev).transpose(2, 0, 1), case["aux"])
    assert not bad, f"{case['name']}: aux columns differ: {bad}"


def test_witness_in_row_chunks_equals_jax_host(case, monkeypatch):
    """The derived-column tapes in chunks of 64 rows: each chunk's next
    rows (the row after its last, the first row after the last chunk)
    come from the next chunk."""
    monkeypatch.setattr(ed, "_FILL_CHUNK_ROWS", 64)
    assert case["main"].shape[0] > 64
    main_dev = ed.main_witness_dev(case["main_air"], "cpu")
    bad = _bad_columns(gf.to_u64(main_dev).T, case["main"])
    assert not bad, f"{case['name']}: main columns differ: {bad}"
    aux_dev = ed.aux_witness_dev(main_dev, case["challenges"],
                                 gfx.from_u64(case["randomizer"], "cpu"))
    bad = _bad_columns(gf.to_u64(aux_dev).transpose(2, 0, 1), case["aux"])
    assert not bad, f"{case['name']}: aux columns differ: {bad}"


def test_extend_all_device_equals_jax_extend_host(case):
    got = ed.extend_all_device(case["main"], case["challenges"], "cpu")
    bad = _bad_columns(got, case["aux_scans"])
    assert not bad, f"{case['name']}: aux scan columns differ: {bad}"


# ------------------------------------------------------------------ scans

LENGTHS = [1, 2, 3, 7, 9, 15, 17, 33]


def _random_xfe(rng, shape):
    return gfx.from_u64(rng.integers(0, P, size=shape + (3,),
                                     dtype=np.uint64))


@pytest.mark.parametrize("h", LENGTHS)
def test_prefix_sum_equals_sequential_loop(h):
    rng = np.random.default_rng(h)
    v = _random_xfe(rng, (2, h))
    got = gfx.to_u64(ed.prefix_sum(v))
    for r, row in enumerate(gfx.to_u64(v)):
        acc = xfe.ZERO
        for i, x in enumerate(row):
            acc = xfe.add(acc, tuple(int(c) for c in x))
            assert tuple(int(c) for c in got[r, i]) == acc, (r, i)


@pytest.mark.parametrize("h", LENGTHS)
def test_affine_scan_equals_sequential_loop(h):
    """value_i = A_i * acc0 + B_i for the maps acc -> a_j*acc + b_j,
    j <= i, applied in order from a random acc0."""
    rng = np.random.default_rng(100 + h)
    a, b = _random_xfe(rng, (2, h)), _random_xfe(rng, (2, h))
    A_, B_ = (gfx.to_u64(t) for t in ed.affine_scan(a, b))
    a_np, b_np = gfx.to_u64(a), gfx.to_u64(b)
    acc0 = tuple(int(c) for c in rng.integers(0, P, 3, dtype=np.uint64))
    for r in range(2):
        acc = acc0
        for i in range(h):
            acc = xfe.add(xfe.mul(tuple(int(c) for c in a_np[r, i]), acc),
                          tuple(int(c) for c in b_np[r, i]))
            got = xfe.add(xfe.mul(tuple(int(c) for c in A_[r, i]), acc0),
                          tuple(int(c) for c in B_[r, i]))
            assert got == acc, (r, i)


# ------------------------------------------------------- derived columns

def test_transition_derived_columns_zero_in_last_row():
    """All 210 tran-phase derived main columns and all 41 derived aux
    columns (every one of them tran-phase) are zero in the last row, NEXT
    reads or not, on the port's own trace of fib(10)."""
    air = master_air()
    aet, _ = VM.trace_execution(ex.fibonacci(), PublicInput([10]))
    main = ed.main_witness_dev(mt.fill_main_table(aet, device="cpu"), "cpu")
    tran = [col for _, col, _ in substitution_pairs(air.main_subs["tran"])]
    assert len(tran) == 210
    assert not main[tran, -1].any()
    assert main[tran, :-1].any()
    aux_tran = [col for _, col, _ in substitution_pairs(air.aux_subs["tran"])]
    assert len(aux_tran) == NUM_AUX - 1 - columns.NUM_AUX_AIR_COLUMNS
    rng = np.random.default_rng(3)
    challenges = [tuple(int(c) for c in row) for row in
                  rng.integers(0, P, size=(63, 3), dtype=np.uint64)]
    randomizer = gfx.from_u64(np.zeros((main.shape[1], 3), np.uint64), "cpu")
    aux = ed.aux_witness_dev(main, challenges, randomizer)
    assert not aux[aux_tran, :, -1].any()
    assert aux[aux_tran, :, :-1].any()
