"""The port's recursive verifier (triton_vm_tpu_torch.models.
recursive_verifier) against the JAX package's, on one proof: the port's
proof of fibonacci input 7 with Stark() and seed bytes(range(32)) on the
CPU, the inner proof of BASELINE config 5. The JAX verifier accepts the
port's proof words (tests/test_torch_stark_interop.py), so both
verifiers' collectors, and both `build`s' programs, RAM and divined
digests, are computed from the same words and must be equal. Each
section runs in the port's native VM in about a second, so the cycle
counts and the in-VM rejection of a tampered row are tier-1 here (the
JAX package marks its own runs `slow`)."""

import numpy as np
import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu.models import recursive_verifier as jrv
from triton_vm_tpu.stark.proof_stream import Claim as JClaim
from triton_vm_tpu.stark.proof_stream import Proof as JProof
from triton_vm_tpu.stark.prover import Stark as JStark
from triton_vm_tpu.stark.prover import Verifier as JVerifier
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.models import recursive_verifier as rv
from triton_vm_tpu_torch.tables import master as mt
from triton_vm_tpu_torch.vm.machine import (VM, NonDeterminism,
                                            PublicInput, VMError)

torch.set_num_threads(2)

SEED = bytes(range(32))
# tip5.hash_varlen([len(w) + 1, len(w)] + w) of the JAX package's proof
# of fibonacci input 7 with Stark() and seed bytes(range(32)), the
# digest chip_smoke.py pins as JAX_FIB7_DIGEST (its command is there).
JAX_FIB7_DIGEST = (16776481165773445315, 11632406580342972184,
                   4551248486225805797, 9432930646896196063,
                   16369719787940908687)
SECTIONS = ("air_eval", "fs_replay", "ood_check", "queries", "combined")
# Table heights of the JAX package's trace of each section at
# num_queries=1 (JAX_PLATFORMS=cpu, rv.build on JAX_FIB7's proof, then
# VM.trace_execution and aet.height_of_table), and the padded height.
JAX_HEIGHTS = {
    "air_eval": (dict(processor=34000, op_stack=62708, ram=25014,
                      hash=36366, program=60610, cascade=65370), 1 << 16),
    "fs_replay": (dict(processor=2841, op_stack=2616, ram=6470, hash=6403,
                       program=4200, cascade=44681), 1 << 16),
    "ood_check": (dict(processor=39021, op_stack=72684, ram=28722,
                       hash=41640, program=69400, cascade=65465), 1 << 17),
    "queries": (dict(processor=11963, op_stack=21902, ram=8601, hash=12951,
                     program=20510, cascade=57909), 1 << 16),
    "combined": (dict(processor=53823, op_stack=97202, ram=43793,
                      hash=60982, program=94090, cascade=65529), 1 << 17),
}


@pytest.fixture(scope="module")
def proven():
    return tvm.prove_program(ex.fibonacci(), [7], seed=SEED, device="cpu")


def _jax_claim(claim):
    jclaim = JClaim(tuple(claim.program_digest), list(claim.input),
                    list(claim.output), claim.version)
    assert jclaim.encode() == claim.encode()
    return jclaim


@pytest.fixture(scope="module")
def builds(proven):
    stark, claim, proof = proven
    mine = rv.build(claim, proof, stark, num_queries=1)
    theirs = jrv.build(_jax_claim(claim), JProof(list(proof.words)),
                       JStark(), num_queries=1)
    return mine, theirs


def test_inner_proof_digest_equals_jax(proven):
    _, _, proof = proven
    w = proof.words
    assert proof.padded_height() == 512
    assert len(w) == 144633
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) \
        == JAX_FIB7_DIGEST


def _host(v):
    """A collected value as plain Python: ints, tuples and lists."""
    if isinstance(v, np.ndarray):
        return v.astype(np.uint64).tolist()
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def test_collector_equals_jax(proven):
    stark, claim, proof = proven
    col, jcol = {}, {}
    assert tvm.Verifier(stark).verify(claim, proof, collector=col)
    assert JVerifier(JStark()).verify(_jax_claim(claim),
                                      JProof(list(proof.words)),
                                      collector=jcol)
    assert set(col) == set(jcol)
    for key in sorted(col):
        if key == "ldt_dom":
            got, want = col[key], jcol[key]
            assert (got.length, got.offset) == (want.length, want.offset)
            continue
        assert _host(col[key]) == _host(jcol[key]), key
    # every collected value is a host value, no tensor
    def walk(v):
        assert not isinstance(v, torch.Tensor)
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
    walk(col)
    assert len(col["fs_events"]) == 57
    assert sum(len(w) for kind, w in col["fs_events"]
               if kind == "absorb") == 6050
    assert len(col["revealed_indices"]) == 173
    assert col["ldt_dom"].length == 4096


def test_stark_verify_passes_the_collector(proven):
    stark, claim, proof = proven
    col = {}
    assert stark.verify(claim, proof, collector=col)
    assert col["padded_height"] == 512 and "quot_auth" in col


@pytest.mark.parametrize("section", SECTIONS)
def test_build_program_text_equals_jax(builds, section):
    mine, theirs = builds
    assert str(mine.programs[section]) == str(theirs.programs[section])
    assert (mine.programs[section].to_bwords()
            == theirs.programs[section].to_bwords())


def test_build_ram_and_digests_equal_jax(builds):
    mine, theirs = builds
    ram, jram = mine.non_determinism.ram, theirs.non_determinism.ram
    assert all(type(k) is int and type(v) is int for k, v in ram.items())
    assert ram == {int(k): int(v) for k, v in jram.items()}
    assert ([tuple(int(x) for x in d) for d in mine.non_determinism.digests]
            == [tuple(int(x) for x in d)
                for d in theirs.non_determinism.digests])
    assert mine.anchors == theirs.anchors


@pytest.mark.parametrize("section", SECTIONS)
def test_section_trace_equals_jax(builds, section):
    mine, _ = builds
    nd = NonDeterminism(ram=dict(mine.non_determinism.ram),
                        digests=list(mine.non_determinism.digests))
    aet, _ = VM.trace_execution(mine.programs[section], PublicInput([]), nd)
    heights, padded = JAX_HEIGHTS[section]
    assert {t: aet.height_of_table(t) for t in heights} == heights
    assert aet.padded_height() == padded
    assert mine.run(section) == {"cycles": heights["processor"],
                                 "padded_height": padded}


def test_air_eval_hits_the_spec_anchor(builds):
    mine, _ = builds
    cycles = mine.run("air_eval")["cycles"]
    assert abs(cycles - mine.anchors[
        "spec_static_air_eval_processor_rows"]) < 200


def test_verifier_core_rejects_tampered_reveal(builds):
    mine, _ = builds
    # flip one word of the revealed main row in RAM: the in-VM Merkle
    # walk must fail its root assertion
    ram = dict(mine.non_determinism.ram)
    addr = rv._q_main(0) + 7
    ram[addr] = (ram.get(addr, 0) + 1) % rv.P
    nd = NonDeterminism(ram=ram, digests=list(mine.non_determinism.digests))
    with pytest.raises(VMError):
        VM.trace_execution(mine.programs["queries"], PublicInput([]), nd)


def test_combined_trace_ram_bezout_equals_plain(builds):
    """The first 500 unique RAM pointers of the config-5 trace (2^40 ..
    2^50): the fast Bezout coefficients equal the O(N^2) version's."""
    mine, _ = builds
    nd = NonDeterminism(ram=dict(mine.non_determinism.ram),
                        digests=list(mine.non_determinism.digests))
    aet, _ = VM.trace_execution(mine.programs["combined"], PublicInput([]),
                                nd)
    ptrs = np.unique(np.asarray(aet.ram_rows, np.uint64)[:, 2])
    assert len(ptrs) == 16668
    big = ptrs[ptrs >= 1 << 40]
    assert len(big) > 500 and int(big.max()) < 1 << 51
    roots = [int(p) for p in big[:500]]
    got = mt.bezout_coefficient_polynomials_coefficients(roots, "cpu")
    assert got == mt._bezout_plain(roots)
