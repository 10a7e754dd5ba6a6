"""The port's prover sharded over a CPU mesh (TVM_MESH=2, 4, 8) with STIR:
the program of the JAX package's `dryrun_multichip` (__graft_entry__.py:
46-52), Stark(security_level=32, log2_ldt_expansion_factor=2), seed
bytes(range(32)). Every mesh proof equals the port's single-device proof
and the JAX package's single-device proof word for word (the JAX package's
own test pins its mesh proof to that one); it verifies, and a tampered
word is rejected. TVM_INTRA_NTT_MIN=64 sends STIR's initial iNTT
(2^11 rows) through the six-step transform of ops/ntt_sharded.py: the
counterpart of the JAX package's
tests/test_ntt_sharded.py::test_stir_device_prove_with_intra_column_sharding.
tests/test_torch_mesh_prover.py does the same with FRI."""

import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ldt.fri import LdtError
from triton_vm_tpu_torch.ops import ntt_sharded
from triton_vm_tpu_torch.stark.codec import DecodeError

torch.set_num_threads(2)

SOURCE = ("push 3 call cnt halt\n"
          "cnt: dup 0 push 0 eq skiz return addi -1 recurse")
SEED = bytes(range(32))


def _jax_single_device_words():
    from triton_vm_tpu.isa.program import triton_program
    from triton_vm_tpu.stark.proof_stream import Claim
    from triton_vm_tpu.stark.prover import Prover, Stark
    from triton_vm_tpu.vm.machine import VM, PublicInput

    program = triton_program(SOURCE)
    aet, output = VM.trace_execution(program, PublicInput([]))
    claim = Claim.about_program(program).with_output(list(output))
    stark = Stark(security_level=32, log2_ldt_expansion_factor=2,
                  ldt_choice="stir")
    return [int(w) for w in Prover(stark, seed=SEED).prove(claim, aet).words]


@pytest.fixture(scope="module")
def case():
    """The port's claim, trace and Stark on the CPU, its single-device
    proof (TVM_MESH unset) and the JAX package's."""
    program = tvm.triton_program(SOURCE)
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([]))
    claim = tvm.Claim.about_program(program).with_output(list(output))
    stark = tvm.Stark(32, 2, ldt_choice="stir", device="cpu")
    assert isinstance(stark.ldt(aet.padded_height()), tvm.Stir)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TVM_MESH", raising=False)
        single = stark.prove(claim, aet, seed=SEED)
    return claim, aet, stark, single.words, _jax_single_device_words()


def test_single_device_proof_equals_jax(case):
    *_, single, jax_words = case
    assert single == jax_words


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_proof_equals_single_device_proofs(monkeypatch, case, d):
    claim, aet, stark, single, jax_words = case
    monkeypatch.setenv("TVM_MESH", str(d))
    monkeypatch.setenv("TVM_INTRA_NTT_MIN", "64")
    ntt_sharded.reset_launch_counts()
    proof = stark.prove(claim, aet, seed=SEED)
    assert ntt_sharded.launches["ntt_sharded"] >= 1
    assert proof.words == single
    assert proof.words == jax_words
    assert stark.verify(claim, proof)
    bad = list(proof.words)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % P
    with pytest.raises((tvm.VerificationError, LdtError, DecodeError)):
        assert not stark.verify(claim, tvm.Proof(bad))
        raise tvm.VerificationError("rejected")
