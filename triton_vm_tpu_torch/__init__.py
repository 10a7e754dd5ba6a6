"""triton_vm_tpu_torch: the Triton VM zk-STARK proof system on PyTorch,
with its Tip5 kernels hand-written in CUDA for Hopper.

The public API mirrors the reference `triton_vm::prelude` and
`triton_vm::lib` (prove_program / prove / verify, lib.rs:228-297), as the
JAX package `triton_vm_tpu` does; proofs are word-for-word the same. Every
entry point runs on a CUDA card unless the caller passes device="cpu".
"""

from .isa.program import Program, triton_asm, triton_program  # noqa: F401
from .ldt.fri import Fri, FriParameters  # noqa: F401
from .ldt.stir import Stir, StirParameters  # noqa: F401
from .stark.proof_stream import Claim, Proof  # noqa: F401
from .stark.prover import (Prover, ProvingError, Stark,  # noqa: F401
                           VerificationError, Verifier)
from .utils import profiler
from .vm.machine import (VM, NonDeterminism, PublicInput,  # noqa: F401
                         VMError, VMState)


def prove_program(program, public_input=None, non_determinism=None,
                  seed=None, device="cuda"):
    """Execute `program`, prove correct execution on `device`.

    Returns (stark, claim, proof) like the reference's `prove_program`
    (lib.rs:228-267)."""
    stark = Stark(device=device)
    if public_input is None:
        public_input = PublicInput()
    elif not isinstance(public_input, PublicInput):
        public_input = PublicInput(list(public_input))
    non_determinism = non_determinism or NonDeterminism()
    with profiler.span("VM trace", "VM"):
        aet, public_output = VM.trace_execution(program, public_input,
                                                non_determinism)
    claim = (Claim.about_program(program)
             .with_input(public_input.individual_tokens)
             .with_output(public_output))
    proof = stark.prove(claim, aet, seed=seed)
    return stark, claim, proof


def prove(stark, claim, program, non_determinism=None, seed=None):
    """Like the reference's `prove` (lib.rs:270-283); runs on
    `stark.device`."""
    non_determinism = non_determinism or NonDeterminism()
    with profiler.span("VM trace", "VM"):
        aet, public_output = VM.trace_execution(
            program, PublicInput(claim.input), non_determinism)
    if list(public_output) != list(claim.output):
        raise ProvingError("public output does not match claim")
    return stark.prove(claim, aet, seed=seed)


def verify(stark, claim, proof) -> bool:
    """Like the reference's `verify` (lib.rs:286-297); runs on
    `stark.device`."""
    try:
        return bool(stark.verify(claim, proof))
    except Exception:
        return False
