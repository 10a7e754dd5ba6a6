"""Shared test fixtures: the `TestableProgram` helper.

Mirrors triton-vm/src/shared_tests.rs:112-210 — a helper bundling a
program with its inputs and a (low-security by default) Stark instance,
with `run`, `trace_execution`, `prove`, and `prove_and_verify`
conveniences. Lives in the package (not tests/) so downstream users get
the same ergonomics the reference's test suite enjoys. The counterpart
of `triton_vm_tpu.testing`; the default Stark proves on a CUDA card
(`use_stark(Stark.low_security(device="cpu"))` for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .stark.proof_stream import Claim
from .stark.prover import Prover, Stark
from .vm.machine import VM, NonDeterminism, PublicInput


@dataclass
class TestableProgram:
    """`stark` left as None means `Stark.low_security()` on the card,
    made when the program is first proven, so a TestableProgram can be
    set up (and given another Stark) where there is no card."""

    __test__ = False  # not a pytest test class

    program: object
    public_input: PublicInput = field(default_factory=PublicInput)
    non_determinism: NonDeterminism = field(default_factory=NonDeterminism)
    stark: Stark | None = None

    def with_input(self, public_input) -> "TestableProgram":
        if not isinstance(public_input, PublicInput):
            public_input = PublicInput(list(public_input))
        self.public_input = public_input
        return self

    def with_non_determinism(self, non_determinism) -> "TestableProgram":
        self.non_determinism = non_determinism
        return self

    def use_stark(self, stark: Stark) -> "TestableProgram":
        self.stark = stark
        return self

    def run(self):
        return VM.run(self.program, self.public_input, self.non_determinism)

    def trace_execution(self):
        return VM.trace_execution(self.program, self.public_input,
                                  self.non_determinism)

    def prove(self, seed: bytes | None = None):
        """Returns (stark, claim, proof, aet) like shared_tests.rs:182."""
        claim = Claim.about_program(self.program).with_input(
            list(self.public_input.individual_tokens))
        aet, public_output = VM.trace_execution(
            self.program, self.public_input, self.non_determinism)
        claim = claim.with_output(list(public_output))
        if self.stark is None:
            self.stark = Stark.low_security()
        proof = Prover(self.stark, seed=seed).prove(claim, aet)
        return self.stark, claim, proof, aet

    def prove_and_verify(self, seed: bytes | None = None):
        """Prove, verify, and sanity-check the padded height round-trip
        (shared_tests.rs:163-180). Returns the proof."""
        stark, claim, proof, aet = self.prove(seed=seed)
        assert stark.verify(claim, proof)
        assert proof.padded_height() == aet.padded_height()
        return proof
