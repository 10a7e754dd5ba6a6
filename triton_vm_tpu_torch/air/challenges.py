"""Challenge identifiers and derivation.

Transcribed from triton-air/src/challenge_id.rs:16-243 and
triton-vm/src/challenges.rs:48-124: 63 challenge slots, of
which 59 are Fiat-Shamir-sampled and 4 are derived terminals inserted at
their index positions.
"""

from __future__ import annotations

from ..fields import xfe as _xfe
from ..fields.bfe import P

CHALLENGE_NAMES = [
    "CompressProgramDigestIndeterminate",
    "StandardInputIndeterminate",
    "StandardOutputIndeterminate",
    "InstructionLookupIndeterminate",
    "HashInputIndeterminate",
    "HashDigestIndeterminate",
    "SpongeIndeterminate",
    "OpStackIndeterminate",
    "RamIndeterminate",
    "JumpStackIndeterminate",
    "U32Indeterminate",
    "ClockJumpDifferenceLookupIndeterminate",
    "RamTableBezoutRelationIndeterminate",
    "ProgramAddressWeight",
    "ProgramInstructionWeight",
    "ProgramNextInstructionWeight",
    "OpStackClkWeight",
    "OpStackIb1Weight",
    "OpStackPointerWeight",
    "OpStackFirstUnderflowElementWeight",
    "RamClkWeight",
    "RamPointerWeight",
    "RamValueWeight",
    "RamInstructionTypeWeight",
    "JumpStackClkWeight",
    "JumpStackCiWeight",
    "JumpStackJspWeight",
    "JumpStackJsoWeight",
    "JumpStackJsdWeight",
    "ProgramAttestationPrepareChunkIndeterminate",
    "ProgramAttestationSendChunkIndeterminate",
    "HashCIWeight",
] + [f"StackWeight{i}" for i in range(16)] + [
    "HashCascadeLookupIndeterminate",
    "HashCascadeLookInWeight",
    "HashCascadeLookOutWeight",
    "CascadeLookupIndeterminate",
    "LookupTableInputWeight",
    "LookupTableOutputWeight",
    "LookupTablePublicIndeterminate",
    "U32LhsWeight",
    "U32RhsWeight",
    "U32CiWeight",
    "U32ResultWeight",
    # derived (challenges.rs:109-119); sampled count = 59
    "StandardInputTerminal",
    "StandardOutputTerminal",
    "LookupTablePublicTerminal",
    "CompressedProgramDigest",
]

COUNT = len(CHALLENGE_NAMES)
assert COUNT == 63
NUM_DERIVED = 4
SAMPLE_COUNT = COUNT - NUM_DERIVED  # 59

ID = {name: i for i, name in enumerate(CHALLENGE_NAMES)}


def compute_eval_terminal(symbols, challenge):
    """EvalArg::compute_terminal with default initial 1
    (cross_table_argument.rs:66-82)."""
    acc = _xfe.ONE
    for s in symbols:
        acc = _xfe.add(_xfe.mul(challenge, acc), _xfe.lift(s))
    return acc


class Challenges:
    """63 XFE challenges: 59 sampled + 4 derived (challenges.rs:83-119)."""

    def __init__(self, sampled, claim):
        """sampled: list of 59 XFE tuples; claim: stark.Claim."""
        assert len(sampled) == SAMPLE_COUNT
        ch = list(sampled)

        input_terminal = compute_eval_terminal(
            claim.input, ch[ID["StandardInputIndeterminate"]])
        output_terminal = compute_eval_terminal(
            claim.output, ch[ID["StandardOutputIndeterminate"]])
        # lookup table public terminal: all 256 lookup-table outputs
        from ..crypto.tip5 import LOOKUP_TABLE
        lookup_terminal = compute_eval_terminal(
            list(LOOKUP_TABLE), ch[ID["LookupTablePublicIndeterminate"]])
        digest_compression = compute_eval_terminal(
            list(claim.program_digest),
            ch[ID["CompressProgramDigestIndeterminate"]])

        ch.append(input_terminal)
        ch.append(output_terminal)
        ch.append(lookup_terminal)
        ch.append(digest_compression)
        assert len(ch) == COUNT
        self.challenges = ch

    def __getitem__(self, key):
        if isinstance(key, str):
            key = ID[key]
        return self.challenges[key]
