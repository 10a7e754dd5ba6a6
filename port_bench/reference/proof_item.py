"""Typed proof items with Fiat-Shamir inclusion rules.

Mirrors triton-vm/src/proof_item.rs:96-147: 13 item
variants; the first 7 are absorbed into the Fiat-Shamir transcript, the
rest are covered by earlier commitments (see the reference's soundness
notes).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import codec

NUM_MAIN_COLUMNS = 379
NUM_AUX_COLUMNS = 91
NUM_QUOTIENT_SEGMENTS = 4
NUM_RANDOMIZED_QUOTIENT_SEGMENTS = 5

# variant name -> (discriminant, payload shape, include_in_fiat_shamir)
ITEM_SPECS = {
    "MerkleRoot": (0, "digest", True),
    "Log2PaddedHeight": (1, "u32", True),
    "OutOfDomainMainRow": (2, ("arr", NUM_MAIN_COLUMNS, "xfe"), True),
    "OutOfDomainAuxRow": (3, ("arr", NUM_AUX_COLUMNS, "xfe"), True),
    "OutOfDomainQuotientSegments": (
        4, ("arr", NUM_QUOTIENT_SEGMENTS, "xfe"), True),
    "Polynomial": (5, ("vec", "xfe"), True),
    "StirOutOfDomainValues": (6, ("vec", "xfe"), True),
    "AuthenticationStructure": (7, ("vec", "digest"), False),
    "MasterMainTableRows": (8, ("vec", ("arr", NUM_MAIN_COLUMNS, "bfe")), False),
    "MasterAuxTableRows": (9, ("vec", ("arr", NUM_AUX_COLUMNS, "xfe")), False),
    "QuotientSegmentsElements": (
        10, ("vec", ("arr", NUM_RANDOMIZED_QUOTIENT_SEGMENTS, "xfe")), False),
    "FriCodeword": (11, ("vec", "xfe"), False),
    "FriResponse": (12, ("struct", [("queried_leaves", ("vec", "xfe")),
                                    ("auth_structure", ("vec", "digest"))]),
                    False),
    # stir.rs:150-169: revealed k-element leaf stacks + auth structure
    "StirResponse": (13, ("struct", [("queried_leaves",
                                      ("vec", ("vec", "xfe"))),
                                     ("auth_structure", ("vec", "digest"))]),
                     False),
}

_BY_DISCRIMINANT = {spec[0]: (name, spec[1], spec[2])
                    for name, spec in ITEM_SPECS.items()}


@dataclass
class ProofItem:
    variant: str
    payload: object

    def include_in_fiat_shamir_heuristic(self) -> bool:
        return ITEM_SPECS[self.variant][2]

    def encode(self) -> list[int]:
        """[discriminant] ++ payload encoding; like the BFieldCodec derive
        for enums, a dynamically-sized variant field is preceded by its
        encoding length (same rule as struct fields)."""
        disc, shape, _ = ITEM_SPECS[self.variant]
        payload_enc = codec.encode(self.payload, shape)
        if codec.static_length(shape) is None:
            return [disc, len(payload_enc)] + payload_enc
        return [disc] + payload_enc

    @classmethod
    def decode(cls, words, pos=0):
        codec._check(words, pos, 1)
        disc = words[pos]
        if disc not in _BY_DISCRIMINANT:
            raise codec.DecodeError(f"unknown proof item discriminant {disc}")
        name, shape, _ = _BY_DISCRIMINANT[disc]
        pos += 1
        if codec.static_length(shape) is None:
            codec._check(words, pos, 1)
            declared = words[pos]
            pos += 1
            payload, new_pos = codec.decode(words, shape, pos)
            if new_pos - pos != declared:
                raise codec.DecodeError("wrong declared payload length")
            pos = new_pos
        else:
            payload, pos = codec.decode(words, shape, pos)
        return cls(name, payload), pos

    def expect(self, variant: str):
        if self.variant != variant:
            raise codec.DecodeError(
                f"expected {variant}, got {self.variant}")
        return self.payload
