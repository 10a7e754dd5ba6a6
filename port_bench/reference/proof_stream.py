"""The claim and the Fiat-Shamir proof stream over the Tip5 sponge
(triton-vm/src/proof_stream.rs:9-104, proof.rs:33-126), on the
verifier's side: decode a proof's words, dequeue its items and sample."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import codec, tip5
from .proof_item import ProofItem

CLAIM_SHAPE = ("struct", [
    ("program_digest", "digest"),
    ("version", "u32"),
    ("input", ("vec", "bfe")),
    ("output", ("vec", "bfe")),
])

CURRENT_VERSION = 6  # proof.rs: Claim::CURRENT_VERSION


@dataclass
class Claim:
    program_digest: tuple
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    version: int = CURRENT_VERSION

    def encode(self):
        return codec.encode(
            {"program_digest": self.program_digest, "version": self.version,
             "input": list(self.input), "output": list(self.output)},
            CLAIM_SHAPE)


class ProofStream:
    def __init__(self):
        self.items: list[ProofItem] = []
        self.items_index = 0
        self.sponge = tip5.Tip5Sponge()

    def alter_fiat_shamir_state_with(self, encoded_words):
        self.sponge.pad_and_absorb_all(encoded_words)

    def dequeue(self) -> ProofItem:
        if self.items_index >= len(self.items):
            raise codec.DecodeError("proof stream: empty queue")
        item = self.items[self.items_index]
        if item.include_in_fiat_shamir_heuristic():
            self.alter_fiat_shamir_state_with(item.encode())
        self.items_index += 1
        return item

    def is_exhausted(self) -> bool:
        return self.items_index >= len(self.items)

    def sample_indices(self, upper_bound: int, num: int) -> list[int]:
        return self.sponge.sample_indices(upper_bound, num)

    def sample_scalars(self, num: int) -> list[tuple]:
        return self.sponge.sample_scalars(num)

    @classmethod
    def decode(cls, words) -> "ProofStream":
        """struct ProofStream { items: Vec<ProofItem> } (dynamic field)."""
        stream = cls()
        words = [int(w) for w in words]
        if not words:
            raise codec.DecodeError("empty proof")
        if words[0] != len(words) - 1:
            raise codec.DecodeError("wrong outer length")
        pos = 1
        codec._check(words, pos, 1)
        n = words[pos]
        pos += 1
        for _ in range(n):
            codec._check(words, pos, 1)
            item_len = words[pos]
            pos += 1
            item, new_pos = ProofItem.decode(words, pos)
            if new_pos - pos != item_len:
                raise codec.DecodeError("wrong declared item length")
            pos = new_pos
            stream.items.append(item)
        if pos != len(words):
            raise codec.DecodeError("trailing garbage in proof")
        return stream
