"""Arithmetic domains: power-of-2 multiplicative cosets offset * <omega>
(triton-vm/src/arithmetic_domain.rs:34-296: value order and pow rule)."""

from __future__ import annotations

from dataclasses import dataclass

from . import bfe
from .bfe import P


@dataclass(frozen=True)
class Domain:
    length: int
    offset: int = 1

    def __post_init__(self):
        if self.length < 1 or self.length & (self.length - 1):
            raise ValueError(f"domain length must be a power of 2: "
                             f"{self.length}")
        if self.offset % P == 0:
            raise ValueError("domain offset must be nonzero")

    @property
    def generator(self) -> int:
        return bfe.primitive_root_of_unity(self.length)

    def value(self, n: int) -> int:
        return pow(self.generator, n, P) * self.offset % P

    def pow(self, exponent: int) -> "Domain":
        if exponent < 1 or exponent & (exponent - 1):
            raise ValueError("exponent must be a power of two")
        return Domain(max(1, self.length // exponent),
                      pow(self.offset, exponent, P))
