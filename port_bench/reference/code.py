"""Reed-Solomon code soundness bookkeeping shared by FRI and STIR.

Transcribes triton-vm/src/low_degree_test/mod.rs:223-359:
rate, proximity margin per regime (proven Johnson bound vs conjectured
q-ary-entropy list decoding), slackness heuristic (margin/20), proximity
parameter, and list-size estimates. All float math follows the reference
operation-for-operation so derived query counts match.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# log2(|extension field|) approximated as log2((2^64)^3); see
# low_degree_test/mod.rs:287-307 for the error analysis.
LOG2_FIELD_SIZE_F = 191.99999999899228


@dataclass(frozen=True)
class ReedSolomonCode:
    """mod.rs:212-359."""

    log2_expansion_factor: int
    soundness: str = "proven"  # ProximityRegime

    @property
    def rate(self) -> float:
        return 1.0 / (1 << self.log2_expansion_factor)

    def q_ary_entropy(self) -> float:
        """mod.rs:287-307 (evaluated at the rate)."""
        rate = self.rate
        rate_log_rate = rate * -self.log2_expansion_factor
        one_m = (1.0 - rate) * math.log2(1.0 - rate)
        return rate - (rate_log_rate + one_m) / LOG2_FIELD_SIZE_F

    def proximity_margin(self) -> float:
        """mod.rs:276-285."""
        if self.soundness == "proven":
            return math.sqrt(self.rate)
        if self.soundness == "conjectured":
            return self.q_ary_entropy()
        raise ValueError(self.soundness)

    def slackness_factor(self) -> float:
        """mod.rs:263-274 (heuristic: margin / 20)."""
        return self.proximity_margin() / 20.0

    def proximity_parameter(self) -> float:
        """mod.rs:236-249: delta = 1 - margin - slackness."""
        return 1.0 - self.proximity_margin() - self.slackness_factor()

    def log2_list_size(self, log2_poly_degree: int) -> float:
        """mod.rs:347-359."""
        if self.soundness == "proven":
            ls = 1.0 / (2.0 * math.sqrt(self.rate)
                        * self.slackness_factor())
        else:
            ls = (2.0 ** float(log2_poly_degree)
                  / (self.q_ary_entropy() * self.slackness_factor()))
        return math.log2(ls)


def log2_binomial_coefficient(a: int, b: int) -> float:
    """stir.rs:854-870: Kahan-Babuska-compensated log2(a choose b)."""
    assert a >= b, "binomial coefficient with b > a"
    log2_binom = 0.0
    compensation = 0.0
    for i in range(min(b, a - b)):
        summand = math.log2(float(a - i)) - math.log2(float(i + 1))
        corrected = summand - compensation
        nxt = log2_binom + corrected
        compensation = (nxt - log2_binom) - corrected
        log2_binom = nxt
    return log2_binom
