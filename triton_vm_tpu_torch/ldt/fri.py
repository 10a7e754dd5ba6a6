"""FRI low-degree test.

Transcribed from triton-vm/src/low_degree_test/fri.rs and
the parameter derivation in low_degree_test/mod.rs:215-360. The prover's
codewords are XFE tensors (3, n); commitment trees embed each XFE as the
digest (c0, c1, c2, 0, 0) (fri.rs:927-929).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import merkle
from ..fields import bfe, poly, xfe
from ..fields.bfe import P
from ..stark.arithmetic_domain import Domain
from ..stark.proof_item import ProofItem
from ..utils import profiler

GENERATOR = 7  # BFieldElement::generator(): initial-domain offset


class LdtError(ValueError):
    pass


def xfe_to_digest(x):
    return (x[0], x[1], x[2], 0, 0)


def proximity_parameter(log2_expansion_factor: int, soundness: str) -> float:
    """low_degree_test/mod.rs:250-341."""
    rate = 1.0 / (1 << log2_expansion_factor)
    if soundness == "proven":
        margin = math.sqrt(rate)
    elif soundness == "conjectured":
        log2_field_size = 191.99999999899228
        rate_log_rate = rate * -log2_expansion_factor
        one_m = (1.0 - rate) * math.log2(1.0 - rate)
        margin = rate - (rate_log_rate + one_m) / log2_field_size
    else:
        raise ValueError(soundness)
    slackness = margin / 20.0
    return 1.0 - margin - slackness


@dataclass(frozen=True)
class FriParameters:
    security_level: int
    log2_initial_expansion_factor: int
    log2_high_degree_bound: int
    soundness: str = "proven"


class Fri:
    def __init__(self, params: FriParameters):
        if params.log2_initial_expansion_factor == 0:
            raise LdtError("expansion factor too small")
        self.expansion_factor = 1 << params.log2_initial_expansion_factor
        log2_domain_len = (params.log2_high_degree_bound
                           + params.log2_initial_expansion_factor)
        self.domain = Domain(1 << log2_domain_len, GENERATOR)
        delta = proximity_parameter(params.log2_initial_expansion_factor,
                                    params.soundness)
        self.num_collinearity_checks = math.ceil(
            -params.security_level / math.log2(1.0 - delta))

    # ------------------------------------------------------------ interface

    def initial_domain(self) -> Domain:
        return self.domain

    def num_first_round_queries(self) -> int:
        return self.num_collinearity_checks

    def max_degree(self) -> int:
        return self.domain.length // self.expansion_factor - 1

    def num_rounds(self) -> int:
        first_round_code_dimension = self.max_degree() + 1
        max_num_rounds = (1 << (first_round_code_dimension - 1).bit_length()
                          ).bit_length() - 1
        if self.num_collinearity_checks > 0:
            checking_all = max(self.num_collinearity_checks.bit_length() - 1, 0)
        else:
            checking_all = 0
        checking_most = checking_all + 1
        return max(0, max_num_rounds - checking_most)

    def last_round_max_degree(self) -> int:
        return self.max_degree() >> self.num_rounds()

    # --------------------------------------------------------------- prover

    def prove(self, codeword, proof_stream) -> list[int]:
        """Commit, fold and query an XFE codeword tensor (3, n); returns
        the first-round revealed indices (A-indices). Folding, leaf
        hashing and tree building run on the codeword's device
        (fri.rs:349-366 semantics)."""
        from ..ops import gfx, ntt

        if codeword.shape[-1] != self.domain.length:
            raise LdtError("initial codeword length mismatch")

        rounds = []  # (domain, codeword (3, n), tree)

        def commit(domain, cw):
            pad = torch.zeros((2, cw.shape[-1]), dtype=cw.dtype,
                              device=cw.device)
            tree = merkle.MerkleTree(torch.cat([cw, pad]))  # (5, n) leaves
            proof_stream.enqueue(ProofItem("MerkleRoot", tree.root()))
            rounds.append((domain, cw, tree))

        dev = codeword.device
        with profiler.device_span("FRI commit", "LDT", dev):
            commit(self.domain, codeword)
            for _ in range(self.num_rounds()):
                challenge = proof_stream.sample_scalars(1)[0]
                prev_domain, prev_cw, _ = rounds[-1]
                commit(prev_domain.pow(2),
                       _fold(prev_domain, prev_cw, challenge))

            last_cw = rounds[-1][1]
            proof_stream.enqueue(ProofItem("FriCodeword",
                                           gfx.to_tuples(last_cw)))
            # The reference interpolates via iNTT and sends the FULL-length
            # coefficient vector, trailing zeros included (fri.rs:262-268;
            # ArithmeticDomain::interpolate does not normalize). The
            # encoding length is part of the Fiat-Shamir transcript, so
            # match it.
            proof_stream.enqueue(ProofItem("Polynomial",
                                           gfx.to_tuples(ntt.intt(last_cw))))

        # query phase
        a_indices = proof_stream.sample_indices(
            self.domain.length, self.num_collinearity_checks)
        with profiler.device_span("FRI inclusion proofs", "LDT", dev):
            self._reveal(proof_stream, rounds[0], a_indices)
            for round_number in range(len(rounds) - 1):
                domain_r, _, _ = rounds[round_number]
                b_indices = [(a + domain_r.length // 2) % domain_r.length
                             for a in a_indices]
                self._reveal(proof_stream, rounds[round_number], b_indices)

        # transcript parity: sample & discard the verifier's barycentric
        # indeterminate (fri.rs:764-769)
        proof_stream.sample_scalars(1)
        return a_indices

    def _reveal(self, proof_stream, round_data, indices):
        from ..ops import gfx

        _, cw, tree = round_data
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=cw.device)
        proof_stream.enqueue(ProofItem("FriResponse", {
            "queried_leaves": gfx.to_tuples(cw.index_select(1, idx)),
            "auth_structure": tree.authentication_structure(indices),
        }))

    # -------------------------------------------------------------- verifier

    def verify(self, proof_stream, device="cpu"):
        """Returns (first_round_indices, partial_first_codeword). The
        revealed paths and the last round's Merkle tree are rebuilt on
        `device` as one batch (one read of their roots on a card)."""
        num_rounds = self.num_rounds()
        # initialize: read merkle roots, sample folding challenges
        domains = [self.domain]
        roots = []
        challenges = []
        for r in range(num_rounds + 1):
            root = proof_stream.dequeue().expect("MerkleRoot")
            roots.append(root)
            if r < num_rounds:
                # every round that has a next round samples a folding
                # challenge right after its root (fri.rs:414-447)
                challenges.append(proof_stream.sample_scalars(1)[0])
                domains.append(domains[-1].pow(2))
        last_codeword = proof_stream.dequeue().expect("FriCodeword")
        last_poly = proof_stream.dequeue().expect("Polynomial")
        if len(last_codeword) != domains[-1].length:
            raise LdtError("last codeword length mismatch")

        a_indices = proof_stream.sample_indices(
            self.domain.length, self.num_collinearity_checks)

        # receive the partial codewords, then authenticate them and the
        # last codeword (its whole tree: every leaf, no authentication
        # node) as one batch on `device`
        partial_a = [None] * (num_rounds + 1)
        partial_b = [None] * (num_rounds + 1)
        response = proof_stream.dequeue().expect("FriResponse")
        partial_a[0] = response["queried_leaves"]
        trees = [(roots[0], domains[0].length, a_indices, partial_a[0],
                  response["auth_structure"])]
        for r in range(num_rounds):
            b_indices = [(a + domains[r].length // 2) % domains[r].length
                         for a in a_indices]
            response = proof_stream.dequeue().expect("FriResponse")
            partial_b[r] = response["queried_leaves"]
            trees.append((roots[r], domains[r].length, b_indices,
                          partial_b[r], response["auth_structure"]))
        last_n = domains[-1].length
        trees.append((roots[-1], last_n, range(last_n), last_codeword, []))
        ok = merkle.verify_authentication_structures(
            [(tuple(root), n, idx, [xfe_to_digest(x) for x in leaves], auth)
             for root, n, idx, leaves, auth in trees], device)
        if not all(ok[:-1]):
            raise LdtError("bad merkle authentication path")
        if not ok[-1]:
            raise LdtError("bad merkle root for last codeword")

        # fold rounds
        for r in range(num_rounds):
            domain = domains[r]
            n = domain.length
            a_idx = [a % n for a in a_indices]
            b_idx = [(a + n // 2) % n for a in a_indices]
            ch = challenges[r]
            folded = []
            for i in range(self.num_collinearity_checks):
                ax = xfe.lift(domain.value(a_idx[i]))
                bx = xfe.lift(domain.value(b_idx[i]))
                ay, by = partial_a[r][i], partial_b[r][i]
                folded.append(_colinear_y((ax, ay), (bx, by), ch))
            partial_a[r + 1] = folded

        last_a_idx = [a % last_n for a in a_indices]
        received = [last_codeword[i] for i in last_a_idx]
        if received != partial_a[num_rounds]:
            raise LdtError("last codeword disagrees with folded codeword")
        if poly.degree(last_poly, xfe) > self.last_round_max_degree():
            raise LdtError("last round polynomial has too high degree")
        indeterminate = proof_stream.sample_scalars(1)[0]
        horner = poly.evaluate(last_poly, indeterminate, xfe)
        bary = poly.barycentric_evaluate(last_codeword, indeterminate)
        if horner != bary:
            raise LdtError("last round polynomial evaluation mismatch")

        first_a_indices = [a % self.domain.length for a in a_indices]
        return first_a_indices, partial_a[0]


def _fold(domain: Domain, cw, challenge):
    """Split-and-fold (fri.rs:349-366) of an XFE codeword (3, n):
    fold_i = ((c_i + c_j) + beta * x_i^-1 * (c_i - c_j)) / 2, j = i + n/2."""
    from ..ops import gf, gfx

    half = domain.length // 2
    # x_i^-1 = offset^-1 * g^-i: the inverses as a power ladder
    xs_inv = gf.powers(bfe.inv(domain.generator), half,
                       bfe.inv(domain.offset), cw.device)
    beta = gfx.full((1,), tuple(challenge), cw.device)
    left, right = cw[:, :half], cw[:, half:]
    scaled = gfx.bfe_mul(gfx.mul(beta, gfx.sub(left, right)), xs_inv)
    two_inv = gf.full((1,), pow(2, P - 2, P), cw.device)
    return gfx.bfe_mul(gfx.add(gfx.add(left, right), scaled), two_inv)


def _colinear_y(point_a, point_b, x):
    """y-coordinate at x of the line through a and b."""
    (ax, ay), (bx, by) = point_a, point_b
    dy = xfe.sub(by, ay)
    dx = xfe.sub(bx, ax)
    slope = xfe.mul(dy, xfe.inv(dx))
    return xfe.add(ay, xfe.mul(slope, xfe.sub(x, ax)))
