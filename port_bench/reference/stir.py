"""The STIR verifier ("Shift To Improve Rate", eprint 2024/390), as
triton-vm/src/low_degree_test/stir.rs:995-1323 checks a proof: parameter
and query-count derivation (stir.rs:59-106, 437-559, 597-870), the
per-round folding of the revealed cosets, quotienting by the in- and
out-of-domain answers, degree correction, and the final polynomial."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import merkle, poly, tip5, xfe
from .bfe import P
from .code import ReedSolomonCode, log2_binomial_coefficient
from .domain import Domain
from .fri import GENERATOR, LdtError

LOG2_FIELD_SIZE = 8 * 8 * 3  # stir.rs:411-412 (BYTES * 8 * EXTENSION_DEGREE)
LOG2_DOMAIN_SHRINKAGE = 1  # stir.rs:421


@dataclass(frozen=True)
class StirParameters:
    """stir.rs:59-106."""

    security_level: int
    log2_folding_factor: int
    log2_initial_expansion_factor: int
    log2_high_degree_bound: int
    soundness: str = "proven"

    def max_degree(self) -> int:
        return (1 << self.log2_high_degree_bound) - 1

    def expansion_factor(self) -> int:
        return 1 << self.log2_initial_expansion_factor

    # ---------------------------------------------------- query counts

    def _num_unique_in_domain_queries(self, log2_expansion_factor) -> int:
        """stir.rs:633-639."""
        code = ReedSolomonCode(log2_expansion_factor, self.soundness)
        delta = code.proximity_parameter()
        return math.ceil(-float(self.security_level)
                         / math.log2(1.0 - delta))

    def _num_total_in_domain_queries(self, log2_domain_len, k) -> int:
        """stir.rs:758-778: oversampling so >= k unique folded indices
        survive with probability 1 - 2^-security_level."""
        k_minus_1 = k - 1
        assert k_minus_1 >= 0, "too few queries"
        domain_len = 1 << log2_domain_len
        ell = min(k_minus_1, domain_len // 2)
        log2_u_choose_l = log2_binomial_coefficient(domain_len, ell)
        log2_k_minus_1 = max(math.log2(k_minus_1) if k_minus_1 else 0.0, 0.0)
        n = ((float(self.security_level) + log2_k_minus_1 + log2_u_choose_l)
             / (float(log2_domain_len) - log2_k_minus_1))
        return math.ceil(n)

    def num_in_domain_queries(self, log2_domain_size,
                              log2_expansion_factor) -> int:
        """stir.rs:597-609. `log2_domain_size` is of the FOLDED domain."""
        uniques = self._num_unique_in_domain_queries(log2_expansion_factor)
        uniques = min(uniques, 1 << log2_domain_size)
        return self._num_total_in_domain_queries(log2_domain_size, uniques)

    def num_ood_queries(self, log2_poly_degree,
                        log2_expansion_factor) -> int:
        """stir.rs:831-852 (Lemma 4.5 of the STIR paper)."""
        code = ReedSolomonCode(log2_expansion_factor, self.soundness)
        log2_list_size = code.log2_list_size(log2_poly_degree)
        s = ((float(self.security_level) - 1.0 + 2.0 * log2_list_size)
             / float(LOG2_FIELD_SIZE - log2_poly_degree))
        return math.ceil(s)


class Stir:
    """stir.rs:112-147 + setup at :437-559."""

    def __init__(self, params: StirParameters):
        if params.log2_folding_factor < 2:
            raise LdtError("log2 folding factor must be >= 2")
        if params.log2_initial_expansion_factor == 0:
            raise LdtError("expansion factor too small")
        if params.log2_high_degree_bound < params.log2_folding_factor:
            raise LdtError("high-degree bound below folding factor")

        self.params = params
        k = 1 << params.log2_folding_factor
        self.folding_factor = k

        folded_poly_degree = params.max_degree() // k
        log2_expansion = params.log2_initial_expansion_factor
        log2_domain_len = (params.log2_high_degree_bound
                           + params.log2_initial_expansion_factor)
        self.domain = Domain(1 << log2_domain_len, GENERATOR)
        log2_folded_domain = log2_domain_len - params.log2_folding_factor
        self.round_queries: list[tuple[int, int]] = []  # (in_domain, ood)

        while folded_poly_degree > k:
            in_domain = params.num_in_domain_queries(
                log2_folded_domain, log2_expansion)
            log2_next_expansion = (log2_expansion
                                   + params.log2_folding_factor
                                   - LOG2_DOMAIN_SHRINKAGE)
            log2_folded_poly_degree = folded_poly_degree.bit_length() - 1
            out_of_domain = params.num_ood_queries(
                log2_folded_poly_degree, log2_next_expansion)

            # stop before the quotient collapses to zero (stir.rs:502-541)
            next_folded_poly_deg = folded_poly_degree // k
            if in_domain + out_of_domain > next_folded_poly_deg:
                break
            self.round_queries.append((in_domain, out_of_domain))
            folded_poly_degree = next_folded_poly_deg
            log2_expansion = log2_next_expansion
            log2_folded_domain -= LOG2_DOMAIN_SHRINKAGE

        self.final_num_in_domain_queries = params.num_in_domain_queries(
            log2_folded_domain, log2_expansion)
        self.final_degree = folded_poly_degree

    # -------------------------------------------------- LowDegreeTest

    def initial_domain(self) -> Domain:
        return self.domain

    def num_first_round_queries(self) -> int:
        if self.round_queries:
            return self.round_queries[0][0]
        return self.final_num_in_domain_queries

    @staticmethod
    def next_round_domain(domain: Domain) -> Domain:
        """stir.rs:1149-1155: halve, then shift by the previous offset."""
        nxt = domain.pow(1 << LOG2_DOMAIN_SHRINKAGE)
        return Domain(nxt.length, nxt.offset * domain.offset % P)

    def verify(self, proof_stream):
        """stir.rs:995-1110. Returns (first_round_indices,
        partial_first_codeword) like Fri.verify."""
        domain = self.domain
        partial_first_codeword = None
        first_round_indices = None
        prev_quotienting = None
        prev_root = proof_stream.dequeue().expect("MerkleRoot")

        for in_domain, out_of_domain in self.round_queries:
            folding_randomness = proof_stream.sample_scalars(1)[0]
            cur_root = proof_stream.dequeue().expect("MerkleRoot")
            ood_queries = proof_stream.sample_scalars(out_of_domain)
            ood_answers = proof_stream.dequeue().expect(
                "StirOutOfDomainValues")
            queries, raw_indices = self._extract_inclusion_proof(
                proof_stream, domain, in_domain, prev_root)
            if partial_first_codeword is None:
                partial_first_codeword = self._partial_codeword(
                    domain, queries)
                first_round_indices = raw_indices

            if prev_quotienting is None:
                answers = _initial_in_domain_answers(
                    queries, folding_randomness)
            else:
                answers = _subsequent_in_domain_answers(
                    prev_quotienting, queries, folding_randomness)

            # de-duplicate by query point (stir.rs:1026-1033)
            quotient_set, quotient_answers = [], []
            seen = set()
            all_points = ([xfe.lift(q["point"]) for q in queries]
                          + list(ood_queries))
            all_answers = list(answers) + list(ood_answers)
            for pt, ans in zip(all_points, all_answers):
                if pt in seen:
                    continue
                seen.add(pt)
                quotient_set.append(pt)
                quotient_answers.append(ans)
            dc_randomness = proof_stream.sample_scalars(1)[0]
            prev_quotienting = (quotient_set, quotient_answers,
                                dc_randomness)
            domain = self.next_round_domain(domain)
            prev_root = cur_root

        folding_randomness = proof_stream.sample_scalars(1)[0]
        final_poly = proof_stream.dequeue().expect("Polynomial")
        if poly.degree(final_poly, xfe) > self.final_degree:
            raise LdtError("last round polynomial has too high degree")

        queries, raw_indices = self._extract_inclusion_proof(
            proof_stream, domain, self.final_num_in_domain_queries,
            prev_root)
        if prev_quotienting is None:
            final_answers = _initial_in_domain_answers(
                queries, folding_randomness)
        else:
            final_answers = _subsequent_in_domain_answers(
                prev_quotienting, queries, folding_randomness)
        for q, answer in zip(queries, final_answers):
            evaluation = poly.evaluate(final_poly, xfe.lift(q["point"]),
                                       xfe)
            if answer != evaluation:
                raise LdtError("last round polynomial evaluation mismatch")

        if partial_first_codeword is None:
            partial_first_codeword = self._partial_codeword(domain, queries)
            first_round_indices = raw_indices
        return first_round_indices, partial_first_codeword

    # ---------------------------------------------------------- helpers

    def _extract_inclusion_proof(self, proof_stream, round_domain,
                                 num_queries, root):
        """stir.rs:1157-1243: sample indices, dequeue + authenticate the
        response, and assemble per-query data."""
        k = self.folding_factor
        queried_indices = proof_stream.sample_indices(
            round_domain.length, num_queries)
        response = proof_stream.dequeue().expect("StirResponse")
        queried_leaves = response["queried_leaves"]
        auth_structure = response["auth_structure"]

        folded_domain = round_domain.pow(k)
        folded_len = folded_domain.length
        folded_indices = _unique(i % folded_len for i in queried_indices)
        if len(queried_leaves) != len(folded_indices):
            raise LdtError("incorrect number of revealed leaves")
        if any(len(leaf) != k for leaf in queried_leaves):
            raise LdtError("revealed leaf of the wrong size")

        rows = np.array(queried_leaves, np.uint64).reshape(
            len(queried_leaves), 3 * k)
        digests = tip5.hash_varlen_rows(rows)
        if not merkle.verify(root, folded_len, folded_indices, digests,
                             auth_structure):
            raise LdtError("bad STIR merkle authentication")

        by_folded = dict(zip(folded_indices, queried_leaves))
        kth_root = pow(round_domain.generator, folded_len, P)
        queries = []
        for index in queried_indices:
            qi = index % folded_len
            queries.append({
                "index": index,
                "point": folded_domain.value(qi),
                "root": round_domain.value(qi),
                "kth_root": kth_root,
                "values": by_folded[qi],
            })
        return queries, queried_indices

    def _partial_codeword(self, domain, queries):
        """stir.rs:1245-1257: pick the one revealed element per query that
        corresponds to the raw (unfolded) index."""
        folded_len = domain.pow(self.folding_factor).length
        return [tuple(q["values"][q["index"] // folded_len])
                for q in queries]


def _unique(it):
    seen = set()
    out = []
    for x in it:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def _coset_interpolate(root_bfe, values):
    """Polynomial through (root*omega_k^j, values[j]); k is tiny (the
    folding factor), so Lagrange interpolation is fine."""
    kk = len(values)
    omega = Domain(kk).generator
    pts = [xfe.lift(root_bfe * pow(omega, j, P) % P) for j in range(kk)]
    return poly.interpolate(pts, list(values), xfe)


def _initial_in_domain_answers(queries, folding_randomness):
    """stir.rs:1259-1272."""
    out = []
    for q in queries:
        p = _coset_interpolate(q["root"], q["values"])
        out.append(poly.evaluate(p, folding_randomness, xfe))
    return out


def _subsequent_in_domain_answers(quotienting, queries,
                                  folding_randomness):
    """stir.rs:1275-1323: quotient + degree-correct the revealed coset
    values, then fold."""
    quotient_set, quotient_answers, dc_randomness = quotienting
    answer_poly = poly.interpolate(quotient_set, quotient_answers, xfe)
    zerofier = poly.zerofier(quotient_set, xfe)
    degree_difference = len(quotient_set) + 1

    out = []
    for q in queries:
        coset_evaluations = []
        current_root = q["root"]
        for evaluation in q["values"]:
            ans = poly.evaluate(answer_poly, xfe.lift(current_root), xfe)
            z = poly.evaluate(zerofier, xfe.lift(current_root), xfe)
            quotient = xfe.mul(xfe.sub(tuple(evaluation), ans), xfe.inv(z))

            common = xfe.bfe_mul(dc_randomness, current_root)
            if common == xfe.ONE:
                dc_factor = xfe.lift(degree_difference % P)
            else:
                num = xfe.sub(xfe.ONE, xfe.mod_pow(common,
                                                   degree_difference))
                dc_factor = xfe.mul(num, xfe.inv(xfe.sub(xfe.ONE, common)))
            coset_evaluations.append(xfe.mul(dc_factor, quotient))
            current_root = current_root * q["kth_root"] % P
        p = _coset_interpolate(q["root"], coset_evaluations)
        out.append(poly.evaluate(p, folding_randomness, xfe))
    return out
