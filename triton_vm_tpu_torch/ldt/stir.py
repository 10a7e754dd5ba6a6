"""STIR ("Shift To Improve Rate") low-degree test.

Transcribed from triton-vm/src/low_degree_test/stir.rs (eprint 2024/390);
the counterpart of `triton_vm_tpu.ldt.stir`, whose transcript it
reproduces word for word. Per full round, the committed codeword is k-wise
folded, re-evaluated over a 2x-smaller shifted domain, quotiented by the
interpolant through all in- and out-of-domain queries, and
degree-corrected; the final round sends the folded polynomial in the
clear. Fiat-Shamir order, query-count derivations (including the
oversampling margin for unique folded indices) and the Merkle leaf
stacking follow the reference.

Compute placement: the prover keeps the codeword and its coefficients on
the codeword's device the whole way (k-wise fold, NTT re-evaluation, and
the quotient by the round's points in the NEXT evaluation domain). The
folded polynomial's values at the queried points come from one forward
transform onto the folded domain and a gather, its values at the
out-of-domain samples from power tables built on the host. The
interpolant through a round's points and their zerofier are coefficients:
the zerofier from a product tree in base-field arithmetic on the host,
the interpolant from two transforms onto the folded domain and a few
batched products on the device; one transform of the two with the degree
correction evaluates them on the next domain. Leaf rows are hashed by the
K2 row sponge and the trees built by K1 (ops/tip5_kernel.py).

The verifier hashes the revealed leaves in one batch on its device and
checks their Merkle paths on the host. Each round's answers at the
revealed coset points are a few batched operations: the previous round's
interpolant and zerofier from the prover's own helpers, evaluated on the
round's domain by one transform and gathered at every revealed point;
the quotient, degree correction and k-point fold (an inverse DFT of each
coset) in host numpy over all points at once; the last round's
polynomial at every query from one power table. Prover and verifier are
timed in spans within their `LDT` stage (`profiler.device_span`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import merkle
from ..fields import bfe, poly, xfe
from ..fields.bfe import P
from ..ops import gf, gfx, ntt, ntt_sharded, tip5_kernel
from ..ops import npfield as nf
from ..stark.arithmetic_domain import Domain
from ..stark.proof_item import ProofItem
from ..utils import profiler
from .code import ReedSolomonCode, log2_binomial_coefficient
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

    @staticmethod
    def fold_polynomial(coeffs, k, randomness):
        """stir.rs:1132-1147 on host lists: chunk coefficients k-wise,
        Horner-evaluate each chunk at the folding randomness (the oracle of
        `_fold_device`)."""
        out = []
        for i in range(0, max(len(coeffs), 1), k):
            out.append(poly.evaluate(coeffs[i:i + k], randomness, xfe))
        return out

    # ------------------------------------------------------------ prove

    def prove(self, codeword, proof_stream) -> list[int]:
        """stir.rs:885-993 on the device of `codeword`, an XFE tensor
        (3, n). Returns the first round's raw query indices.

        The quotient is computed in the NEXT evaluation domain: exact,
        because deg(quotient * degree correction) < |next domain| and the
        quotient points avoid that domain (domain offsets are powers of the
        field generator, whose order divides no power of 2). Each round
        checks it: if a sampled out-of-domain query or a queried point does
        land on the next domain (probability ~2^-170 per proof), this
        raises LdtError, as the JAX package's device loop does.

        A full round's m points are its queried points of the folded
        domain and its out-of-domain samples. The interpolant through them
        (`_interpolate_dev`) and their zerofier Z (`_zerofier`, deg Z = m)
        are coefficients, and one transform of three rows evaluates them
        and the degree correction on the next domain, where the quotient
        (f - interpolant) / Z * correction is pointwise."""
        domain = self.domain
        if codeword.shape[-1] != domain.length:
            raise LdtError("initial codeword length mismatch")
        k = self.folding_factor
        dev = codeword.device

        with profiler.device_span("STIR commit", "LDT", dev):
            commitment = _StirMerkleTreeDev(codeword, k)
            # tall transforms spread over an active mesh (TVM_MESH): the
            # six-step transform of ops/ntt_sharded.py
            coeffs = ntt_sharded.xfe_intt_auto(codeword, domain.offset)
        proof_stream.enqueue(ProofItem("MerkleRoot", commitment.root()))
        first_round_indices = None

        for in_domain, out_of_domain in self.round_queries:
            folding_randomness = proof_stream.sample_scalars(1)[0]
            next_domain = self.next_round_domain(domain)
            with profiler.device_span("STIR commit", "LDT", dev):
                folded = _fold_device(coeffs, k, folding_randomness)
                folded_evals = ntt_sharded.xfe_ntt_auto(
                    _pad_to(folded, next_domain.length), next_domain.offset)
                folded_commitment = _StirMerkleTreeDev(folded_evals, k)
            proof_stream.enqueue(ProofItem("MerkleRoot",
                                           folded_commitment.root()))

            ood_queries = proof_stream.sample_scalars(out_of_domain)
            if any(_point_on_domain(pt, next_domain) for pt in ood_queries):
                raise LdtError("OOD query on evaluation domain")
            with profiler.device_span("STIR point evaluation", "LDT", dev):
                ood_values = _eval_folded_at(folded, ood_queries)
            proof_stream.enqueue(ProofItem("StirOutOfDomainValues",
                                           list(ood_values)))

            queried_indices = proof_stream.sample_indices(
                domain.length, in_domain)
            folded_domain = domain.pow(k)
            folded_queried_indices = _unique(
                i % folded_domain.length for i in queried_indices)
            with profiler.device_span("STIR inclusion proofs", "LDT", dev):
                response = commitment.inclusion_proof(folded_queried_indices)
            proof_stream.enqueue(ProofItem("StirResponse", response))

            # witness polynomial for the next round (stir.rs:937-967)
            queried_points = [folded_domain.value(i)
                              for i in folded_queried_indices]
            if any(_point_on_domain(xfe.lift(pt), next_domain)
                   for pt in queried_points):
                raise LdtError("quotient point on evaluation domain")
            with profiler.device_span("STIR query evaluation", "LDT", dev):
                profiler.count("STIR queried points",
                               len(folded_queried_indices))
                in_domain_values = _eval_on_folded_domain(
                    folded, folded_domain, folded_queried_indices)
            with profiler.device_span("STIR zerofier", "LDT", dev):
                zerofier = _zerofier(queried_points, ood_queries)
            with profiler.device_span("STIR host interpolation", "LDT",
                                      dev):
                values = torch.cat([in_domain_values,
                                    _xfe_tensor(ood_values, dev)], dim=1)
                answer_poly = _interpolate_dev(
                    folded_domain, folded_queried_indices, ood_queries,
                    values, zerofier)

            dc_randomness = proof_stream.sample_scalars(1)[0]
            dc_coeffs = _powers(dc_randomness, values.shape[-1] + 1)
            with profiler.device_span("STIR quotient", "LDT", dev):
                ans_evals, dc_evals, z_evals = _eval_poly_on_domain_dev(
                    [answer_poly, dc_coeffs, zerofier[1]], next_domain, dev)
                next_vals = _quotient_next_vals(folded_evals, ans_evals,
                                                z_evals, dc_evals)
                coeffs = ntt_sharded.xfe_intt_auto(next_vals,
                                                   next_domain.offset)
            domain = next_domain
            commitment = folded_commitment
            if first_round_indices is None:
                first_round_indices = queried_indices

        # final round: no quotienting (stir.rs:976-992)
        folding_randomness = proof_stream.sample_scalars(1)[0]
        with profiler.device_span("STIR commit", "LDT", dev):
            final_poly = gfx.to_tuples(_fold_device(coeffs, k,
                                                    folding_randomness))
        proof_stream.enqueue(ProofItem(
            "Polynomial", [tuple(c) for c in poly.trim(final_poly, xfe)]))

        folded_domain = domain.pow(k)
        queried_indices = proof_stream.sample_indices(
            domain.length, self.final_num_in_domain_queries)
        folded_queried_indices = _unique(
            i % folded_domain.length for i in queried_indices)
        with profiler.device_span("STIR inclusion proofs", "LDT", dev):
            response = commitment.inclusion_proof(folded_queried_indices)
        proof_stream.enqueue(ProofItem("StirResponse", response))

        return (first_round_indices if first_round_indices is not None
                else queried_indices)

    # ----------------------------------------------------------- verify

    def verify(self, proof_stream, device="cpu"):
        """stir.rs:995-1110. The revealed leaves are hashed in one batch on
        `device` (`STIR verify inclusion proofs`); each round's answers at
        its revealed coset points are a few batched operations
        (`_in_domain_answers`, `STIR verify answers`). Returns
        (first_round_indices, partial_first_codeword) like Fri.verify."""
        dev = torch.device(device)
        k = self.folding_factor
        domain = self.domain
        partial_first_codeword = None
        first_round_indices = None
        quotienting = None
        prev_root = proof_stream.dequeue().expect("MerkleRoot")

        for in_domain, out_of_domain in self.round_queries:
            folding_randomness = proof_stream.sample_scalars(1)[0]
            cur_root = proof_stream.dequeue().expect("MerkleRoot")
            ood_queries = proof_stream.sample_scalars(out_of_domain)
            ood_answers = proof_stream.dequeue().expect(
                "StirOutOfDomainValues")
            with profiler.device_span("STIR verify inclusion proofs", "LDT",
                                      dev):
                queries, raw_indices = self._extract_inclusion_proof(
                    proof_stream, domain, in_domain, prev_root, device)
            if partial_first_codeword is None:
                partial_first_codeword = self._partial_codeword(
                    domain, queries)
                first_round_indices = raw_indices

            with profiler.device_span("STIR verify answers", "LDT", dev):
                answers = _in_domain_answers(domain, k, queries,
                                             folding_randomness, quotienting,
                                             dev)
            dc_randomness = proof_stream.sample_scalars(1)[0]
            quotienting = _Quotienting.of(domain.pow(k), queries, answers,
                                          ood_queries, ood_answers,
                                          dc_randomness)
            domain = self.next_round_domain(domain)
            prev_root = cur_root

        folding_randomness = proof_stream.sample_scalars(1)[0]
        final_poly = proof_stream.dequeue().expect("Polynomial")
        if poly.degree(final_poly, xfe) > self.final_degree:
            raise LdtError("last round polynomial has too high degree")

        with profiler.device_span("STIR verify inclusion proofs", "LDT", dev):
            queries, raw_indices = self._extract_inclusion_proof(
                proof_stream, domain, self.final_num_in_domain_queries,
                prev_root, device)
        with profiler.device_span("STIR verify answers", "LDT", dev):
            final_answers = _in_domain_answers(domain, k, queries,
                                               folding_randomness,
                                               quotienting, dev)
            _check_last_round(final_poly, queries, final_answers)

        if partial_first_codeword is None:
            partial_first_codeword = self._partial_codeword(domain, queries)
            first_round_indices = raw_indices
        return first_round_indices, partial_first_codeword

    # ---------------------------------------------------------- helpers

    def _extract_inclusion_proof(self, proof_stream, round_domain,
                                 num_queries, root, device):
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
        digests = tip5_kernel.sponge_absorb_rows(gf.from_u64(rows, device))
        if not merkle.verify_authentication_structure(
                root, folded_len, folded_indices, digests, auth_structure):
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


def _powers(x, n):
    out = [xfe.ONE]
    for _ in range(n - 1):
        out.append(xfe.mul(out[-1], x))
    return out


@dataclass(frozen=True)
class _Quotienting:
    """A full round's quotient set as the next round's answers need it:
    the kept points of the round's folded domain `domain` by index
    (`indices`), then the kept out-of-domain samples `ood` (XFE tuples),
    their answers in that order (u64 (m, 3)) and the round's
    degree-correction randomness."""

    domain: Domain
    indices: list
    ood: list
    answers: np.ndarray
    dc_randomness: tuple

    @staticmethod
    def of(folded_domain: Domain, queries, answers, ood_queries,
           ood_answers, dc_randomness):
        """The queried points and then the OOD samples, de-duplicated by
        point (stir.rs:1026-1033): a repeated folded index, or an OOD
        sample equal to a kept point, is dropped with its answer."""
        seen, indices, rows, ood = set(), [], [], []
        for q, ans in zip(queries, answers):
            pt = xfe.lift(q["point"])
            if pt not in seen:
                seen.add(pt)
                indices.append(q["index"] % folded_domain.length)
                rows.append(ans)
        for pt, ans in zip(ood_queries, ood_answers):
            pt = tuple(pt)
            if pt not in seen:
                seen.add(pt)
                ood.append(pt)
                rows.append(ans)
        return _Quotienting(folded_domain, indices, ood,
                            np.asarray(rows, np.uint64).reshape(-1, 3),
                            tuple(dc_randomness))


def _in_domain_answers(round_domain: Domain, k, queries, folding_randomness,
                       quotienting, device):
    """stir.rs:1259-1323: the folded answer of each query, u64 (Q, 3).

    A query reveals the values e_j at its coset's points
    x_j = root * omega_k^j, which are `round_domain.value(i + j n/k)` for
    its folded index i. After a full round (`quotienting`), each e_j is
    first replaced by the quotient (e_j - A(x_j)) / Z(x_j), degree-
    corrected (`_quotient_coset_values`). Then the interpolant through the
    coset is evaluated at the folding randomness: one inverse DFT over the
    k values of every query at once (`_fold_cosets`). Field arithmetic is
    exact, so the answers equal the scalar ones of stir.rs word for word.
    Counts the revealed points answered (`STIR answered points`)."""
    values = np.asarray([q["values"] for q in queries],
                        np.uint64).reshape(len(queries), k, 3)
    roots = np.asarray([q["root"] for q in queries], np.uint64)
    if quotienting is not None:
        folded_len = round_domain.length // k
        indices = np.asarray([q["index"] % folded_len for q in queries])
        points = nf.bfe_mul(roots[:, None], nf.powers_u64(
            pow(round_domain.generator, folded_len, P), 1, k)[None])
        values = _quotient_coset_values(
            quotienting, values, round_domain,
            indices[:, None] + folded_len * np.arange(k), points, device)
    profiler.count("STIR answered points", values.shape[0] * k)
    return _fold_cosets(values, roots, folding_randomness)


def _quotient_coset_values(quotienting: _Quotienting, values, round_domain,
                           indices, points, device):
    """(v - A(x)) / Z(x) * (1 - c^d) / (1 - c), u64 (Q, k, 3), for the
    revealed values v (Q, k, 3) at the base-field points x (`points`, the
    words `indices` of `round_domain`), with A and Z the previous round's
    interpolant and zerofier, c = dc_randomness * x and d = m + 1 for m
    points in the quotient set; the factor is d where c = 1.

    A and Z are coefficients (`_zerofier`, `_interpolate_dev`, on
    `device`, as the prover builds them), evaluated on the whole round
    domain by one transform (`_eval_poly_on_domain_dev`, the prover's
    `STIR quotient` transform), gathered at the revealed points and read
    once. The rest is numpy over all points at once: c^d =
    dc_randomness^d x^d, and one batched inversion of Z(x) and 1 - c
    (`npfield.xfe_inv`), which raises ZeroDivisionError where Z(x) = 0, as
    `xfe.inv` does."""
    q = quotienting
    shape = values.shape
    base = [q.domain.value(i) for i in q.indices]
    zerofier = _zerofier(base, q.ood)
    answer_poly = _interpolate_dev(q.domain, q.indices, q.ood,
                                   _xfe_tensor(q.answers, device), zerofier)
    evals = _eval_poly_on_domain_dev([answer_poly, zerofier[1]],
                                     round_domain, device)
    idx = torch.as_tensor(indices.reshape(-1), dtype=torch.int64,
                          device=device)
    ans, z = gfx.to_u64(torch.stack([e.index_select(1, idx) for e in evals],
                                    dim=1)).reshape((2,) + shape)

    x = points
    d = len(q.answers) + 1
    dc = np.asarray(q.dc_randomness, np.uint64)
    one_minus_c = nf.xfe_sub(nf.lift(np.ones_like(x)), nf.xfe_bfe_mul(dc, x))
    c_is_one = ~one_minus_c.any(axis=-1)
    one_minus_c[c_is_one] = nf.lift(np.uint64(1))
    c_pow_d = nf.xfe_bfe_mul(np.asarray(xfe.mod_pow(q.dc_randomness, d),
                                        np.uint64), nf.bfe_pow(x, d))
    z_inv, den_inv = nf.xfe_inv(np.stack([z, one_minus_c]))
    factor = nf.xfe_mul(nf.xfe_sub(nf.lift(np.ones_like(x)), c_pow_d),
                        den_inv)
    factor[c_is_one] = nf.lift(np.uint64(d % P))
    return nf.xfe_mul(factor, nf.xfe_mul(nf.xfe_sub(values, ans), z_inv))


def _fold_cosets(values, roots, folding_randomness):
    """The interpolant through (root * omega_k^j, e_j), j < k, evaluated
    at the folding randomness r, for every query: `values` u64 (Q, k, 3)
    the e_j, `roots` u64 (Q,). Its coefficients are c_i = k^-1 root^-i
    sum_j e_j omega_k^(-ij), an inverse DFT of the coset's values, so the
    answer is sum_i c_i r^i: no division by a difference of points, and
    the roots' inverses come from one batch inversion. Returns u64
    (Q, 3)."""
    k = values.shape[1]
    omega_inv = bfe.inv(Domain(k).generator)
    k_inv = bfe.inv(k)
    idft = np.array([[k_inv * pow(omega_inv, i * j, P) % P
                      for j in range(k)] for i in range(k)], np.uint64)
    coeffs = nf.bfe_sum(nf.bfe_mul(idft[None, :, :, None],
                                   values[:, None]), 2)       # (Q, k, 3)
    root_inv = np.asarray(bfe.batch_inverse([int(r) for r in roots]),
                          np.uint64)
    scale = np.ones(roots.shape + (k,), np.uint64)
    for i in range(1, k):
        scale[:, i] = nf.bfe_mul(scale[:, i - 1], root_inv)
    r_powers = np.asarray(_powers(tuple(folding_randomness), k), np.uint64)
    return nf.xfe_sum(nf.xfe_mul(nf.xfe_bfe_mul(coeffs, scale),
                                 r_powers[None]), 1)


def _check_last_round(final_poly, queries, answers):
    """stir.rs:1098-1104: the last round's polynomial at every query's
    folded point equals its answer (u64 (Q, 3)); raises LdtError on any
    mismatch."""
    evaluations = _evaluate_at_bfes(final_poly, [q["point"] for q in queries])
    if not np.array_equal(answers, evaluations):
        raise LdtError("last round polynomial evaluation mismatch")


def _evaluate_at_bfes(coeffs, points):
    """The XFE polynomial `coeffs` (host tuples, low to high) at the
    base-field points `points`, u64 (len(points), 3): a power table of the
    points built by doubling (log2 of the length numpy products), one
    product by the coefficients and one sum."""
    coeffs = np.asarray(coeffs or [xfe.ZERO], np.uint64).reshape(-1, 3)
    x = np.asarray(points, np.uint64)
    table = np.ones((len(x), len(coeffs)), np.uint64)
    step, x_step = 1, x
    while step < len(coeffs):
        n = min(step, len(coeffs) - step)
        table[:, step:step + n] = nf.bfe_mul(table[:, :n], x_step[:, None])
        step, x_step = 2 * step, nf.bfe_mul(x_step, x_step)
    return nf.xfe_sum(nf.xfe_bfe_mul(coeffs[None], table), 1)


# ------------------------------------------------------ device prove pieces


def _pad_to(v, n):
    """Zero-pad the last axis of v to length n."""
    if v.shape[-1] == n:
        return v
    out = torch.zeros(v.shape[:-1] + (n,), dtype=v.dtype, device=v.device)
    out[..., :v.shape[-1]] = v
    return out


def _xfe_tensor(values, device):
    """Host XFE tuples (or a numpy u64 (k, 3) array) -> XFE (3, k)."""
    return gfx.from_u64(np.asarray(values, np.uint64).reshape(-1, 3),
                        device)


def _fold_device(coeffs, k, randomness):
    """Fold XFE coefficients (3, n) k-wise at `randomness` (a host XFE):
    Horner over each k-chunk, the device form of `Stir.fold_polynomial`.
    Returns XFE (3, n / k)."""
    chunks = coeffs.reshape(3, -1, k)
    r = gfx.full((1,), tuple(randomness), coeffs.device)    # XFE (3, 1)
    acc = chunks[..., k - 1]
    for t in range(k - 2, -1, -1):
        acc = gfx.add(gfx.mul(acc, r), chunks[..., t])
    return acc


def _mul_matrices(a):
    """M(a) (..., 3, 3) u64 for host XFE a (tuples, or u64 (..., 3)): the
    base-field matrix with M(a) @ b = a * b, the product of fields/xfe.py
    reduced by x^3 = x - 1."""
    a = np.asarray(a, np.uint64)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    zero = np.zeros_like(a0)
    a02 = nf.bfe_add(a0, a2)
    return np.stack([
        np.stack([a0, nf.bfe_sub(zero, a2), nf.bfe_sub(zero, a1)], -1),
        np.stack([a1, a02, nf.bfe_sub(a1, a2)], -1),
        np.stack([a2, a1, a02], -1)], -2)


def _xfe_apply(mats, v):
    """sum_k a_k * v[:, ..., k] for host XFE constants a_k, given as their
    matrices `mats` (..., K, 3, 3) (`_mul_matrices`), and an XFE tensor v
    (3, ..., K), the leading axes broadcast: one base-field product and
    one `gf.reduce_sum` over the 3K words of each sum, where `gfx.mul`
    would take nine products and their sums. Returns XFE (3, ...)."""
    m = np.moveaxis(mats, -2, 0)                         # (3, ..., K, 3)
    m = np.swapaxes(m, -1, -2).reshape(m.shape[:-2] + (-1,))  # (3, ..., 3K)
    w = v.movedim(0, -2).reshape(v.shape[1:-1] + (-1,))     # (..., 3K)
    return gf.reduce_sum(gf.mul(gf.from_u64(m, v.device), w[None]), -1)


def _eval_folded_at(coeffs, points):
    """Evaluate the polynomial with coefficients `coeffs` (XFE (3, n), low
    to high) at host XFE points; returns host XFE tuples.

    With B ~ sqrt(n) and the coefficients as an (n/B, B) block,
    f(x) = sum_j x^(Bj) * sum_t c[Bj + t] x^t. The powers x^t (t < B) and
    x^(Bj) are host tables, B + n/B XFE products a point; on the device
    each of the two sums is one product by a table and one
    `gf.reduce_sum` (`_xfe_apply`), the inner one over blocks of rows
    (`gf.block_rows`). The values are read once. Field arithmetic is
    exact, so they equal `poly.evaluate`'s."""
    if not points:
        return []
    n = 1 << (coeffs.shape[-1] - 1).bit_length()
    B = 1 << ((n.bit_length() - 1) // 2)
    blocks = _pad_to(coeffs, n).reshape(3, n // B, B)
    step = gf.block_rows(9 * B)
    out = []
    for x in points:
        small = _powers(x, B)
        large = _mul_matrices(_powers(xfe.mul(small[-1], x), n // B))
        small = _mul_matrices(small)[None]
        inner = torch.cat([_xfe_apply(small, blocks[:, s:s + step])
                           for s in range(0, n // B, step)], dim=-1)
        out.append(_xfe_apply(large, inner))
    return gfx.to_tuples(torch.stack(out, dim=-1))


def _eval_on_folded_domain(folded, folded_domain: Domain, indices):
    """The values of the polynomial with coefficients `folded` (XFE (3, n),
    low to high) at `folded_domain.value(i)` for each i in `indices`, an
    XFE tensor (3, len(indices)) on its device. n must be the folded
    domain's length: the values are entries of one forward transform of
    `folded` onto that domain (K4 on a card, spread over an active mesh
    when tall), gathered on the device."""
    if folded.shape[-1] != folded_domain.length:
        raise LdtError(f"{folded.shape[-1]} folded coefficients for a "
                       f"folded domain of {folded_domain.length} points")
    evals = ntt_sharded.xfe_ntt_auto(folded, folded_domain.offset)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=folded.device)
    return evals.index_select(1, idx)


def _bfe_zerofier(roots):
    """prod (x - r) over base-field ints `roots`: its coefficients, u64
    (len(roots) + 1,), low to high. A product tree: the roots padded to a
    power of 2 with zeros, each factor monic and kept as its low
    coefficients, and at each level the products of all pairs at once,
    (x^h + a)(x^h + b) = x^2h + x^h (a + b) + ab, with ab one outer
    product and its anti-diagonal sums. The padding's factors x only
    shift the product, by as many places as are cut off at the end."""
    m = len(roots)
    size = 1 << max(m - 1, 0).bit_length()
    low = np.zeros((size, 1), np.uint64)
    low[:m, 0] = nf.bfe_sub(np.uint64(0), np.asarray(roots, np.uint64))
    while len(low) > 1:
        a, b = low[0::2], low[1::2]
        pairs, h = a.shape
        ab = np.zeros((pairs, h, 2 * h), np.uint64)
        diag = np.arange(h)[:, None] * (2 * h + 1) + np.arange(h)
        ab.reshape(pairs, -1)[:, diag] = nf.bfe_mul(a[:, :, None],
                                                    b[:, None, :])
        low = nf.bfe_sum(ab, 1)
        low[:, h:] = nf.bfe_add(low[:, h:], nf.bfe_add(a, b))
    return np.append(low[0], np.uint64(1))[size - m:]


def _zerofier(base, ood):
    """The zerofier prod (x - p) of the lifted base-field points `base`
    (ints) and the XFE points `ood`, as (zb, z), u64 coefficients low to
    high: zb (len(base) + 1,) the base points' factor (`_bfe_zerofier`), z
    (m + 1, 3) all of it, zb times one factor x - q a point of `ood`."""
    zb = _bfe_zerofier(base)
    z = nf.lift(zb)
    zero = np.zeros((1, 3), np.uint64)
    for q in ood:
        qz = nf.xfe_mul(z, np.asarray(q, np.uint64))
        z = nf.xfe_sub(np.concatenate([zero, z]), np.concatenate([qz, zero]))
    return zb, z


def _interpolate_dev(domain: Domain, indices, ood, values, zerofier):
    """The interpolant of degree < m through m points, as XFE coefficients
    (3, m), low to high, on the device of `values`: the points
    domain.value(i) for i in `indices` and then the XFE points `ood`,
    taking values[:, j] (XFE (3, m)) at the j-th of them; `zerofier` is
    `_zerofier`'s (zb, z) for them. Field arithmetic is exact, so the
    coefficients are `poly.interpolate`'s; a repeated point raises
    ZeroDivisionError, as there.

    The domain points b_i have the interpolant L = sum_i c_i zb / (x - b_i)
    with c_i = y_i / zb'(b_i). One transform onto the domain (K4 on a card)
    gives zb' there, gathered at the b_i and read once, so the host
    inverts the weights; a second, of the weighted values placed at their
    indices, gives the moments s_d = sum_i c_i b_i^d, d < len(indices); and
    L_k = sum_d s_d zb_(k+1+d) is one product by a block of zb's
    coefficients and one `gf.reduce_sum`. Each XFE point q then adds
    (v_q - L(q)) G_q with G_q = z / ((x - q) z'(q)), which is 1 at q and 0
    at every other point: O(m) host XFE products a point of `ood` (the
    powers of q, the division of z by x - q), the products by them on the
    device (`_xfe_apply`)."""
    dev = values.device
    zb, z = zerofier
    m_b, m = len(indices), values.shape[-1]
    out = gfx.zeros((m,), dev)
    if m_b:
        n, offset = domain.length, domain.offset
        idx = torch.as_tensor(indices, dtype=torch.int64, device=dev)
        d_zb = nf.bfe_mul(zb[1:], np.arange(1, m_b + 1, dtype=np.uint64))
        weights = gf.to_u64(ntt.ntt(gf.from_u64(d_zb, dev), offset,
                                    n).index_select(0, idx))
        # 1 / (zb'(b_i) offset^e_i), b_i = offset omega^e_i: the second
        # transform scales its word e by offset^e, so that its word d is
        # sum_i c_i omega^(e_i d)
        scale = bfe.batch_inverse([int(w) * pow(offset, i, P) % P
                                   for w, i in zip(weights, indices)])
        placed = gfx.zeros((n,), dev)
        placed[:, idx] = gf.mul(values[:, :m_b], gf.from_u64(scale, dev))
        s = gf.mul(ntt.ntt(placed, offset)[:, :m_b],
                   gf.from_u64(nf.powers_u64(offset, 1, m_b), dev))
        k = torch.arange(m_b, device=dev)
        k = k[:, None] + k[None, :] + 1
        shifts = torch.where(k <= m_b, gf.from_u64(zb, dev)[k.clamp(
            max=m_b)], 0)                        # zb_(k+1+d), (m_b, m_b)
        out[:, :m_b] = gf.reduce_sum(gf.mul(shifts, s[:, None, :]), -1)
    if ood:
        d = values[:, m_b:]
        if m_b:
            q_powers = _mul_matrices([_powers(q, m_b) for q in ood])
            d = gf.sub(d, _xfe_apply(q_powers, out[:, :m_b]))
        z_host = nf.to_tuples(z)
        g_rows = []
        for q in ood:
            quot = [z_host[-1]]                  # z / (x - q), high first
            for c in reversed(z_host[1:-1]):
                quot.append(xfe.add(c, xfe.mul(q, quot[-1])))
            quot.reverse()
            g = xfe.inv(poly.evaluate(quot, q, xfe))       # 1 / z'(q)
            g_rows.append([xfe.mul(g, c) for c in quot])
        g_cols = np.swapaxes(_mul_matrices(g_rows), 0, 1)   # (m, |ood|, ..)
        out = gf.add(out, _xfe_apply(g_cols, d))
    return out


def _eval_poly_on_domain_dev(polys, domain: Domain, device):
    """Evaluate XFE polynomials shorter than `domain` on every point of it:
    one batched transform of the coefficients, zero-padded (in the load of
    K4 on a card). A polynomial is a host list of XFE tuples, a u64 (k, 3)
    array, or an XFE tensor (3, k) on `device`. Returns XFE (3, n) per
    polynomial."""
    polys = [c if torch.is_tensor(c) else _xfe_tensor(c, device)
             for c in polys]
    longest = max(c.shape[-1] for c in polys)
    assert longest <= domain.length, \
        "polynomial longer than evaluation domain"
    rows = torch.stack([_pad_to(c, longest) for c in polys], dim=1)
    return ntt.ntt(rows, domain.offset, domain.length).unbind(1)


def _quotient_next_vals(folded_evals, ans_evals, z_evals, dc_evals):
    """The next round's codeword (f - ans) / Z * dc, pointwise."""
    num = gfx.sub(folded_evals, ans_evals)
    return gfx.mul(gfx.mul(num, gfx.inv(z_evals)), dc_evals)


def _point_on_domain(point, domain: Domain) -> bool:
    """Exact membership check of an XFE point in a base-field coset."""
    if point[1] or point[2]:
        return False
    x = point[0] * pow(domain.offset, P - 2, P) % P
    return pow(x, domain.length, P) == 1


class _StirMerkleTreeDev:
    """stir.rs:321-331,1374-1433 over a device codeword: leaves are
    k-element "stacks" of the codeword (stride d = n/k), row i =
    [cw[i], cw[i+d], ..., cw[i+(k-1)d]] with each XFE flattened, 3k words.
    The rows are built with one permute-and-copy, hashed by the K2 row
    sponge and the tree built by K1; only queried stacks and
    authentication nodes are read back."""

    def __init__(self, cw, stack_height):
        n = cw.shape[-1]
        self._k = stack_height
        self._distance = n // stack_height
        rows = cw.reshape(3, stack_height, self._distance).permute(
            2, 1, 0).reshape(self._distance, 3 * stack_height)
        self.tree = merkle.MerkleTree(tip5_kernel.sponge_absorb_rows(rows))
        self._cw = cw

    def root(self):
        return self.tree.root()

    def inclusion_proof(self, indices):
        k = self._k
        idx = torch.as_tensor([i + s * self._distance for i in indices
                               for s in range(k)], device=self._cw.device)
        sel = gfx.to_tuples(self._cw.index_select(1, idx))
        leaves = [sel[j * k:(j + 1) * k] for j in range(len(indices))]
        return {"queried_leaves": leaves,
                "auth_structure": self.tree.authentication_structure(
                    indices)}
