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
the codeword's device the whole way (k-wise fold, NTT re-evaluation,
the zerofier of the query points as a product of linear factors and the
quotient by it, all in the NEXT evaluation domain). The folded
polynomial's values at the queried points come from one forward
transform onto the folded domain and a gather; only the out-of-domain
samples take the batched point evaluation. Leaf rows are hashed by the K2
row sponge and the trees built by K1 (ops/tip5_kernel.py). The per-query
coset work of the verifier (size k = the folding factor) and the
interpolation through the ~hundred query points are scalar host math.
The prover's work is timed in spans within the prover's `LDT` stage
(`profiler.device_span`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import merkle
from ..fields import poly, xfe
from ..fields.bfe import P
from ..ops import gf, gfx, ntt, ntt_sharded, tip5_kernel
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
        raises LdtError, as the JAX package's device loop does."""
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
            pt_lifts = [xfe.lift(folded_domain.value(i))
                        for i in folded_queried_indices]
            if any(_point_on_domain(pt, next_domain) for pt in pt_lifts):
                raise LdtError("quotient point on evaluation domain")
            with profiler.device_span("STIR query evaluation", "LDT", dev):
                profiler.count("STIR queried points",
                               len(folded_queried_indices))
                points_to_quotient_out = (
                    _eval_on_folded_domain(folded, folded_domain,
                                           folded_queried_indices)
                    + list(ood_values))
            domain_values_out = pt_lifts + list(ood_queries)
            # O(points^2)
            with profiler.device_span("STIR host interpolation", "LDT",
                                      dev):
                answer_poly = poly.interpolate(domain_values_out,
                                               points_to_quotient_out, xfe)

            dc_randomness = proof_stream.sample_scalars(1)[0]
            dc_coeffs = _powers(dc_randomness,
                                len(points_to_quotient_out) + 1)
            with profiler.device_span("STIR zerofier", "LDT", dev):
                z_evals = _zerofier_on_domain_dev(domain_values_out,
                                                  next_domain, dev)
            with profiler.device_span("STIR quotient", "LDT", dev):
                ans_evals, dc_evals = _eval_poly_on_domain_dev(
                    [answer_poly, dc_coeffs], next_domain, dev)
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
        """stir.rs:995-1110 on the host; the revealed leaves are hashed in
        one batch on `device`. Returns (first_round_indices,
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
                proof_stream, domain, in_domain, prev_root, device)
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
            prev_root, device)
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
        digests = gf.to_u64(tip5_kernel.sponge_absorb_rows(
            gf.from_u64(rows, device))).T
        digests = [tuple(int(x) for x in d) for d in digests]
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


# ------------------------------------------------------ device prove pieces

# Largest (points x coefficients) block one batched evaluation pass forms.
_EVAL_BLOCK_ELEMS = 1 << 22
# Largest (points x domain) block of linear factors the zerofier multiplies.
_ZEROFIER_BLOCK_ELEMS = 1 << 23


def _pad_to(v, n):
    """Zero-pad the last axis of v to length n."""
    if v.shape[-1] == n:
        return v
    out = torch.zeros(v.shape[:-1] + (n,), dtype=v.dtype, device=v.device)
    out[..., :v.shape[-1]] = v
    return out


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


def _powers_dev(x, n):
    """x^0 .. x^(n-1) of XFE points x (3, m) as XFE (3, m, n), n a power of
    2, by doubling ([p, p * x^len(p)]); also returns x^n (3, m, 1)."""
    p = gfx.lift(torch.ones_like(x[0]))[..., None]
    xp = x[..., None]
    while p.shape[-1] < n:
        p = torch.cat([p, gfx.mul(p, xp)], dim=-1)
        xp = gfx.mul(xp, xp)
    return p, xp


def _eval_folded_at(coeffs, points):
    """Evaluate the polynomial with coefficients `coeffs` (XFE (3, n), low
    to high) at host XFE points; returns host XFE tuples.

    One batched pass per block of points instead of a Horner chain of n
    dependent steps: with B ~ sqrt(n) and the coefficients as an (n/B, B)
    block, f(x) = sum_j x^(Bj) * sum_t c[Bj + t] x^t. The powers x^t
    (t < B) and x^(Bj) come from doubling ladders, the inner sums are one
    batched product and `gfx.reduce_sum`. Field arithmetic is exact, so
    the values equal `poly.evaluate`'s."""
    if not points:
        return []
    dev = coeffs.device
    n = 1 << (coeffs.shape[-1] - 1).bit_length()
    B = 1 << ((n.bit_length() - 1) // 2)
    nb = n // B
    blocks = _pad_to(coeffs, n).reshape(3, 1, nb, B)
    per = max(1, _EVAL_BLOCK_ELEMS // n)
    out = []
    for s in range(0, len(points), per):
        x = gfx.from_u64(np.array(points[s:s + per], np.uint64), dev)
        small, x_b = _powers_dev(x, B)                   # (3, m, B)
        large, _ = _powers_dev(x_b[..., 0], nb)          # (3, m, nb)
        inner = gfx.reduce_sum(gfx.mul(blocks, small[:, :, None, :]), -1)
        out += gfx.to_tuples(gfx.reduce_sum(gfx.mul(inner, large), -1))
    return out


def _eval_on_folded_domain(folded, folded_domain: Domain, indices):
    """The values of the polynomial with coefficients `folded` (XFE (3, n),
    low to high) at `folded_domain.value(i)` for each i in `indices`, as
    host XFE tuples. n must be the folded domain's length: the values are
    entries of one forward transform of `folded` onto that domain (K4 on a
    card, spread over an active mesh when tall), gathered on the device
    and read back in one read."""
    if folded.shape[-1] != folded_domain.length:
        raise LdtError(f"{folded.shape[-1]} folded coefficients for a "
                       f"folded domain of {folded_domain.length} points")
    evals = ntt_sharded.xfe_ntt_auto(folded, folded_domain.offset)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=folded.device)
    return gfx.to_tuples(evals.index_select(1, idx))


def _eval_poly_on_domain_dev(polys, domain: Domain, device):
    """Evaluate short host XFE polynomials on every point of `domain`: one
    batched NTT of the zero-padded coefficients. Returns XFE (3, n) per
    polynomial."""
    n = domain.length
    arr = np.zeros((len(polys), n, 3), np.uint64)
    for i, coeffs in enumerate(polys):
        assert len(coeffs) <= n, "polynomial longer than evaluation domain"
        if coeffs:
            arr[i, :len(coeffs)] = np.array(coeffs, np.uint64)
    evals = ntt.ntt(gfx.from_u64(arr, device), domain.offset)  # (3, k, n)
    return evals.unbind(1)


def _zerofier_on_domain_dev(points, domain: Domain, device):
    """The zerofier of host XFE `points`, prod_i (x - p_i), at every point
    x of `domain`, XFE (3, n): the (m, n) block of linear factors, m padded
    to a power of 2 with factors of 1, halved by pairwise products in
    log2(m) levels, over column blocks of at most _ZEROFIER_BLOCK_ELEMS
    factors."""
    n = domain.length
    m = 1 << (max(len(points), 1) - 1).bit_length()
    pts = np.zeros((m, 3), np.uint64)
    pts[:len(points)] = np.array(points, np.uint64).reshape(-1, 3)
    p = gfx.from_u64(pts, device)[..., None]                  # (3, m, 1)
    pad = (torch.arange(m, device=device) >= len(points))[:, None]
    one = gfx.full((1, 1), xfe.ONE, device)
    xs = gf.powers(domain.generator, n, domain.offset, device)
    cols = max(1, _ZEROFIER_BLOCK_ELEMS // m)
    out = []
    for s in range(0, n, cols):
        f = gfx.sub(gfx.lift(xs[None, s:s + cols]), p)          # (3, m, c)
        f = torch.where(pad, one, f)
        while f.shape[1] > 1:
            half = f.shape[1] // 2
            f = gfx.mul(f[:, :half], f[:, half:])
        out.append(f[:, 0])
    return torch.cat(out, dim=-1)


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
