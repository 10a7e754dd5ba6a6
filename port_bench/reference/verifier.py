"""The plain reference: a Triton VM STARK verifier in Python and numpy
(triton-vm/src/stark.rs:1388-1763, parameters stark.rs:113-145 and
2007-2110) that judges a proof layer by layer.

It reads only the claim (program digest, input, output) and the proof's
words. `check` replays the Fiat-Shamir transcript and reports, for each
layer of the proof, whether that layer's check failed:

  decode        the proof's items parse, in the order the protocol sends
  height        Log2PaddedHeight is the height the traffic asks for
  ood_quotient  the AIR's constraints at the out-of-domain point, divided
                by their zerofiers and weighted, equal the quotient
                segments' out-of-domain values: the witness tables
                (through the OOD rows) and the quotients (K3) under the
                claim's challenges
  ldt           the low-degree test (FRI below 2^16, STIR from 2^16) of
                the DEEP codeword: its commitments, folds and last
                polynomial
  merkle        every revealed main, aux and quotient-segment row hashes
                (K2) up its Merkle tree (K1) to the committed root: the
                LDE codewords (K4) as committed
  deep          the DEEP combination of the revealed rows and the OOD
                values equals the codeword the LDT revealed, at every
                revealed index
  complete      no item is left over

A layer that could not be reached because an earlier one broke the
transcript counts as failed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import air, bfe, merkle, tip5, xfe
from . import npfield as nf
from .codec import DecodeError
from .domain import Domain
from .fri import Fri, FriParameters, LdtError
from .proof_stream import Claim, ProofStream
from .stir import Stir, StirParameters

LAYERS = ("decode", "height", "ood_quotient", "ldt", "merkle", "deep",
          "complete")
NUM_MAIN = 379
NUM_AUX = 91
NUM_QUOTIENT_SEGMENTS = 4
NUM_RANDOMIZED_QUOTIENT_SEGMENTS = 5
NUM_DEEP_CODEWORD_COMPONENTS = 4
ZETA = 3


@dataclass(frozen=True)
class Parameters:
    """Stark::default() as the configuration states it: 160 bits of
    security, expansion factor 4, the proven proximity regime, FRI below
    padded height 2^16 and STIR from there (stark.rs:1942-1958)."""

    security_level: int = 160
    log2_expansion_factor: int = 2
    soundness: str = "proven"
    ldt_choice: str | None = None  # "fri" or "stir" overrides the cut-off

    def ldt(self, padded_height: int):
        log2_ph = padded_height.bit_length() - 1
        cutoff = 16 if self.soundness == "proven" else 17
        use_fri = (log2_ph < cutoff if self.ldt_choice is None
                   else self.ldt_choice == "fri")
        for log2_bound in range(log2_ph + 1, log2_ph + 34):
            if use_fri:
                ldt = Fri(FriParameters(
                    self.security_level, self.log2_expansion_factor,
                    log2_bound, self.soundness))
            else:
                ldt = Stir(StirParameters(
                    self.security_level, 2, self.log2_expansion_factor,
                    log2_bound, self.soundness))
            ntr = num_trace_randomizers(ldt)
            if ldt.initial_domain().length >= randomized_trace_len(
                    padded_height, ntr) << self.log2_expansion_factor:
                return ldt
        raise ValueError("no low-degree test parameters fit")

    def domains(self, padded_height: int):
        """(ldt, trace domain length, quotient domain, LDT domain)."""
        ldt = self.ldt(padded_height)
        ntr = num_trace_randomizers(ldt)
        rand_len = randomized_trace_len(padded_height, ntr)
        d = rand_len - 1
        zerofier_degree = {"init": 1, "cons": padded_height,
                           "tran": padded_height - 1, "term": 1}
        worst = max(deg * d - zerofier_degree[p]
                    for p, deg in air.max_degrees().items())
        max_degree = (1 << (worst - 1).bit_length()) - 1
        ldt_dom = ldt.initial_domain()
        quot_dom = Domain(1 << (max_degree - 1).bit_length(),
                          ldt_dom.offset)
        return ldt, rand_len // 2, quot_dom, ldt_dom


def num_trace_randomizers(ldt) -> int:
    # stark.rs:2083-2089
    return ldt.num_first_round_queries() + NUM_QUOTIENT_SEGMENTS * 3 * 2 + 1


def randomized_trace_len(padded_height: int, ntr: int) -> int:
    n = max(padded_height + ntr, 2 * ntr + 1,
            (ntr + 1) * NUM_RANDOMIZED_QUOTIENT_SEGMENTS)
    return 1 << (n - 1).bit_length()


def program_digest(program_words) -> tuple:
    """The program's attestation digest: Tip5 hash_varlen of its
    instruction words (triton-isa/src/program.rs:399)."""
    return tuple(tip5.hash_varlen([int(w) for w in program_words]))


def check(words, claim: Claim, padded_height: int,
          params: Parameters = Parameters()) -> dict:
    """{layer: 1 if its check failed or was not reached, else 0}."""
    failed = dict.fromkeys(LAYERS, 1)
    try:
        _check(words, claim, padded_height, params, failed)
    except (DecodeError, LdtError, ValueError, ZeroDivisionError,
            KeyError, IndexError, TypeError):
        pass
    return failed


def _powers(x, n):
    out = [xfe.ONE]
    for _ in range(n - 1):
        out.append(xfe.mul(out[-1], x))
    return out


def _weighted(values, weights):
    acc = xfe.ZERO
    for v, w in zip(values, weights):
        acc = xfe.add(acc, xfe.mul(w, v))
    return acc


def _check(words, claim, padded_height, params, failed):
    stream = ProofStream.decode(words)
    failed["decode"] = 0
    stream.alter_fiat_shamir_state_with(claim.encode())

    log2_height = stream.dequeue().expect("Log2PaddedHeight")
    if 1 << log2_height == padded_height:
        failed["height"] = 0
    ldt, trace_len, quot_dom, ldt_dom = params.domains(1 << log2_height)
    trace_gen = Domain(trace_len).generator

    main_root = stream.dequeue().expect("MerkleRoot")
    ch = air.challenges(stream.sample_scalars(air.SAMPLE_COUNT), claim)
    aux_root = stream.dequeue().expect("MerkleRoot")
    quot_weights = _powers(stream.sample_scalars(1)[0],
                           air.num_constraints())
    quot_root = stream.dequeue().expect("MerkleRoot")

    alpha = stream.sample_scalars(1)[0]
    omega_alpha = xfe.bfe_mul(alpha, trace_gen)
    alpha_pow_k = xfe.mod_pow(alpha, NUM_QUOTIENT_SEGMENTS)
    zeta_alpha = xfe.bfe_mul(alpha, ZETA)
    zeta_alpha_pow_k = xfe.mod_pow(zeta_alpha, NUM_QUOTIENT_SEGMENTS)

    main_curr = stream.dequeue().expect("OutOfDomainMainRow")
    aux_curr = stream.dequeue().expect("OutOfDomainAuxRow")
    main_next = stream.dequeue().expect("OutOfDomainMainRow")
    aux_next = stream.dequeue().expect("OutOfDomainAuxRow")
    quot_p = stream.dequeue().expect("OutOfDomainQuotientSegments")
    quot_r = stream.dequeue().expect("OutOfDomainQuotientSegments")

    # the AIR at the out-of-domain point against the quotient segments
    one = xfe.ONE
    init_zi = xfe.inv(xfe.sub(alpha, one))
    cons_zi = xfe.inv(xfe.sub(xfe.mod_pow(alpha, trace_len), one))
    except_last = xfe.sub(alpha, xfe.lift(bfe.inv(trace_gen)))
    zerofier_inverse = {"init": init_zi, "cons": cons_zi,
                        "tran": xfe.mul(except_last, cons_zi),
                        "term": xfe.inv(except_last)}
    summands = []
    for phase in air.PHASES:
        values = air.evaluate(phase, main_curr, aux_curr, ch,
                              main_next, aux_next)
        summands += [xfe.mul(v, zerofier_inverse[phase]) for v in values]
    ood_value = _weighted(summands, quot_weights)
    derandomised = xfe.add(
        _weighted(quot_p, _powers(alpha, len(quot_p))),
        _weighted(quot_r, _powers(zeta_alpha, len(quot_r))))
    if ood_value == derandomised:
        failed["ood_quotient"] = 0

    initials = stream.sample_scalars(3)
    w_all = _powers(initials[0], NUM_MAIN + NUM_AUX)
    w_main, w_aux = w_all[:NUM_MAIN], w_all[NUM_MAIN:]
    w_qs = _powers(initials[1], NUM_RANDOMIZED_QUOTIENT_SEGMENTS)
    w_deep = _powers(initials[2], NUM_DEEP_CODEWORD_COMPONENTS)
    ood_curr = xfe.add(_weighted(main_curr, w_main),
                       _weighted(aux_curr, w_aux))
    ood_next = xfe.add(_weighted(main_next, w_main),
                       _weighted(aux_next, w_aux))
    ood_p = _weighted(quot_p, w_qs[:-1])
    ood_r = _weighted(quot_r, w_qs[1:])

    indices, values = ldt.verify(stream)
    t = ldt.num_first_round_queries()
    if len(indices) == t and len(values) == t:
        failed["ldt"] = 0

    rows = {}
    merkle_ok = True
    for name, root, item in (("main", main_root, "MasterMainTableRows"),
                             ("aux", aux_root, "MasterAuxTableRows"),
                             ("quot", quot_root,
                              "QuotientSegmentsElements")):
        arr = np.asarray(stream.dequeue().expect(item), np.uint64)
        auth = stream.dequeue().expect("AuthenticationStructure")
        if arr.shape[0] != t:
            merkle_ok = False
            continue
        digests = tip5.hash_varlen_rows(arr.reshape(t, -1))
        merkle_ok &= merkle.verify(root, ldt_dom.length, indices, digests,
                                   auth)
        rows[name] = arr
    if merkle_ok:
        failed["merkle"] = 0

    # the DEEP codeword at every revealed index
    points = (alpha, omega_alpha, alpha_pow_k, zeta_alpha_pow_k)
    denominators = np.array(
        [xfe.inv(xfe.sub(xfe.lift(ldt_dom.value(i)), pt))
         for i in indices for pt in points], np.uint64).reshape(t, 4, 3)
    main_aux = nf.xfe_add(
        nf.xfe_sum(nf.xfe_bfe_mul(np.asarray(w_main, np.uint64)[None],
                                  rows["main"]), 1),
        nf.xfe_sum(nf.xfe_mul(np.asarray(w_aux, np.uint64)[None],
                              rows["aux"]), 1))
    quot = rows["quot"]
    w_qs_arr = np.asarray(w_qs, np.uint64)
    shared = nf.xfe_sum(nf.xfe_mul(quot[:, 1:-1], w_qs_arr[None, 1:-1]), 1)
    quot_elem_p = nf.xfe_add(nf.xfe_mul(quot[:, 0], w_qs_arr[None, 0]),
                             shared)
    quot_elem_r = nf.xfe_add(nf.xfe_mul(quot[:, -1], w_qs_arr[None, -1]),
                             shared)
    deep = np.stack([
        nf.xfe_mul(nf.xfe_sub(main_aux, np.asarray(ood_curr, np.uint64)),
                   denominators[:, 0]),
        nf.xfe_mul(nf.xfe_sub(main_aux, np.asarray(ood_next, np.uint64)),
                   denominators[:, 1]),
        nf.xfe_mul(nf.xfe_sub(quot_elem_p, np.asarray(ood_p, np.uint64)),
                   denominators[:, 2]),
        nf.xfe_mul(nf.xfe_sub(quot_elem_r, np.asarray(ood_r, np.uint64)),
                   denominators[:, 3]),
    ], axis=1)
    combined = nf.xfe_sum(nf.xfe_mul(
        deep, np.asarray(w_deep, np.uint64)[None]), 1)
    if np.array_equal(combined, np.asarray(values, np.uint64)):
        failed["deep"] = 0

    if stream.is_exhausted():
        failed["complete"] = 0
