"""The Triton VM zk-STARK prover and verifier on torch tensors.

Transcribes triton-vm/src/stark.rs: parameter derivation (randomized trace
length, max degree, FRI setup), the DEEP-ALI proving pipeline
(stark.rs:331-719) and verification (stark.rs:1388-1763). The counterpart
of `triton_vm_tpu.stark.prover`, whose proof words it reproduces.

Compute placement: the derived main columns, the aux extension
(tables/extend_device.py), LDE (cached, or coset by coset where the
committed codewords would not fit: stark/jit_lde.py), row hashing and
Merkle trees, the quotient tapes (on a card K3, ops/quotient_cuda.py,
over the row tape of air/compile.py), out-of-domain rows, the DEEP
combination and the low-degree test (FRI or STIR) run on the
prover's device (a CUDA card unless the caller asks for the CPU); the
main table's fill from the execution trace, Fiat-Shamir and randomness
are on the host. The host <-> device boundary is numpy uint64 <-> int64
tensors with the same bit patterns (ops/gf.py). With TVM_MESH=n the
commit stage, the row hashing and Merkle subtrees, the quotient tapes,
the out-of-domain rows, the weighted column sum and STIR's tall
transforms are sharded over n shards (parallel/mesh.py,
ops/ntt_sharded.py); the proof is the same word for word.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import config
from ..air import circuit as C
from ..air import compile as aircomp
from ..air.challenges import SAMPLE_COUNT, Challenges
from ..air.evaluate import eval_host, linearize
from ..air.master import master_air
from ..crypto import merkle
from ..fields import bfe, xfe
from ..fields.bfe import P
from ..ldt.fri import Fri, FriParameters
from ..ldt.stir import Stir, StirParameters
from ..ops import (gf, gfx, kernels, ntt, quotient_cuda, stdrng_cuda,
                   tip5_kernel)
from ..parallel import mesh as pmesh
from ..parallel import sharding
from ..tables import extend_device
from ..tables import master as mt
from ..utils import profiler as _profiler
from . import jit_lde
from .arithmetic_domain import Domain
from .proof_item import ProofItem
from .proof_stream import Claim, Proof, ProofStream

_CURRENT_STAGE = None


def _trace(msg, category=None, device=None):
    """Stage marker: closes the previous prover stage span (if any) and
    opens a new one in the global profiler. Call with msg=None to close
    the final stage. While a profiler session is open, a CUDA device's
    stream is synchronised first (every visible card's: a prover sharded
    over a mesh works on several), so a span holds the device work its
    stage enqueued; an unprofiled prove runs without these
    synchronisations."""
    global _CURRENT_STAGE
    if (device is not None and device.type == "cuda"
            and _profiler.recording()):
        for card in range(torch.cuda.device_count()):
            torch.cuda.synchronize(card)
    if _CURRENT_STAGE is not None:
        _profiler.exit(_CURRENT_STAGE)
    _CURRENT_STAGE = msg
    if msg is not None:
        _profiler.enter(msg, category)


NUM_QUOTIENT_SEGMENTS = 4
NUM_RANDOMIZED_QUOTIENT_SEGMENTS = 5
NUM_DEEP_CODEWORD_COMPONENTS = 4
NUM_MAIN = 379
NUM_AUX = 91
ZETA = 3


class ProvingError(RuntimeError):
    pass


class VerificationError(RuntimeError):
    pass


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device needs a visible card.
    There is no quiet move to the CPU: pass device="cpu" for that."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to prove and verify on the CPU")
    return device


# ------------------------------------------------------ deterministic RNG

def _drbg_bfes_rows(seed: bytes, offsets, n: int, device):
    """rand::StdRng (ChaCha12) BFE streams, one per seed offset
    (master_table.rs:631-663): int64 (B, n) on `device`, drawn there
    (ops/stdrng_cuda.py)."""
    return stdrng_cuda.draw(seed, offsets, n, device=device)


def _drbg_xfes_rows(seed: bytes, offsets, n: int, device):
    """Batched XFE streams: int64 (B, 3, n) on `device`, row b an XFE
    tensor (3, n)."""
    return stdrng_cuda.draw(seed, offsets, n, xfe=True, device=device)


# ------------------------------------------------------------- parameters

@functools.lru_cache(maxsize=1)
def _max_constraint_degrees() -> dict:
    """Per-phase maximum constraint degree of the lowered master AIR
    (walked once; Stark.max_degree is called by prover AND verifier)."""
    air = master_air()
    out = {}
    for phase, cs in air.constraints.items():
        memo = {}
        out[phase] = max((C.degree(c.node, memo) for c in cs), default=0)
    return out


class Stark:
    """Protocol parameters (stark.rs:113-145): security level, expansion
    factor, LDT choice override, the proximity-gap soundness regime
    (low_degree_test/mod.rs:120-155), and the torch device that proves
    and verifies (a CUDA card unless the caller asks for the CPU)."""

    ZETA = ZETA

    def __init__(self, security_level=160, log2_ldt_expansion_factor=2,
                 ldt_choice=None, soundness="proven", device="cuda"):
        assert log2_ldt_expansion_factor > 0
        assert ldt_choice in (None, "fri", "stir")
        assert soundness in ("proven", "conjectured")
        self.security_level = security_level
        self.log2_ldt_expansion_factor = log2_ldt_expansion_factor
        self.ldt_choice = ldt_choice
        self.soundness = soundness
        self.device = resolve_device(device)

    def with_ldt_choice(self, choice):
        return Stark(self.security_level, self.log2_ldt_expansion_factor,
                     choice, self.soundness, self.device)

    def with_soundness(self, soundness):
        return Stark(self.security_level, self.log2_ldt_expansion_factor,
                     self.ldt_choice, soundness, self.device)

    @classmethod
    def low_security(cls, device="cuda"):
        return cls(32, 2, device=device)

    # -- degree bookkeeping ------------------------------------------------

    @staticmethod
    def num_quotient_table_randomizers(num_trace_randomizers):
        return (num_trace_randomizers + 1) * NUM_RANDOMIZED_QUOTIENT_SEGMENTS

    @classmethod
    def randomized_trace_len(cls, padded_height, num_trace_randomizers):
        n = max(padded_height + num_trace_randomizers,
                2 * num_trace_randomizers + 1,
                cls.num_quotient_table_randomizers(num_trace_randomizers))
        return 1 << (n - 1).bit_length()

    @classmethod
    def interpolant_degree(cls, padded_height, num_trace_randomizers):
        return cls.randomized_trace_len(
            padded_height, num_trace_randomizers) - 1

    @classmethod
    @functools.lru_cache(maxsize=64)
    def max_degree(cls, padded_height, num_trace_randomizers):
        d = cls.interpolant_degree(padded_height, num_trace_randomizers)
        zerofier_deg = {"init": 1, "cons": padded_height,
                        "tran": padded_height - 1, "term": 1}
        best = 0
        for phase, deg in _max_constraint_degrees().items():
            best = max(best, deg * d - zerofier_deg[phase])
        smallest_domain = 1 << (best - 1).bit_length()
        return smallest_domain - 1

    @staticmethod
    def num_trace_randomizers(ldt) -> int:
        # h = t + k*e*f + 1 (stark.rs:2083-2089)
        return ldt.num_first_round_queries() + NUM_QUOTIENT_SEGMENTS * 3 * 2 + 1

    def fri(self, padded_height: int) -> Fri:
        log2_ph = max(padded_height, 1).bit_length() - 1
        log2_bound = log2_ph
        for _ in range(33):
            log2_bound += 1
            fri = Fri(FriParameters(
                security_level=self.security_level,
                log2_initial_expansion_factor=self.log2_ldt_expansion_factor,
                log2_high_degree_bound=log2_bound,
                soundness=self.soundness))
            ntr = self.num_trace_randomizers(fri)
            rand_len = self.randomized_trace_len(padded_height, ntr)
            if fri.initial_domain().length >= rand_len * (
                    1 << self.log2_ldt_expansion_factor):
                return fri
        raise ProvingError("no suitable FRI parameters found")

    def stir(self, padded_height: int) -> Stir:
        """Derive a usable STIR instance (stark.rs:2007-2060): k = 4, high
        degree bound grown until the initial domain covers the randomized
        trace times the expansion factor."""
        log2_ph = max(padded_height, 1).bit_length() - 1
        log2_bound = log2_ph
        for _ in range(33):
            log2_bound += 1
            stir = Stir(StirParameters(
                security_level=self.security_level,
                log2_folding_factor=2,
                log2_initial_expansion_factor=self.log2_ldt_expansion_factor,
                log2_high_degree_bound=log2_bound,
                soundness=self.soundness))
            ntr = self.num_trace_randomizers(stir)
            rand_len = self.randomized_trace_len(padded_height, ntr)
            if stir.initial_domain().length >= rand_len * (
                    1 << self.log2_ldt_expansion_factor):
                return stir
        raise ProvingError("no suitable STIR parameters found")

    def ldt(self, padded_height: int):
        """Pick the low-degree test (stark.rs:1942-1958): FRI below padded
        height 2^16 (proven regime) / 2^17 (conjectured regime), STIR
        above; `ldt_choice` overrides."""
        choice = self.ldt_choice
        if choice is None:
            log2_ph = max(padded_height, 1).bit_length() - 1
            cutoff = 16 if self.soundness == "proven" else 17
            choice = "fri" if log2_ph < cutoff else "stir"
        return self.fri(padded_height) if choice == "fri" \
            else self.stir(padded_height)

    def derive_domains(self, padded_height):
        ldt = self.ldt(padded_height)
        ntr = self.num_trace_randomizers(ldt)
        rand_len = self.randomized_trace_len(padded_height, ntr)
        max_deg = self.max_degree(padded_height, ntr)
        trace = Domain(rand_len // 2)
        randomized_trace = Domain(rand_len)
        ldt_dom = ldt.initial_domain()
        q_len = 1 << (max_deg - 1).bit_length()  # next_power_of_two
        quotient = Domain(q_len, ldt_dom.offset)
        return ldt, ntr, trace, randomized_trace, quotient, ldt_dom

    def prove(self, claim: Claim, aet, seed: bytes = None) -> Proof:
        return Prover(self, seed).prove(claim, aet)

    def verify(self, claim: Claim, proof: Proof, collector=None):
        return Verifier(self).verify(claim, proof, collector)


# ----------------------------------------------------------------- prover

class Prover:
    def __init__(self, parameters: Stark, seed: bytes = None):
        self.parameters = parameters
        if seed is None:
            seed = os.urandom(32)
        assert len(seed) == 32
        self.seed = seed

    def prove(self, claim: Claim, aet) -> Proof:
        try:
            return self._prove(claim, aet)
        finally:
            # Close any stage span left open by an exception so a failed
            # prove cannot poison the global profiler session state.
            _trace(None)

    def _prove(self, claim: Claim, aet) -> Proof:
        stark = self.parameters
        dev = stark.device
        # the domains; the first proof of a process also builds the AIR
        _trace("setup", "setup", dev)
        proof_stream = ProofStream()
        proof_stream.alter_fiat_shamir_state_with(claim.encode())

        padded_height = aet.padded_height()
        ldt, ntr, trace_dom, rand_dom, quot_dom, ldt_dom = \
            stark.derive_domains(padded_height)
        proof_stream.enqueue(ProofItem(
            "Log2PaddedHeight", padded_height.bit_length() - 1))

        h = trace_dom.length
        n = rand_dom.length
        L = ldt_dom.length
        Q = quot_dom.length
        E = max(L, Q)  # evaluation domain length
        eval_dom = ldt_dom if L >= Q else quot_dom
        # TVM_MESH shards the commit stage (columns), the row hashing and
        # the quotients (rows) over a mesh (parallel/mesh.py); the rest
        # runs on the lead device, the Stark's own.
        mesh = sharding.active_mesh(dev)
        # Cache-or-JIT (config.rs:24-94): the cached path keeps the
        # committed codewords on the evaluation domain; the JIT path keeps
        # only their polynomials' coefficients and evaluates them coset by
        # coset (stark/jit_lde.py). A mesh implies the cached path, as in
        # the JAX package.
        use_jit = (mesh is None and config.cache_lde_trace(L, dev)
                   is config.CacheDecision.JIT)

        # ------------------------------------------------------ main table
        _trace("fill main", "witness", dev)
        main = extend_device.main_witness_dev(
            mt.fill_main_table(aet, padded_height=h, device=dev), dev)
        with _profiler.span("main randomizers", "witness"):
            main_rand = _drbg_bfes_rows(self.seed, range(NUM_MAIN), ntr,
                                        dev)                  # (NM, ntr)

        _trace("main LDE", "LDE", dev)
        if use_jit:
            main_coeffs = jit_lde.committed_coefficients(
                main, main_rand, trace_dom, n)                # (NM, n)
            main_digests = jit_lde.committed_digests(main_coeffs, eval_dom,
                                                     L)
            _trace("main merkle", "hash", dev)
            main_tree = _merkle_tree(main_digests)
        elif mesh is not None:
            main_coeffs, main_lde = pmesh.sharded_commit(
                mesh, main, main_rand, trace_dom, eval_dom)   # (NM, .)
            _trace("main merkle", "hash", dev)
            main_tree = _mesh_tree(mesh, main_lde.map(
                lambda p: p[:, ::E // L]), L)
        else:
            main_coeffs, main_lde = _commit_bfe(
                main, main_rand, trace_dom, eval_dom)         # (NM, E)
            _trace("main merkle", "hash", dev)
            main_tree = _commit_tree(main_lde[:, ::E // L].T, L)
        proof_stream.enqueue(ProofItem("MerkleRoot", main_tree.root()))
        challenges = Challenges(proof_stream.sample_scalars(SAMPLE_COUNT),
                                claim)

        # ------------------------------------------------------- aux table
        _trace("extend aux", "witness", dev)
        with _profiler.span("aux randomizers", "witness"):
            batch_randomizer = _drbg_xfes_rows(
                self.seed, [NUM_MAIN + NUM_AUX], h, dev)[0]  # XFE (3, h)
            # (NA, 3, ntr): row k of the flattened (3 NA, ntr) view is
            # component k % 3 of column k // 3, the committed row order
            aux_rand = _drbg_xfes_rows(
                self.seed, range(NUM_MAIN, NUM_MAIN + NUM_AUX), ntr, dev)
        aux = extend_device.aux_witness_dev(main, challenges,
                                            batch_randomizer)
        del main, batch_randomizer                    # aux: (NA, 3, h)

        _trace("aux LDE", "LDE", dev)
        if use_jit:
            aux_coeffs = jit_lde.committed_coefficients(
                aux, aux_rand, trace_dom, n)                  # (NA, 3, n)
            del aux
            aux_digests = jit_lde.committed_digests(aux_coeffs, eval_dom,
                                                    L)
            _trace("aux merkle", "hash", dev)
            aux_tree = _merkle_tree(aux_digests)
        elif mesh is not None:
            # sharded by XFE column: a shard holds all 3 components
            aux_coeffs, aux_store = pmesh.sharded_commit(
                mesh, aux, aux_rand, trace_dom, eval_dom)     # (NA, 3, .)
            del aux
            _trace("aux merkle", "hash", dev)
            aux_tree = _mesh_tree(mesh, aux_store.unpadded().map(
                lambda p: p.reshape(-1, E)[:, ::E // L], axis=0), L)
        else:
            aux_coeffs, aux_store = _commit_bfe(
                aux, aux_rand, trace_dom, eval_dom)           # (NA, 3, E)
            del aux
            aux_lde = aux_store.permute(1, 0, 2)               # XFE (3, NA, E)
            _trace("aux merkle", "hash", dev)
            aux_tree = _commit_tree(
                aux_store.view(3 * NUM_AUX, E)[:, ::E // L].T, L)
        proof_stream.enqueue(ProofItem("MerkleRoot", aux_tree.root()))

        initial_quot_weight = proof_stream.sample_scalars(1)[0]
        num_constraints = sum(
            len(cs) for cs in master_air().constraints.values())
        quot_weights = _powers_xfe(initial_quot_weight, num_constraints)

        # --------------------------------------------- quotient segments
        _trace("quotients", "quotient", dev)
        if use_jit:
            quotient = jit_lde.quotient_codeword_jit(
                main_coeffs, aux_coeffs, trace_dom, quot_dom, challenges,
                quot_weights)                                 # XFE (3, Q)
        elif mesh is not None:
            stride = E // Q
            quotient = pmesh.sharded_quotients(
                mesh, main_lde.map(lambda p: p[:, ::stride]),
                aux_store.map(lambda p: p[..., ::stride]), trace_dom,
                quot_dom, challenges, quot_weights)           # XFE (3, Q)
        else:
            stride = E // Q
            quotient = _all_quotients_combined_device(
                main_lde[:, ::stride], aux_lde[:, :, ::stride], trace_dom,
                quot_dom, challenges, quot_weights)           # XFE (3, Q)

        _trace("segmentify", "quotient", dev)
        n_qr = Stark.num_quotient_table_randomizers(ntr)
        q_randomizer = _drbg_xfes_rows(
            self.seed, [NUM_MAIN + NUM_AUX + 1], n_qr, dev)[0]
        seg_store = _segmentify(quotient, q_randomizer, quot_dom,
                                ldt_dom)                      # (5, 3, L)
        del quotient
        segs = seg_store.permute(1, 0, 2)                      # XFE (3, 5, L)

        _trace("quot merkle", "hash", dev)
        quot_tree = _commit_tree(
            seg_store.view(3 * NUM_RANDOMIZED_QUOTIENT_SEGMENTS, L).T, L)
        proof_stream.enqueue(ProofItem("MerkleRoot", quot_tree.root()))

        # ------------------------------------------------------- OOD rows
        _trace("OOD", "DEEP", dev)
        with _profiler.span("OOD reads and Fiat-Shamir", "DEEP"):
            alpha = proof_stream.sample_scalars(1)[0]
            omega_alpha = xfe.bfe_mul(alpha, trace_dom.generator)
            alpha_pow_k = xfe.mod_pow(alpha, NUM_QUOTIENT_SEGMENTS)
            zeta_alpha = xfe.bfe_mul(alpha, ZETA)
            zeta_alpha_pow_k = xfe.mod_pow(zeta_alpha,
                                           NUM_QUOTIENT_SEGMENTS)

        def point(x):
            return gfx.full((), tuple(x), dev)

        # both paths keep the committed polynomials' coefficients: the OOD
        # rows and the weighted main+aux codeword are computed from them
        ood_fn = kernels.ood_stage_fn
        if mesh is None:
            aux_polys = aux_coeffs.permute(1, 0, 2)     # XFE (3, NA, n)
        else:
            ood_fn = functools.partial(pmesh.sharded_ood_stage, mesh)
            aux_polys = aux_coeffs                      # (NA, 3, n), sharded
        with _profiler.device_span("OOD kernels", "DEEP", dev):
            m1, a1, m2, a2, s1, s2 = ood_fn(
                main_coeffs, aux_polys, segs, point(alpha),
                point(omega_alpha), point(alpha_pow_k),
                point(zeta_alpha_pow_k),
                gf.powers(ldt_dom.generator, L, ldt_dom.offset, dev))
        with _profiler.span("OOD reads and Fiat-Shamir", "DEEP"):
            ood_main_curr = gfx.to_tuples(m1)
            ood_aux_curr = gfx.to_tuples(a1)
            ood_main_next = gfx.to_tuples(m2)
            ood_aux_next = gfx.to_tuples(a2)
            ood_quot_p = gfx.to_tuples(s1)[:NUM_QUOTIENT_SEGMENTS]
            ood_quot_r = gfx.to_tuples(s2)[1:]
            proof_stream.enqueue(ProofItem("OutOfDomainMainRow",
                                           ood_main_curr))
            proof_stream.enqueue(ProofItem("OutOfDomainAuxRow",
                                           ood_aux_curr))
            proof_stream.enqueue(ProofItem("OutOfDomainMainRow",
                                           ood_main_next))
            proof_stream.enqueue(ProofItem("OutOfDomainAuxRow",
                                           ood_aux_next))
            proof_stream.enqueue(ProofItem("OutOfDomainQuotientSegments",
                                           ood_quot_p))
            proof_stream.enqueue(ProofItem("OutOfDomainQuotientSegments",
                                           ood_quot_r))
            # the combination weights: DEEP, below, and the LDT
            weights = _sample_combination_weights(proof_stream)

        # ----------------------------------------- combination + DEEP + LDT
        short_dom = ldt_dom if L <= Q else quot_dom

        _trace("weighted sum", "DEEP", dev)
        # The four out-of-domain values are the weighted sums of the
        # already-revealed OOD rows / segment evaluations (the same field
        # elements as evaluating the weighted polynomials).
        v_curr = _linear_sum(ood_main_curr, ood_aux_curr, weights)
        v_next = _linear_sum(ood_main_next, ood_aux_next, weights)
        w_qs = weights["quot_segments"]
        v_p = xfe.ZERO
        for x, w in zip(ood_quot_p, w_qs[:-1]):
            v_p = xfe.add(v_p, xfe.mul(x, w))
        v_r = xfe.ZERO
        for x, w in zip(ood_quot_r, w_qs[1:]):
            v_r = xfe.add(v_r, xfe.mul(x, w))
        S = short_dom.length

        def rows(xs):
            return gfx.from_u64(np.array(xs, np.uint64), dev)

        # the weighted main+aux codeword on the short domain: the weighted
        # sum of the coefficients, evaluated there
        sum_fn = (kernels.weighted_column_sum if mesh is None else
                  functools.partial(pmesh.sharded_weighted_column_sum, mesh))
        cw_ma = ntt.ntt(sum_fn(
            main_coeffs, aux_polys, rows(weights["main"]),
            rows(weights["aux"])), short_dom.offset, S)
        combination = kernels.deep_combination_fn(
            cw_ma, segs, rows(w_qs), rows(weights["deep"]),
            rows([alpha, omega_alpha, alpha_pow_k, zeta_alpha_pow_k]),
            rows([v_curr, v_next, v_p, v_r]),
            gf.powers(short_dom.generator, S, short_dom.offset, dev),
            short_dom.offset, L, ldt_dom.offset, L // S)
        del cw_ma

        _trace("LDT", "LDT", dev)
        revealed_indices = ldt.prove(combination, proof_stream)
        del combination
        _trace("reveal", "LDT", dev)

        # ZK guard (stark.rs:644-663)
        if alpha_pow_k[1] == 0 and alpha_pow_k[2] == 0:
            bad = {ldt_dom.value(i) for i in revealed_indices}
            zk = alpha_pow_k[0]
            zk2 = zk * pow(ZETA, NUM_QUOTIENT_SEGMENTS, P) % P
            if zk in bad or zk2 in bad:
                raise ProvingError("zero-knowledge violation")

        # ------------------------------------------------ open trace rows
        if use_jit:
            msel = jit_lde.reveal_rows(main_coeffs, eval_dom, L,
                                       revealed_indices)
            a3 = jit_lde.reveal_rows(aux_coeffs, eval_dom, L,
                                     revealed_indices).transpose(1, 0, 2)
            qsel = gf.to_u64(segs.index_select(2, torch.as_tensor(
                np.asarray(revealed_indices, np.int64), device=dev)))
        elif mesh is not None:
            rows_e = np.asarray(revealed_indices, np.int64) * (E // L)
            msel = gf.to_u64(pmesh.gather_rows(main_lde, 1, rows_e, dev))
            a3 = gf.to_u64(pmesh.gather_rows(aux_store, 2, rows_e, dev)
                           .permute(1, 0, 2))
            qsel = gf.to_u64(segs.index_select(2, torch.as_tensor(
                np.asarray(revealed_indices, np.int64), device=dev)))
        else:
            msel, a3, qsel = _reveal_gather_fn(main_lde, aux_lde, segs,
                                               revealed_indices,
                                               stride=E // L)
        main_rows = [[int(v) for v in msel[:, j]]
                     for j in range(len(revealed_indices))]
        proof_stream.enqueue(ProofItem("MasterMainTableRows", main_rows))
        proof_stream.enqueue(ProofItem(
            "AuthenticationStructure",
            main_tree.authentication_structure(revealed_indices)))

        aux_rows = [[tuple(int(a3[c, j, i]) for c in range(3))
                     for j in range(NUM_AUX)]
                    for i in range(len(revealed_indices))]
        proof_stream.enqueue(ProofItem("MasterAuxTableRows", aux_rows))
        proof_stream.enqueue(ProofItem(
            "AuthenticationStructure",
            aux_tree.authentication_structure(revealed_indices)))

        quot_rows = [[tuple(int(qsel[c, s, j]) for c in range(3))
                      for s in range(NUM_RANDOMIZED_QUOTIENT_SEGMENTS)]
                     for j in range(len(revealed_indices))]
        proof_stream.enqueue(ProofItem("QuotientSegmentsElements", quot_rows))
        proof_stream.enqueue(ProofItem(
            "AuthenticationStructure",
            quot_tree.authentication_structure(revealed_indices)))

        _trace("serialize", "FS", dev)
        proof = proof_stream.to_proof()
        _trace(None, device=dev)
        return proof


# ----------------------------------------------------------- verification

class Verifier:
    def __init__(self, parameters: Stark):
        self.parameters = parameters

    def verify(self, claim: Claim, proof: Proof,
               collector: dict | None = None):
        """Verify `proof` against `claim`; raises on rejection.

        `collector`, when given, is filled with the verifier's
        intermediate values (the Fiat-Shamir events, challenges, OOD rows,
        weights, revealed rows, ...), all host values: Python ints and
        tuples, numpy uint64 arrays. models/recursive_verifier.py lays
        them into Triton VM RAM. The work is timed in a `verify` span
        with the sub-spans decode, AIR, DEEP, LDT and merkle."""
        with _profiler.span("verify", "verify"):
            return self._verify(claim, proof, collector)

    def _verify(self, claim: Claim, proof: Proof, collector):
        stark = self.parameters
        dev = stark.device
        with _profiler.span("decode", "verify"):
            proof_stream = ProofStream.decode(proof.words)
            if collector is not None:
                collector["fs_events"] = proof_stream.enable_fs_recording()
            proof_stream.alter_fiat_shamir_state_with(claim.encode())

            log2_padded_height = proof_stream.dequeue().expect(
                "Log2PaddedHeight")
            if log2_padded_height >= 32:
                raise VerificationError("log2 padded height too large")
            padded_height = 1 << log2_padded_height
            ldt, ntr, trace_dom, rand_dom, quot_dom, ldt_dom = \
                stark.derive_domains(padded_height)
            trace_domain_len = rand_dom.length // 2
            merkle_height = ldt_dom.length.bit_length() - 1
            trace_gen = Domain(trace_domain_len).generator

            main_root = proof_stream.dequeue().expect("MerkleRoot")
            challenges = Challenges(proof_stream.sample_scalars(SAMPLE_COUNT),
                                    claim)
            aux_root = proof_stream.dequeue().expect("MerkleRoot")

            initial_quot_weight = proof_stream.sample_scalars(1)[0]
            num_constraints = sum(
                len(cs) for cs in master_air().constraints.values())
            quot_weights = _powers_xfe(initial_quot_weight, num_constraints)
            quot_root = proof_stream.dequeue().expect("MerkleRoot")

            alpha = proof_stream.sample_scalars(1)[0]
            omega_alpha = xfe.bfe_mul(alpha, trace_gen)
            alpha_pow_k = xfe.mod_pow(alpha, NUM_QUOTIENT_SEGMENTS)
            zeta_alpha = xfe.bfe_mul(alpha, ZETA)
            zeta_alpha_pow_k = xfe.mod_pow(zeta_alpha, NUM_QUOTIENT_SEGMENTS)

            ood_main_curr = proof_stream.dequeue().expect("OutOfDomainMainRow")
            ood_aux_curr = proof_stream.dequeue().expect("OutOfDomainAuxRow")
            ood_main_next = proof_stream.dequeue().expect("OutOfDomainMainRow")
            ood_aux_next = proof_stream.dequeue().expect("OutOfDomainAuxRow")
            ood_quot_p = proof_stream.dequeue().expect(
                "OutOfDomainQuotientSegments")
            ood_quot_r = proof_stream.dequeue().expect(
                "OutOfDomainQuotientSegments")

        with _profiler.span("AIR", "verify"):
            # evaluate the AIR at the OOD point
            ch = challenges.challenges
            values = []
            for phase in ("init", "cons", "tran", "term"):
                steps, out_ids = _linearized_phase(phase)
                if phase == "tran":
                    res = eval_host(steps, out_ids, ood_main_curr,
                                    ood_aux_curr, ch, ood_main_next,
                                    ood_aux_next)
                else:
                    res = eval_host(steps, out_ids, ood_main_curr,
                                    ood_aux_curr, ch)
                values.append(res)
            init_vals, cons_vals, tran_vals, term_vals = values

            one = xfe.ONE
            init_zi = xfe.inv(xfe.sub(alpha, one))
            cons_zi = xfe.inv(xfe.sub(xfe.mod_pow(alpha, trace_domain_len),
                                      one))
            except_last = xfe.sub(alpha, xfe.lift(bfe.inv(trace_gen)))
            tran_zi = xfe.mul(except_last, cons_zi)
            term_zi = xfe.inv(except_last)

            summands = ([xfe.mul(v, init_zi) for v in init_vals]
                        + [xfe.mul(v, cons_zi) for v in cons_vals]
                        + [xfe.mul(v, tran_zi) for v in tran_vals]
                        + [xfe.mul(v, term_zi) for v in term_vals])
            ood_quotient_value = xfe.ZERO
            for w, s in zip(quot_weights, summands):
                ood_quotient_value = xfe.add(ood_quotient_value, xfe.mul(w, s))

            derand_curr = xfe.ZERO
            for i, x in enumerate(ood_quot_p):
                derand_curr = xfe.add(derand_curr,
                                      xfe.mul(xfe.mod_pow(alpha, i), x))
            derand_zeta = xfe.ZERO
            for i, x in enumerate(ood_quot_r):
                derand_zeta = xfe.add(
                    derand_zeta, xfe.mul(xfe.mod_pow(zeta_alpha, i), x))
            if ood_quotient_value != xfe.add(derand_curr, derand_zeta):
                raise VerificationError(
                    "out-of-domain quotient value mismatch")

        with _profiler.span("DEEP", "verify"):
            weights = _sample_combination_weights(proof_stream)

            ood_curr_main_aux = _linear_sum(ood_main_curr, ood_aux_curr,
                                            weights)
            ood_next_main_aux = _linear_sum(ood_main_next, ood_aux_next,
                                            weights)
            w_qs = weights["quot_segments"]
            ood_quot_p_value = xfe.ZERO
            for x, w in zip(ood_quot_p, w_qs[:-1]):
                ood_quot_p_value = xfe.add(ood_quot_p_value, xfe.mul(x, w))
            ood_quot_r_value = xfe.ZERO
            for x, w in zip(ood_quot_r, w_qs[1:]):
                ood_quot_r_value = xfe.add(ood_quot_r_value, xfe.mul(x, w))

        with _profiler.device_span("LDT", "verify", dev):
            revealed_indices, revealed_values = ldt.verify(proof_stream,
                                                           stark.device)
            t = ldt.num_first_round_queries()
            if len(revealed_indices) != t or len(revealed_values) != t:
                raise VerificationError("wrong number of revealed LDT values")

        with _profiler.device_span("merkle", "verify", dev):
            def check_rows(root, rows, what):
                if len(rows) != t:
                    raise VerificationError(f"wrong number of {what} rows")
                auth = proof_stream.dequeue().expect("AuthenticationStructure")
                arr = np.asarray(rows, np.uint64)
                digests = _row_digests(arr.reshape(t, -1), stark.device)
                if not merkle.verify_authentication_structure(
                        tuple(root), ldt_dom.length, revealed_indices,
                        digests, auth):
                    raise VerificationError(
                        f"{what} codeword authentication failure")
                if collector is not None:
                    digests = [tuple(int(x) for x in d)
                               for d in gf.to_u64(digests).T]
                return arr, digests, auth

            main_arr, main_digests, main_auth = check_rows(
                main_root,
                proof_stream.dequeue().expect("MasterMainTableRows"), "main")
            aux_arr, aux_digests, aux_auth = check_rows(
                aux_root, proof_stream.dequeue().expect("MasterAuxTableRows"),
                "aux")
            quot_arr, quot_digests, quot_auth = check_rows(
                quot_root,
                proof_stream.dequeue().expect("QuotientSegmentsElements"),
                "quotient")

        with _profiler.span("DEEP", "verify"):
            # batch-invert all 4*t DEEP denominators in one pass
            ood_points = (alpha, omega_alpha, alpha_pow_k, zeta_alpha_pow_k)
            denominators = [
                xfe.sub(xfe.lift(ldt_dom.value(idx)), pt)
                for idx in revealed_indices for pt in ood_points]
            denominator_invs = _batch_inverse_xfe(denominators)

            # all t combination-codeword checks in one vectorized host pass
            from ..ops import npfield as nf

            w_main = np.asarray(weights["main"], np.uint64)    # (379, 3)
            w_aux = np.asarray(weights["aux"], np.uint64)      # (91, 3)
            w_qs_arr = np.asarray(w_qs, np.uint64)             # (segs+1, 3)
            main_aux_elem = nf.xfe_add(
                nf.xfe_sum(nf.xfe_bfe_mul(w_main[None], main_arr), 1),
                nf.xfe_sum(nf.xfe_mul(w_aux[None], aux_arr), 1))   # (t, 3)
            shared = nf.xfe_sum(
                nf.xfe_mul(quot_arr[:, 1:-1], w_qs_arr[None, 1:-1]), 1)
            quot_elem_p = nf.xfe_add(
                nf.xfe_mul(quot_arr[:, 0], w_qs_arr[None, 0]), shared)
            quot_elem_r = nf.xfe_add(
                nf.xfe_mul(quot_arr[:, -1], w_qs_arr[None, -1]), shared)

            invs = np.asarray(denominator_invs, np.uint64).reshape(t, 4, 3)
            deep_vals = np.stack([
                nf.xfe_mul(nf.xfe_sub(
                    main_aux_elem, np.asarray(ood_curr_main_aux, np.uint64)),
                    invs[:, 0]),
                nf.xfe_mul(nf.xfe_sub(
                    main_aux_elem, np.asarray(ood_next_main_aux, np.uint64)),
                    invs[:, 1]),
                nf.xfe_mul(nf.xfe_sub(quot_elem_p,
                                      np.asarray(ood_quot_p_value, np.uint64)),
                           invs[:, 2]),
                nf.xfe_mul(nf.xfe_sub(quot_elem_r,
                                      np.asarray(ood_quot_r_value, np.uint64)),
                           invs[:, 3]),
            ], axis=1)  # (t, 4, 3)
            w_deep = np.asarray(weights["deep"], np.uint64)    # (4, 3)
            acc = nf.xfe_sum(nf.xfe_mul(deep_vals, w_deep[None]), 1)
            if not np.array_equal(acc, np.asarray(revealed_values, np.uint64)):
                raise VerificationError("combination codeword mismatch")

        if collector is not None:
            collector.update(
                padded_height=padded_height,
                trace_domain_len=trace_domain_len,
                trace_gen=trace_gen, merkle_height=merkle_height,
                ldt_dom=ldt_dom, challenges=list(challenges.challenges),
                quot_weights=list(quot_weights), alpha=alpha,
                ood_main_curr=ood_main_curr, ood_aux_curr=ood_aux_curr,
                ood_main_next=ood_main_next, ood_aux_next=ood_aux_next,
                ood_quot_p=list(ood_quot_p), ood_quot_r=list(ood_quot_r),
                init_vals=init_vals, cons_vals=cons_vals,
                tran_vals=tran_vals, term_vals=term_vals,
                weights=weights, revealed_indices=list(revealed_indices),
                revealed_values=list(revealed_values),
                main_rows=main_arr, aux_rows=aux_arr, quot_rows=quot_arr,
                main_digests=main_digests, aux_digests=aux_digests,
                quot_digests=quot_digests,
                main_auth=main_auth, aux_auth=aux_auth,
                quot_auth=quot_auth,
                main_root=tuple(main_root), aux_root=tuple(aux_root),
                quot_root=tuple(quot_root))

        if not proof_stream.is_exhausted():
            raise VerificationError("superfluous proof items")
        return True


# ----------------------------------------------------------- helper zone

def _reveal_gather_fn(main_lde, aux_lde, segs, indices, *, stride):
    """Every revealed row in one gather per table, read back as numpy:
    main (NM, k), aux (3, NA, k), quotient segments (3, 5, k)."""
    idx = torch.as_tensor(np.asarray(indices, np.int64),
                          device=main_lde.device)
    return (gf.to_u64(main_lde.index_select(1, idx * stride)),
            gf.to_u64(aux_lde.index_select(2, idx * stride)),
            gf.to_u64(segs.index_select(2, idx)))


def _row_digests(rows_u64: np.ndarray, device):
    """Tip5 hash_varlen of every row of a (t, n) u64 array, (5, t) on
    `device`: one batched row sponge (the prover's commit kernel on a
    card), left there for the Merkle check."""
    return tip5_kernel.sponge_absorb_rows(gf.from_u64(rows_u64, device))


@functools.lru_cache(maxsize=None)
def _linearized_phase(phase):
    """Per-phase linearized AIR op list, cached across verify calls."""
    return linearize(master_air().constraints[phase])


def _powers_xfe(x, n):
    out = [xfe.ONE]
    for _ in range(n - 1):
        out.append(xfe.mul(out[-1], x))
    return out


def _sample_combination_weights(proof_stream):
    """CombinationCodewordWeights::sample (stark.rs:2166-2209)."""
    initials = proof_stream.sample_scalars(3)
    w_main_all = _powers_xfe(initials[0], NUM_MAIN + NUM_AUX)
    return {
        "main": w_main_all[:NUM_MAIN],
        "aux": w_main_all[NUM_MAIN:],
        "quot_segments": _powers_xfe(initials[1],
                                     NUM_RANDOMIZED_QUOTIENT_SEGMENTS),
        "deep": _powers_xfe(initials[2], NUM_DEEP_CODEWORD_COMPONENTS),
    }


def _linear_sum(main_row_xfe, aux_row, weights):
    acc = xfe.ZERO
    for v, w in zip(main_row_xfe, weights["main"]):
        acc = xfe.add(acc, xfe.mul(w, v))
    for v, w in zip(aux_row, weights["aux"]):
        acc = xfe.add(acc, xfe.mul(w, v))
    return acc


def _batch_inverse_xfe(values):
    """Montgomery's trick over XFEs: one inversion for n elements."""
    if not values:
        return []
    prefix = [xfe.ONE]
    for v in values:
        prefix.append(xfe.mul(prefix[-1], v))
    inv_all = xfe.inv(prefix[-1])
    out = [None] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = xfe.mul(prefix[i], inv_all)
        inv_all = xfe.mul(inv_all, values[i])
    return out


# ------------------------------------------------------------ commit stage

def _commit_bfe(cols, rand, trace_dom, eval_dom):
    """Committed codewords of trace columns (master_table.rs:258-322):
    the trace interpolant plus Z_trace(x) * r(x), evaluated on eval_dom.

    cols: int64 (..., h) trace values on trace_dom; rand: int64 (..., ntr)
    randomizer coefficients. The polynomial is formed in the coefficient
    domain (`jit_lde.committed_coefficients`), so one NTT of length E
    evaluates it (the same field elements as adding Z(x_i) * r(x_i) point
    by point). Returns the coefficients int64 (..., n), n the power of two
    above h + ntr - 1, and the codewords int64 (..., E)."""
    n = 1 << (trace_dom.length + rand.shape[-1] - 1).bit_length()
    coeffs = jit_lde.committed_coefficients(cols, rand, trace_dom, n)
    return coeffs, ntt.ntt(coeffs, eval_dom.offset, eval_dom.length)


def _merkle_tree(digests):
    """The Merkle tree over leaf digests (5, L): K1 per layer."""
    return merkle.MerkleTree.from_flat(tip5_kernel.merkle_flat(digests),
                                       digests.shape[1])


def _mesh_tree(mesh, cols, num_leafs):
    """The Merkle tree over the rows of a column-sharded table (nc, L):
    the cols->rows exchange, K2 on each shard's block of rows, K1 on each
    shard's subtree, the top layers on the lead device."""
    return merkle.MerkleTree.from_flat(pmesh.sharded_merkle_layers(
        mesh, pmesh.sharded_row_hash(mesh, cols)), num_leafs)


def _commit_tree(rows, num_leafs):
    """Row digests (the K2 sponge over the strided row view) and the
    Merkle tree over them (K1 per layer)."""
    _digests, heap = tip5_kernel.commit_rows(rows)
    return merkle.MerkleTree.from_flat(heap, num_leafs)


def _segmentify(quotient, q_randomizer, quot_dom, ldt_dom):
    """Quotient segmentation (stark.rs:1128-1360): iNTT the quotient
    codeword, split it into 4 segment polynomials, add the zeta-chain
    randomization, and evaluate all 5 randomized segments on the LDT
    domain.

    quotient: XFE (3, Q); q_randomizer: XFE (3, n_qr). Returns the segment
    codewords as int64 (5, 3, L): segment-major storage, so the flattened
    (15, L) view lists each row's elements in committed order
    [seg0.c0, seg0.c1, seg0.c2, seg1.c0, ...]."""
    Q, L = quot_dom.length, ldt_dom.length
    k = NUM_QUOTIENT_SEGMENTS
    n_qr = q_randomizer.shape[-1]
    assert Q // k <= L and n_qr <= L
    coeffs = ntt.intt(quotient, quot_dom.offset)
    polys = torch.zeros((k + 1, 3, L), dtype=torch.int64,
                        device=quotient.device)
    for s in range(k):
        polys[s, :, :Q // k] = coeffs[:, s::k]
    polys[k, :, :n_qr] = q_randomizer
    zeta_to_k = pow(ZETA, k, P)
    lens = [Q // k] * k + [n_qr]
    for i in range(k - 1, -1, -1):
        n1 = lens[i + 1]
        # segment i absorbs -zeta^i * (zeta^k)^j * segment_{i+1}[j]
        fac = gf.powers(zeta_to_k, n1, P - pow(ZETA, i, P), quotient.device)
        addend = gfx.bfe_mul(polys[i + 1, :, :n1], fac)
        polys[i, :, :n1] = gfx.add(polys[i, :, :n1], addend)
        lens[i] = max(lens[i], n1)
    return ntt.ntt(polys, ldt_dom.offset)


# ---------------------------------------------------------- quotient tapes

def _quotient_inputs(challenges, quot_weights, dev):
    """The challenges, XFE (3, 63), and each phase's constraint weights,
    XFE (3, k), on `dev`."""
    air = master_air()
    ch = gfx.from_u64(np.array(challenges.challenges, np.uint64), dev)
    w = np.array(quot_weights, np.uint64)  # (num_constraints, 3)
    ws, off = [], 0
    for ph in ("init", "cons", "tran", "term"):
        k = len(air.constraints[ph])
        ws.append(gfx.from_u64(w[off:off + k], dev))
        off += k
    return ch, ws


def _quotients_on_domain(main, aux, dom, shift, trace_dom, ch, ws):
    """The combined quotient at every point of `dom` from the committed
    values there (main int64 (NM, N), aux XFE (3, NA, N)); a row's next
    row lies `shift` rows ahead, cyclically. Returns XFE (3, N)."""
    return _quotients_on_rows(
        main, aux, quotient_cuda.Points(dom.generator, dom.offset,
                                        dom.length), shift, trace_dom, ch,
        ws)


def _quotients_on_rows(main, aux, points, shift, trace_dom, ch, ws,
                       chunk=None):
    """The combined quotient at the N points of `points` (a
    `quotient_cuda.Points`: x_i = offset * generator^(start + i)) from
    the committed values in the first N columns of main int64 (NM, M) and
    aux XFE (3, NA, M); row i's next row is row (i + shift) % M: the whole
    domain cyclically where M = N, a shard's block followed by its halo
    where M = N + shift (parallel/mesh.py). K3 runs the row tape
    (ops/quotient_cuda.py), on a card about 100 launches a chunk of
    `chunk` rows, reading main and aux in place and forming the points
    itself; on the CPU its plain version, a chunk of rows at a time.
    Returns XFE (3, N)."""
    return quotient_cuda.quotients_on_rows(
        aircomp.quotient_row_tape(), main, aux, points, shift,
        trace_dom.length, bfe.inv(trace_dom.generator), ch,
        torch.cat(ws, dim=1), chunk)


def _all_quotients_combined_device(main_q, aux_q, trace_dom, quot_dom,
                                   challenges, quot_weights):
    """master_table.rs:1264-1363 on tensors: run the compiled AIR row tape
    over the quotient domain (K3 on a card, its plain version on the CPU:
    `_quotients_on_rows`) and combine with the weights and zerofier
    inverses.

    main_q: int64 (NM, Q); aux_q: XFE (3, NA, Q). Returns XFE (3, Q)."""
    ch, ws = _quotient_inputs(challenges, quot_weights, main_q.device)
    return _quotients_on_domain(main_q, aux_q, quot_dom,
                                quot_dom.length // trace_dom.length,
                                trace_dom, ch, ws)
