"""The port's STIR low-degree test (triton_vm_tpu_torch.ldt.stir) against
the JAX package's: parameter derivation, transcripts word for word,
cross-package verification, rejections, the batched point evaluation, the
query evaluation by one transform onto the folded domain, the zerofier and
the interpolant of a round's points as coefficients, and a whole fib(10)
STIR proof on the CPU hashed to the JAX package's digest."""

import numpy as np
import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ldt.stir import Stir as JStir
from triton_vm_tpu.ldt.stir import StirParameters as JStirParameters
from triton_vm_tpu.stark.proof_stream import ProofStream as JProofStream
from triton_vm_tpu.stark.prover import Stark as JStark
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.fields import poly, xfe
from triton_vm_tpu_torch.ldt import stir as st
from triton_vm_tpu_torch.ldt.fri import GENERATOR, LdtError
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.ops import gfx, ntt
from triton_vm_tpu_torch.stark.arithmetic_domain import Domain
from triton_vm_tpu_torch.stark.proof_stream import ProofStream
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)

SEED = bytes(range(32))
# Proof digest tip5.hash_varlen([len(w) + 1, len(w)] + w) of the JAX
# package's STIR proof of fibonacci input 10 with seed bytes(range(32)),
# computed on the CPU with (the JAX STIR end-to-end test is `slow`):
#   JAX_PLATFORMS=cpu python -c "
#   from triton_vm_tpu.models import example_programs as ex
#   from triton_vm_tpu.stark.proof_stream import Claim
#   from triton_vm_tpu.stark.prover import Stark
#   from triton_vm_tpu.vm.machine import VM, PublicInput
#   from triton_vm_tpu.crypto import tip5
#   p = ex.fibonacci(); aet, out = VM.trace_execution(p, PublicInput([10]))
#   c = Claim.about_program(p).with_input([10]).with_output(out)
#   w = Stark(ldt_choice='stir').prove(c, aet, seed=bytes(range(32))).words
#   print(tip5.hash_varlen([len(w) + 1, len(w)] + w))"
JAX_STIR_FIB10_DIGEST = (8250308692570386992, 6453021769372292027,
                         326252916234513582, 2375813373481364893,
                         15531984184678886719)

# (security level, log2 high-degree bound): tests/test_stir.py:68's
# parameters (no full round), and a pair with two full rounds
PARAMS = [(64, 8), (20, 11)]


@pytest.mark.parametrize("log2_height", range(8, 21))
def test_parameters_equal_jax_stark_stir(log2_height):
    got = tvm.Stark(device="cpu").stir(1 << log2_height)
    want = JStark().stir(1 << log2_height)
    assert got.params.log2_high_degree_bound == \
        want.params.log2_high_degree_bound
    assert (got.domain.length, got.domain.offset) == \
        (want.domain.length, want.domain.offset)
    assert got.round_queries == want.round_queries
    assert got.final_num_in_domain_queries == \
        want.final_num_in_domain_queries
    assert got.final_degree == want.final_degree
    assert got.num_first_round_queries() == want.num_first_round_queries()


def test_ldt_is_stir_from_height_2_16():
    stark = tvm.Stark(device="cpu")
    assert isinstance(stark.ldt(1 << 15), tvm.Fri)
    assert isinstance(stark.ldt(1 << 16), st.Stir)
    assert isinstance(tvm.Stark(ldt_choice="stir", device="cpu").ldt(256),
                      st.Stir)
    assert isinstance(tvm.Stark(soundness="conjectured",
                                device="cpu").ldt(1 << 16), tvm.Fri)


def _stirs(security, log2_bound):
    args = dict(security_level=security, log2_folding_factor=2,
                log2_initial_expansion_factor=2,
                log2_high_degree_bound=log2_bound)
    return st.Stir(st.StirParameters(**args)), JStir(JStirParameters(**args))


def _codeword(stir, degree, seed):
    """A seeded codeword of the given degree on the initial domain: the
    port's XFE tensor (3, n) and the same values as host tuples."""
    rng = np.random.default_rng(seed)
    coeffs = np.zeros((stir.domain.length, 3), np.uint64)
    coeffs[:degree + 1] = rng.integers(0, P, (degree + 1, 3),
                                       dtype=np.uint64)
    cw = ntt.ntt(gfx.from_u64(coeffs), stir.domain.offset)
    return cw, gfx.to_tuples(cw)


@pytest.fixture(scope="module", params=PARAMS, ids=lambda p: f"{p[0]}-{p[1]}")
def transcripts(request):
    """One low-degree codeword proven by each package: the JAX package's
    host round loop (the oracle) and the port's device loop."""
    stir, jstir = _stirs(*request.param)
    cw, cw_host = _codeword(stir, stir.params.max_degree(), seed=21)
    ps = ProofStream()
    indices = stir.prove(cw, ps)
    jps = JProofStream()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TVM_STIR_DEVICE", "0")
        jindices = jstir.prove(list(cw_host), jps)
    return dict(stir=stir, jstir=jstir, cw=cw, cw_host=cw_host,
                indices=indices,
                words=ps.to_proof().words, jindices=jindices,
                jwords=[int(w) for w in jps.to_proof().words])


def test_prove_transcript_equals_jax_host_loop(transcripts):
    assert transcripts["indices"] == transcripts["jindices"]
    assert transcripts["words"] == transcripts["jwords"]


def test_prove_evaluates_only_ood_samples_point_by_point(transcripts,
                                                         monkeypatch):
    """The queried points' values come from the transform onto the folded
    domain: the point evaluation sees only each full round's out-of-domain
    samples (XFE points off the base field), and the transcript is the
    JAX host loop's still."""
    calls = []
    eval_folded_at = st._eval_folded_at

    def recording(coeffs, points):
        calls.append(list(points))
        return eval_folded_at(coeffs, points)

    monkeypatch.setattr(st, "_eval_folded_at", recording)
    stir = transcripts["stir"]
    ps = ProofStream()
    assert stir.prove(transcripts["cw"], ps) == transcripts["jindices"]
    assert [len(c) for c in calls] == [ood for _, ood in stir.round_queries]
    assert all(pt[1] or pt[2] for c in calls for pt in c)
    assert ps.to_proof().words == transcripts["jwords"]


def test_port_verifier_accepts_jax_transcript(transcripts):
    stir = transcripts["stir"]
    indices, partial = stir.verify(
        ProofStream.decode(transcripts["jwords"]), "cpu")
    assert indices == transcripts["jindices"]
    assert partial == [tuple(transcripts["cw_host"][i]) for i in indices]


def test_jax_verifier_accepts_port_transcript(transcripts):
    jstir = transcripts["jstir"]
    indices, partial = jstir.verify(JProofStream.decode(transcripts["words"]))
    assert indices == transcripts["indices"]
    assert [tuple(int(c) for c in x) for x in partial] == \
        [tuple(transcripts["cw_host"][i]) for i in indices]


@pytest.mark.parametrize("params", PARAMS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_rejects_high_degree_codeword(params):
    stir, _ = _stirs(*params)
    cw, _ = _codeword(stir, stir.params.max_degree() + 1, seed=3)
    ps = ProofStream()
    stir.prove(cw, ps)
    with pytest.raises(LdtError):
        stir.verify(ProofStream.decode(ps.to_proof().words), "cpu")


def test_rejects_tampered_word(transcripts):
    words = list(transcripts["words"])
    words[len(words) // 2] = (words[len(words) // 2] + 1) % P
    with pytest.raises(Exception):
        transcripts["stir"].verify(ProofStream.decode(words), "cpu")


@pytest.mark.parametrize("n", [128, 1000, 1024, 4096])
def test_eval_folded_at_equals_poly_evaluate(n):
    rng = np.random.default_rng(n)
    coeffs = rng.integers(0, P, (n, 3), dtype=np.uint64)
    points = [tuple(int(c) for c in rng.integers(0, P, 3, dtype=np.uint64))
              for _ in range(5)]
    points.append(xfe.lift(int(rng.integers(0, P, dtype=np.uint64))))
    got = st._eval_folded_at(gfx.from_u64(coeffs), points)
    host = [tuple(int(c) for c in row) for row in coeffs]
    assert got == [poly.evaluate(host, x, xfe) for x in points]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [16, 512, 4096])
def test_eval_on_folded_domain_equals_point_evaluation(n, seed):
    """The values at queried indices of a folded domain (0, the last index,
    raw indices that fold onto one index, random ones) from one transform
    and a gather, against the batched point evaluation and `poly.evaluate`
    at the same points."""
    rng = np.random.default_rng(seed * 7919 + n)
    k = 4
    folded_domain = Domain(k * n, GENERATOR).pow(k)
    coeffs = rng.integers(0, P, (n, 3), dtype=np.uint64)
    raw = [0, k * n - 1, n, 2 * n - 1]
    raw += [int(i) for i in rng.integers(0, k * n, 24)]
    indices = st._unique(i % n for i in raw)
    assert indices[:2] == [0, n - 1] and len(indices) < len(raw)
    folded = gfx.from_u64(coeffs)
    got = gfx.to_tuples(st._eval_on_folded_domain(folded, folded_domain,
                                                  indices))
    points = [xfe.lift(folded_domain.value(i)) for i in indices]
    assert got == st._eval_folded_at(folded, points)
    host = [tuple(int(c) for c in row) for row in coeffs]
    assert got == [poly.evaluate(host, x, xfe) for x in points]


@pytest.mark.parametrize("length", [32, 128])
def test_eval_on_folded_domain_rejects_wrong_length(length):
    folded = gfx.from_u64(np.ones((length, 3), np.uint64))
    with pytest.raises(LdtError):
        st._eval_on_folded_domain(folded, Domain(64, GENERATOR), [0, 1])


def test_queried_points_counter_equals_unique_folded_indices():
    """In a profiler session, each full round's `STIR query evaluation`
    counts the unique folded indices it serves: the leaves that round's
    response reveals."""
    stir, _ = _stirs(*PARAMS[1])
    cw, _ = _codeword(stir, stir.params.max_degree(), seed=8)
    ps = ProofStream()
    profiler.start("stir")
    try:
        stir.prove(cw, ps)
    finally:
        profile = profiler.finish()
    got = [iv.counts["STIR queried points"] for iv in profile.intervals()
           if iv.path[-1] == "STIR query evaluation"]
    responses = [it.payload for it in ps.items
                 if it.variant == "StirResponse"]
    assert len(got) == len(stir.round_queries) >= 1
    assert got == [len(r["queried_leaves"]) for r in responses[:-1]]


# Numbers of interpolation points: one to a full block of 256
QUOTIENT_SET_SIZES = [1, 2, 3, 5, 16, 33, 145, 256]


def _quotient_sets(m, seed):
    """Three sets of m distinct points, as (domain indices, XFE points) of
    Domain(1024, GENERATOR): all lifted base values (points of the domain),
    all XFE, and half and half."""
    rng = np.random.default_rng(seed)
    sets = []
    for num_xfe in (0, m, m // 2):
        indices = [int(i) for i in rng.choice(1024, m - num_xfe,
                                              replace=False)]
        ood = [tuple(int(c) for c in rng.integers(0, P, 3, dtype=np.uint64))
               for _ in range(num_xfe)]
        sets.append((indices, ood))
    return Domain(1024, GENERATOR), sets


@pytest.mark.parametrize("m", QUOTIENT_SET_SIZES)
def test_zerofier_equals_host_zerofier(m):
    """The zerofier's coefficients against `poly.zerofier`, and their values
    on a coset (one transform) against `poly.evaluate` at every point."""
    domain, sets = _quotient_sets(m, seed=m)
    coset = Domain(512, 7)
    for indices, ood in sets:
        points = [xfe.lift(domain.value(i)) for i in indices] + ood
        zb, z = st._zerofier([pt[0] for pt in points[:len(indices)]], ood)
        want = poly.zerofier(points, xfe)
        assert [int(c) for c in zb] == poly.zerofier(
            [domain.value(i) for i in indices])
        assert [tuple(int(c) for c in row) for row in z] == want
        (got,) = st._eval_poly_on_domain_dev([z], coset, "cpu")
        assert gfx.to_tuples(got) == [
            poly.evaluate(want, xfe.lift(coset.value(i)), xfe)
            for i in range(coset.length)]


@pytest.mark.parametrize("m", QUOTIENT_SET_SIZES)
def test_interpolant_equals_host_interpolate(m):
    """The batched interpolant's coefficients against `poly.interpolate`,
    word for word (zero-padded to m), for points of a domain, XFE points,
    and both."""
    domain, sets = _quotient_sets(m, seed=1000 + m)
    rng = np.random.default_rng(m)
    for indices, ood in sets:
        points = [xfe.lift(domain.value(i)) for i in indices] + ood
        values = rng.integers(0, P, (m, 3), dtype=np.uint64)
        zerofier = st._zerofier([domain.value(i) for i in indices], ood)
        got = st._interpolate_dev(domain, indices, ood,
                                  gfx.from_u64(values), zerofier)
        want = poly.interpolate(
            points, [tuple(int(c) for c in row) for row in values], xfe)
        assert gfx.to_tuples(got) == want + [xfe.ZERO] * (m - len(want))


@pytest.mark.parametrize("repeated", ["domain point", "xfe point"])
def test_interpolant_raises_on_repeated_point(repeated):
    domain, [(indices, _), (_, ood), _] = _quotient_sets(8, seed=5)
    if repeated == "domain point":
        indices, ood = indices + indices[:1], []
    else:
        indices, ood = [], ood + ood[:1]
    values = gfx.from_u64(np.ones((len(indices) + len(ood), 3), np.uint64))
    zerofier = st._zerofier([domain.value(i) for i in indices], ood)
    with pytest.raises(ZeroDivisionError):
        st._interpolate_dev(domain, indices, ood, values, zerofier)
    with pytest.raises(ZeroDivisionError):
        poly.interpolate([xfe.lift(domain.value(i)) for i in indices] + ood,
                         gfx.to_tuples(values), xfe)


def test_fold_device_equals_fold_polynomial():
    rng = np.random.default_rng(5)
    coeffs = rng.integers(0, P, (64, 3), dtype=np.uint64)
    r = tuple(int(c) for c in rng.integers(0, P, 3, dtype=np.uint64))
    got = gfx.to_tuples(st._fold_device(gfx.from_u64(coeffs), 4, r))
    host = [tuple(int(c) for c in row) for row in coeffs]
    assert got == st.Stir.fold_polynomial(host, 4, r)


@pytest.fixture(scope="module")
def fib10_stir():
    stark = tvm.Stark(ldt_choice="stir", device="cpu")
    program = ex.fibonacci()
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([10]))
    claim = tvm.Claim.about_program(program).with_input([10]) \
        .with_output(output)
    return stark, claim, stark.prove(claim, aet, seed=SEED)


def test_fib10_stir_proof_hashes_to_jax_digest(fib10_stir):
    _, _, proof = fib10_stir
    w = proof.words
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) == \
        JAX_STIR_FIB10_DIGEST


def test_fib10_stir_proof_verifies_and_fri_stark_rejects_it(fib10_stir):
    stark, claim, proof = fib10_stir
    assert stark.verify(claim, proof)
    assert not tvm.verify(tvm.Stark(ldt_choice="fri", device="cpu"), claim,
                          proof)
