"""The STIR verifier's batched in-domain answers
(triton_vm_tpu_torch.ldt.stir._in_domain_answers) against the JAX
package's scalar `_subsequent_in_domain_answers` and
`_initial_in_domain_answers` on random rounds, the last round's check, a
revealed point inside the quotient set, and the `STIR answered points`
counter of a whole verify."""

import numpy as np
import pytest
import torch

from triton_vm_tpu.fields import poly as jpoly
from triton_vm_tpu.fields import xfe as jxfe
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ldt.stir import _initial_in_domain_answers as jax_initial
from triton_vm_tpu.ldt.stir import \
    _subsequent_in_domain_answers as jax_subsequent
from triton_vm_tpu_torch.fields import bfe, xfe
from triton_vm_tpu_torch.ldt import stir as st
from triton_vm_tpu_torch.ldt.fri import GENERATOR, LdtError
from triton_vm_tpu_torch.ops import gfx, ntt
from triton_vm_tpu_torch.ops import npfield as nf
from triton_vm_tpu_torch.stark.arithmetic_domain import Domain
from triton_vm_tpu_torch.stark.proof_stream import ProofStream
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)

K = 4
CPU = torch.device("cpu")
# The previous round's domain, its folded domain, and the round's domain
PREV_DOMAIN = Domain(1024, GENERATOR)
PREV_FOLDED = PREV_DOMAIN.pow(K)
ROUND_DOMAIN = st.Stir.next_round_domain(PREV_DOMAIN)


def _xfe(rng):
    return tuple(int(c) for c in rng.integers(0, P, 3, dtype=np.uint64))


def _queries(domain, raw_indices, rng):
    """`Stir._extract_inclusion_proof`'s per-query data for raw indices of
    `domain`, the revealed values drawn once per folded index."""
    folded = domain.pow(K)
    kth_root = pow(domain.generator, folded.length, P)
    leaves = {}
    out = []
    for index in raw_indices:
        qi = index % folded.length
        leaf = leaves.setdefault(qi, [_xfe(rng) for _ in range(K)])
        out.append({"index": index, "point": folded.value(qi),
                    "root": domain.value(qi), "kth_root": kth_root,
                    "values": leaf})
    return out


def _previous_round(num_points, rng):
    """A previous round's queries (some folding onto one index), their
    answers, and two OOD samples: a fresh one and one that repeats a
    queried point, which the de-duplication drops."""
    indices = rng.choice(PREV_FOLDED.length, num_points, replace=False)
    raw = [int(i) + PREV_FOLDED.length * int(rng.integers(0, K))
           for i in indices]
    raw += raw[:num_points // 3]
    queries = _queries(PREV_DOMAIN, raw, rng)
    answers = {}
    for q in queries:
        answers.setdefault(q["point"], _xfe(rng))
    ood = [_xfe(rng), jxfe.lift(queries[-1]["point"])]
    return (queries, [answers[q["point"]] for q in queries], ood,
            [_xfe(rng) for _ in ood])


def _jax_quotient_set(queries, answers, ood, ood_answers):
    """Stir.verify's de-duplication by point (stir.rs:1026-1033)."""
    points = [jxfe.lift(q["point"]) for q in queries] + ood
    quotient_set, quotient_answers, seen = [], [], set()
    for pt, ans in zip(points, list(answers) + ood_answers):
        if pt not in seen:
            seen.add(pt)
            quotient_set.append(pt)
            quotient_answers.append(ans)
    return quotient_set, quotient_answers


def _tuples(arr):
    return [tuple(int(c) for c in row) for row in arr]


# (quotient-set points of the folded domain, queries of the round)
CASES = [(1, 1), (3, 8), (16, 40), (60, 97), (100, 146)]


@pytest.mark.parametrize("num_points,num_queries", CASES,
                         ids=[f"m{m}-q{q}" for m, q in CASES])
def test_batched_answers_equal_jax_scalar_answers(num_points, num_queries):
    """Every round kind of one random case: the first round's folds; a
    later round's quotient, degree correction and fold, with an OOD sample
    that repeats a queried point (de-duplicated away) and the
    degree-correction randomness chosen so that c = 1 at one revealed
    point; and the last round's check, which passes on the answers'
    polynomial and raises on one altered answer."""
    rng = np.random.default_rng(1000 * num_points + num_queries)
    prev = _previous_round(num_points, rng)
    quotient_set, quotient_answers = _jax_quotient_set(*prev)
    assert len(quotient_set) == len({q["point"] for q in prev[0]}) + 1

    raw = [int(i) for i in rng.integers(0, ROUND_DOMAIN.length, num_queries)]
    queries = _queries(ROUND_DOMAIN, raw, rng)
    r = _xfe(rng)
    x = queries[-1]["root"] * pow(queries[-1]["kth_root"], 2, P) % P
    dc = jxfe.lift(bfe.inv(x))

    got = st._in_domain_answers(ROUND_DOMAIN, K, queries, r, None, CPU)
    assert _tuples(got) == jax_initial(queries, r)

    quotienting = st._Quotienting.of(PREV_FOLDED, *prev, dc)
    assert len(quotienting.answers) == len(quotient_set)
    got = st._in_domain_answers(ROUND_DOMAIN, K, queries, r, quotienting,
                                CPU)
    want = jax_subsequent((quotient_set, quotient_answers, dc), queries, r)
    assert _tuples(got) == want

    final_poly = [_xfe(rng) for _ in range(num_points)]
    answers = np.asarray(
        [jpoly.evaluate(final_poly, jxfe.lift(q["point"]), jxfe)
         for q in queries], np.uint64)
    st._check_last_round(final_poly, queries, answers)
    answers[-1, 1] = (int(answers[-1, 1]) + 1) % P
    with pytest.raises(LdtError):
        st._check_last_round(final_poly, queries, answers)


def test_revealed_point_in_quotient_set_raises():
    """An OOD sample at a revealed point of the round makes Z(x) = 0 there:
    the batched inversion raises as the scalar `xfe.inv` does."""
    rng = np.random.default_rng(7)
    queries_prev, answers, ood, ood_answers = _previous_round(8, rng)
    queries = _queries(ROUND_DOMAIN, [5, 300, 77], rng)
    ood = [jxfe.lift(queries[1]["root"])]
    ood_answers = ood_answers[:1]
    r, dc = _xfe(rng), _xfe(rng)
    quotient_set, quotient_answers = _jax_quotient_set(
        queries_prev, answers, ood, ood_answers)
    with pytest.raises(ZeroDivisionError):
        jax_subsequent((quotient_set, quotient_answers, dc), queries, r)
    quotienting = st._Quotienting.of(PREV_FOLDED, queries_prev, answers, ood,
                                     ood_answers, dc)
    with pytest.raises(ZeroDivisionError):
        st._in_domain_answers(ROUND_DOMAIN, K, queries, r, quotienting, CPU)


@pytest.mark.parametrize("e", [0, 1, 2, 217, P - 2])
def test_npfield_inverse_and_power_equal_scalar(e):
    """The batched XFE inverse and base-field power the answers use against
    fields/xfe.py's `inv` and Python's `pow`, on XFE and lifted base
    values; a zero among them raises as `xfe.inv` does."""
    rng = np.random.default_rng(e % 1000)
    a = rng.integers(0, P, (4, 5, 3), dtype=np.uint64)
    a[0, :, 1:] = 0
    assert _tuples(nf.xfe_inv(a).reshape(-1, 3)) == [
        xfe.inv(x) for x in _tuples(a.reshape(-1, 3))]
    x = a[..., 0]
    assert [int(v) for v in nf.bfe_pow(x, e).reshape(-1)] == [
        pow(int(v), e, P) for v in x.reshape(-1)]
    a[2, 3] = 0
    with pytest.raises(ZeroDivisionError):
        nf.xfe_inv(a)


def test_answered_points_counter_equals_queries_times_folding_factor():
    """A profiled verify counts k revealed points a query, over the full
    rounds and the last: in the session's `STIR verify answers` intervals
    and in `profiler.totals()`."""
    stir = st.Stir(st.StirParameters(security_level=20, log2_folding_factor=2,
                                     log2_initial_expansion_factor=2,
                                     log2_high_degree_bound=11))
    assert len(stir.round_queries) >= 1
    coeffs = np.zeros((stir.domain.length, 3), np.uint64)
    coeffs[:stir.params.max_degree() + 1] = np.random.default_rng(8).integers(
        0, P, (stir.params.max_degree() + 1, 3), dtype=np.uint64)
    ps = ProofStream()
    stir.prove(ntt.ntt(gfx.from_u64(coeffs), stir.domain.offset), ps)

    before = profiler.totals().count("STIR answered points")
    profiler.start("stir verify")
    try:
        stir.verify(ProofStream.decode(ps.to_proof().words), "cpu")
    finally:
        profile = profiler.finish()
    want = K * (sum(q for q, _ in stir.round_queries)
                + stir.final_num_in_domain_queries)
    got = [iv.counts.get("STIR answered points", 0)
           for iv in profile.intervals()
           if iv.path[-1] == "STIR verify answers"]
    assert len(got) == len(stir.round_queries) + 1
    assert sum(got) == want
    assert profiler.totals().count("STIR answered points") - before == want
