"""The port's JIT (coset-by-coset) LDE (triton_vm_tpu_torch.stark.jit_lde)
and its bounded working set: per-coset committed values against the JAX
package's full-domain recipe, digests and revealed rows against the
cached path, the JIT quotient codeword against the cached one, the
blocked transforms and reductions against one unblocked call, the cache
decision, and forced-JIT fib(10) proofs (FRI and STIR) hashed to the
JAX package's pinned digests. Exact equality throughout."""

import numpy as np
import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu.fields.bfe import P
from triton_vm_tpu.ops import gf as jgf
from triton_vm_tpu.ops import ntt as jntt
from triton_vm_tpu_torch import config
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.ops import (gf, gfx, kernels, ntt, quotient_cuda,
                                     tip5_cuda)
from triton_vm_tpu_torch.stark import jit_lde, prover
from triton_vm_tpu_torch.stark.arithmetic_domain import Domain

torch.set_num_threads(2)

SEED = bytes(range(32))
# tests/test_torch_stark.py's PINNED_FIB10_DIGEST (the JAX package's FRI
# proof of fibonacci input 10) and tests/test_torch_stir.py's
# JAX_STIR_FIB10_DIGEST (its STIR proof), seed bytes(range(32))
PINNED_FIB10_DIGEST = (7024632114429628424, 11029959989076809184,
                       8246888127736946106, 15137373578292407606,
                       15772038778546270844)
JAX_STIR_FIB10_DIGEST = (8250308692570386992, 6453021769372292027,
                         326252916234513582, 2375813373481364893,
                         15531984184678886719)


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _setup(expansion, nc=8, h=32, ntr=5, xfe=False):
    """tests/test_jit_lde.py's sizes: randomized length n = 2h, E = n *
    expansion / 2, eval domain offset 7."""
    n = 2 * h
    shape = (nc, 3) if xfe else (nc,)
    table = _field(expansion + 10 * xfe, shape + (h,))
    rand = _field(expansion + 10 * xfe + 1, shape + (ntr,))
    coeffs = jit_lde.committed_coefficients(
        gf.from_u64(table), gf.from_u64(rand), Domain(h), n)
    return table, rand, coeffs, Domain(n * expansion // 2, 7), h


def _jax_committed(table, rand, eval_dom, h):
    """tests/test_jit_lde.py:28-39: the full-domain LDE of the trace plus
    the trace zerofier times the randomizer, on the JAX package."""
    E = eval_dom.length
    nc, ntr = table.shape[0], rand.shape[-1]
    lde = jntt.lde(jgf.from_u64(table), E // h, 1, eval_dom.offset)
    rand_full = np.zeros((nc, E), np.uint64)
    rand_full[:, :ntr] = rand
    rand_eval = jntt.ntt(jgf.from_u64(rand_full), eval_dom.offset)
    xs = np.array(eval_dom.values(), np.uint64)
    zvals = np.array([(pow(int(x), h, P) - 1) % P for x in xs], np.uint64)
    z = jgf.from_u64(np.broadcast_to(zvals, (nc, E)))
    return jgf.to_u64(jgf.add(lde, jgf.mul(z, rand_eval)))


@pytest.mark.parametrize("expansion", [8, 16])
def test_coset_values_match_jax_full_domain_commit(expansion):
    table, rand, coeffs, eval_dom, h = _setup(expansion)
    want = _jax_committed(table, rand, eval_dom, h)
    n = coeffs.shape[-1]
    m = eval_dom.length // n
    got = np.zeros_like(want)
    for t, offset in jit_lde.cosets(eval_dom, n):
        got[:, t::m] = gf.to_u64(ntt.ntt(coeffs, offset))
    assert m == expansion // 2
    assert np.array_equal(got, want)


@pytest.mark.parametrize("xfe", [False, True])
@pytest.mark.parametrize("ldt_stride", [1, 2])
def test_committed_digests_match_hash_of_full_rows(xfe, ldt_stride):
    """E = L, and E = 2L: only every second point is an LDT (hashed) row."""
    table, rand, coeffs, eval_dom, h = _setup(16, xfe=xfe)
    E = eval_dom.length
    L = E // ldt_stride
    _, full = prover._commit_bfe(gf.from_u64(table), gf.from_u64(rand),
                                 Domain(h), eval_dom)
    if not xfe:
        assert np.array_equal(gf.to_u64(full),
                              _jax_committed(table, rand, eval_dom, h))
    want = tip5_cuda.sponge_absorb_rows_plain(
        full.reshape(-1, E)[:, ::ldt_stride].T.contiguous())
    fn = (jit_lde.committed_digests_xfe if xfe
          else jit_lde.committed_digests_bfe)
    assert torch.equal(fn(coeffs, eval_dom, L), want)


@pytest.mark.parametrize("ldt_stride", [1, 2])
def test_revealed_rows_match_cached_gather(ldt_stride):
    table, rand, coeffs, eval_dom, h = _setup(16)
    xtable, xrand, xcoeffs, _, _ = _setup(16, xfe=True)
    L = eval_dom.length // ldt_stride
    idx = [int(i) for i in np.random.default_rng(3).integers(0, L, 23)]
    _, main = prover._commit_bfe(gf.from_u64(table), gf.from_u64(rand),
                                 Domain(h), eval_dom)
    _, aux = prover._commit_bfe(gf.from_u64(xtable), gf.from_u64(xrand),
                                Domain(h), eval_dom)
    aux = aux.permute(1, 0, 2)
    segs = gfx.zeros((5, L))
    msel, a3, _ = prover._reveal_gather_fn(main, aux, segs, idx,
                                           stride=ldt_stride)
    got = jit_lde.reveal_rows_bfe(coeffs, eval_dom, L, idx)
    assert got.shape == (8, len(idx))
    assert np.array_equal(got, msel)
    got3 = jit_lde.reveal_rows_xfe(xcoeffs, eval_dom, L, idx)
    assert got3.shape == (8, 3, len(idx))
    assert np.array_equal(got3.transpose(1, 0, 2), a3)


def test_jit_quotient_codeword_matches_cached(monkeypatch):
    """fib(10): the quotient domain's cosets, row-chunked (next rows roll
    across chunk edges inside a coset), against the cached codeword."""
    from triton_vm_tpu.tables import master as jmt
    from triton_vm_tpu_torch.air.challenges import SAMPLE_COUNT, Challenges
    from triton_vm_tpu_torch.air.master import master_air
    from triton_vm_tpu_torch.tables import master as mt

    program = ex.fibonacci()
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([10]))
    claim = tvm.Claim.about_program(program).with_input([10]) \
        .with_output(output)
    _, ntr, trace_dom, rand_dom, quot_dom, _ = tvm.Stark(
        device="cpu").derive_domains(aet.padded_height())
    h, n = trace_dom.length, rand_dom.length
    main = mt.fill_main_table(aet, padded_height=h, device="cpu")
    jmt.fill_derived_main_columns(main)
    challenges = Challenges([tuple(int(c) for c in row)
                             for row in _field(4, (SAMPLE_COUNT, 3))], claim)
    aux = jmt.extend_host(main, challenges)
    jmt.fill_derived_aux_columns(main, aux, challenges.challenges)
    main_t = gf.from_u64(np.ascontiguousarray(main.T))
    aux_t = gf.from_u64(np.ascontiguousarray(aux.transpose(1, 2, 0)))
    main_r = gf.from_u64(_field(5, (prover.NUM_MAIN, ntr)))
    aux_r = gf.from_u64(_field(6, (prover.NUM_AUX, 3, ntr)))
    weights = prover._powers_xfe(
        (3, 1, 4), sum(len(cs) for cs in master_air().constraints.values()))

    want = prover._all_quotients_combined_device(
        prover._commit_bfe(main_t, main_r, trace_dom, quot_dom)[1],
        prover._commit_bfe(aux_t, aux_r, trace_dom, quot_dom)[1].permute(
            1, 0, 2), trace_dom, quot_dom, challenges, weights)
    monkeypatch.setattr(quotient_cuda, "CHUNK_ROWS", n // 4)
    got = jit_lde.quotient_codeword_jit(
        jit_lde.committed_coefficients(main_t, main_r, trace_dom, n),
        jit_lde.committed_coefficients(aux_t, aux_r, trace_dom, n),
        trace_dom, quot_dom, challenges, weights)
    assert quot_dom.length // n > 1
    assert torch.equal(got, want)


def _blocked_cases():
    cols = gf.from_u64(_field(7, (5, 64)))
    xcols = gf.from_u64(_field(8, (3, 4, 64)))
    w_main = gf.from_u64(_field(9, (3, 5)))
    w_aux = gf.from_u64(_field(10, (3, 4)))
    points = gf.from_u64(_field(11, (3, 2)))
    xs = gf.powers(Domain(64, 7).generator, 64, 7)
    return {
        "ntt": lambda: ntt.ntt(xcols, 7),
        "ntt_padded": lambda: ntt.ntt(cols, 3, 256),
        "intt": lambda: ntt.intt(xcols, 7),
        "lde": lambda: ntt.lde(cols, 4, 7, 3),
        "weighted_column_sum": lambda: kernels.weighted_column_sum(
            cols, xcols, w_main, w_aux),
        "bary_eval_multi": lambda: kernels._bary_eval_multi(
            xcols, xs, points),
        "poly_eval_multi": lambda: torch.cat(kernels.poly_eval_multi(
            cols, xcols, points), dim=-1),
    }


@pytest.mark.parametrize("name", list(_blocked_cases()))
def test_blocked_working_set_matches_one_unblocked_call(name, monkeypatch):
    """One row a block (a budget of 1 byte) against one block for all."""
    fn = _blocked_cases()[name]
    monkeypatch.setattr(gf, "WORK_BYTES", 1 << 40)
    whole = fn()
    monkeypatch.setattr(gf, "WORK_BYTES", 1)
    assert gf.block_rows(1) == 1
    assert torch.equal(fn(), whole)


def test_ood_rows_from_coefficients_equal_barycentric_over_codewords():
    """The OOD rows come from the committed polynomials' coefficients:
    the same field elements as the barycentric formula over their
    codewords on a larger coset."""
    coeffs = gf.from_u64(_field(14, (5, 16)))
    xcoeffs = gf.from_u64(_field(15, (3, 4, 16)))
    points = gf.from_u64(_field(16, (3, 2)))
    dom = Domain(64, 7)
    xs = gf.powers(dom.generator, 64, 7)
    got_main, got_aux = kernels.poly_eval_multi(coeffs, xcoeffs, points)
    lifted = torch.stack([coeffs, torch.zeros_like(coeffs),
                          torch.zeros_like(coeffs)])
    assert torch.equal(got_main, kernels._bary_eval_multi(
        ntt.ntt(lifted, 7, 64), xs, points))
    assert torch.equal(got_aux, kernels._bary_eval_multi(
        ntt.ntt(xcoeffs, 7, 64), xs, points))


def test_poly_eval_multi_matches_horner():
    coeffs = _field(12, (2, 37))
    point = tuple(int(c) for c in _field(13, 3))
    from triton_vm_tpu_torch.fields import poly, xfe

    got, _ = kernels.poly_eval_multi(gf.from_u64(coeffs), None,
                                     gfx.full((1,), point))
    for j in range(2):
        want = poly.evaluate([xfe.lift(int(c)) for c in coeffs[j]], point,
                             xfe)
        assert gfx.to_tuples(got[:, 0, j:j + 1])[0] == tuple(want)


def test_cache_decision_at_80_gb_free(monkeypatch):
    monkeypatch.setattr(config, "_device_memory_bytes", lambda dev: 80e9)
    decide = config.cache_lde_trace
    assert decide(1 << 22, "cuda") is config.CacheDecision.CACHE
    assert decide(1 << 23, "cuda") is config.CacheDecision.JIT


def test_free_memory_counts_the_allocators_unused_blocks(monkeypatch):
    """mem_get_info sees the caching allocator's reserved blocks as taken;
    what it holds unused is free for the next proof."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (30 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 45 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 5 << 30)
    assert config._device_memory_bytes("cuda") == 70 << 30
    # a 2^23-row LDT domain (44.8 GB) is JIT at 70 GB free, and a 2^22
    # one (22.4 GB) is CACHE, where mem_get_info alone would say JIT
    decide = config.cache_lde_trace
    assert decide(1 << 22, "cuda") is config.CacheDecision.CACHE
    assert decide(1 << 23, "cuda") is config.CacheDecision.JIT


@pytest.fixture
def forced_jit():
    config.overwrite_lde_trace_caching_to(config.CacheDecision.JIT)
    try:
        yield
    finally:
        config.overwrite_lde_trace_caching_to(None)


@pytest.mark.parametrize("ldt_choice, digest", [
    ("fri", PINNED_FIB10_DIGEST), ("stir", JAX_STIR_FIB10_DIGEST)])
def test_forced_jit_fib10_hashes_to_jax_digest(forced_jit, ldt_choice,
                                               digest):
    stark = tvm.Stark(ldt_choice=ldt_choice, device="cpu")
    program = ex.fibonacci()
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([10]))
    claim = tvm.Claim.about_program(program).with_input([10]) \
        .with_output(output)
    proof = stark.prove(claim, aet, seed=SEED)
    w = proof.words
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) == digest
    assert stark.verify(claim, proof)
