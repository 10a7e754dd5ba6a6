"""Card-only checks of the port: each CUDA kernel against its plain torch
version on the card, the device witness, the JIT LDE and a STIR
transcript on the card against the same computation on the CPU, and the
fib(10) proof on the card against the digest pinned for the JAX package.
Every test is marked `cuda` and skips without a card. This file imports
nothing of JAX, so on a machine without it run
`python -m pytest --noconftest tests/test_torch_cuda.py -q`."""

import numpy as np
import pytest
import torch

from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.ops import gf, gfx, tip5_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def test_permutation_kernel_matches_plain(cuda):
    for b in (1, 1000, (1 << 16) + 3):
        s = _field(b, (16, b))
        s[:, 0] = [0, 1, P - 1, 2**32, 2**63, P - 2**32, 2**32 - 1, P - 2,
                   0, 0, 1, 1, P - 1, P - 1, 2**63 - 1, 5]
        s = gf.from_u64(s, cuda)
        assert torch.equal(tip5_cuda.permutation(s),
                           tip5_cuda.permutation_plain(s))


def test_sponge_kernel_matches_plain(cuda):
    for n in (0, 15, 273, 379):
        rows = gf.from_u64(_field(n, (777, n)), cuda)
        assert torch.equal(tip5_cuda.sponge_absorb_rows(rows),
                           tip5_cuda.sponge_absorb_rows_plain(rows))
    view = gf.from_u64(_field(1, (379, 4097)), cuda).T[::2]
    assert torch.equal(tip5_cuda.sponge_absorb_rows(view),
                       tip5_cuda.sponge_absorb_rows_plain(view))


def test_permutation_kernel_matches_plain_at_worst_cases(cuda):
    """The states at which tests/test_torch_mds.py holds the plain version
    against the JAX package: the MDS's largest halves."""
    cols = [[P - 1] * 16, [2**32 - 1] * 16, [0, P - 1] * 8, [P - 1, 0] * 8,
            [0, 2**32 - 1] * 8]
    s = gf.from_u64(np.array(cols, np.uint64).T.copy(), cuda)
    assert torch.equal(tip5_cuda.permutation(s),
                       tip5_cuda.permutation_plain(s))


def test_sponge_kernel_matches_plain_at_main_table_width(cuda):
    """The main table of a 2^15 proof: 2^18 rows of 379 elements, read
    column-major as the commit stage reads its LDE."""
    rows = gf.from_u64(_field(379, (379, 1 << 18)), cuda).T
    assert rows.stride() == (1, 1 << 18)
    assert torch.equal(tip5_cuda.sponge_absorb_rows(rows),
                       tip5_cuda.sponge_absorb_rows_plain(rows))


def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        tip5_cuda.permutation(torch.zeros((16, 8), dtype=torch.int64,
                                          device=cuda).T.contiguous().T)
    with pytest.raises(TypeError, match="int64"):
        tip5_cuda.sponge_absorb_rows(torch.zeros((4, 3), device=cuda))


def test_fib10_proof_on_the_card_hashes_to_pinned_digest(cuda):
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.models import example_programs as ex

    tip5_cuda.reset_launch_counts()
    stark, claim, proof = tvm.prove_program(ex.fibonacci(), [10],
                                            seed=bytes(range(32)))
    w = proof.words
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) == (
        7024632114429628424, 11029959989076809184, 8246888127736946106,
        15137373578292407606, 15772038778546270844)
    assert all(n > 0 for n in tip5_cuda.launches.values())
    assert tvm.verify(stark, claim, proof)


def test_witness_on_the_card_equals_cpu(cuda):
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.tables import extend_device as ed
    from triton_vm_tpu_torch.tables import master as mt
    from triton_vm_tpu_torch.vm.machine import VM, PublicInput

    aet, _ = VM.trace_execution(ex.u32_mix(), PublicInput([50]))
    main_air = mt.fill_main_table(aet, device="cuda")
    challenges = [tuple(int(c) for c in row) for row in _field(63, (63, 3))]
    randomizer = _field(5, (main_air.shape[0], 3))
    out = {}
    for dev in ("cpu", cuda):
        main = ed.main_witness_dev(main_air, dev)
        out[str(dev)] = (gf.to_u64(main), gf.to_u64(
            ed.aux_witness_dev(main, challenges,
                               gfx.from_u64(randomizer, dev))))
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(got, want)


def test_jit_lde_on_the_card_equals_cpu(cuda):
    """The JIT commit's digests (K2 on each coset, read in place) and the
    JIT quotient codeword, at the domains of padded height 2^8 with full
    tables of random words, on the card and on the CPU."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.air.challenges import SAMPLE_COUNT, Challenges
    from triton_vm_tpu_torch.air.master import master_air
    from triton_vm_tpu_torch.stark import jit_lde, prover

    _, ntr, trace_dom, rand_dom, quot_dom, ldt_dom = tvm.Stark(
        device="cpu").derive_domains(256)
    h, n = trace_dom.length, rand_dom.length
    eval_dom = ldt_dom if ldt_dom.length >= quot_dom.length else quot_dom
    claim = tvm.Claim([1, 2, 3, 4, 5], [10], [55])
    challenges = Challenges([tuple(int(c) for c in row)
                             for row in _field(4, (SAMPLE_COUNT, 3))], claim)
    weights = prover._powers_xfe(
        (3, 1, 4), sum(len(cs) for cs in master_air().constraints.values()))
    out = {}
    for dev in ("cpu", cuda):
        main = jit_lde.committed_coefficients(
            gf.from_u64(_field(1, (prover.NUM_MAIN, h)), dev),
            gf.from_u64(_field(2, (prover.NUM_MAIN, ntr)), dev), trace_dom,
            n)
        aux = jit_lde.committed_coefficients(
            gf.from_u64(_field(3, (prover.NUM_AUX, 3, h)), dev),
            gf.from_u64(_field(5, (prover.NUM_AUX, 3, ntr)), dev),
            trace_dom, n)
        out[str(dev)] = [gf.to_u64(x) for x in (
            jit_lde.committed_digests_bfe(main, eval_dom, ldt_dom.length),
            jit_lde.committed_digests_xfe(aux, eval_dom, ldt_dom.length),
            jit_lde.quotient_codeword_jit(main, aux, trace_dom, quot_dom,
                                          challenges, weights))]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(got, want)


def test_stir_transcript_on_the_card_equals_cpu(cuda):
    """Two full STIR rounds: K2 on leaf rows of 12, K1 trees, the batched
    point evaluation at the out-of-domain samples, the transforms onto the
    folded domain for the queried points and the interpolant, the
    quotient's transform of three rows and the NTT re-evaluation, all on
    the card."""
    from triton_vm_tpu_torch.ldt.stir import Stir, StirParameters
    from triton_vm_tpu_torch.ops import ntt
    from triton_vm_tpu_torch.stark.proof_stream import ProofStream

    stir = Stir(StirParameters(security_level=20, log2_folding_factor=2,
                               log2_initial_expansion_factor=2,
                               log2_high_degree_bound=11))
    assert len(stir.round_queries) == 2
    coeffs = np.zeros((stir.domain.length, 3), np.uint64)
    coeffs[:stir.params.max_degree() + 1] = _field(
        21, (stir.params.max_degree() + 1, 3))
    words = {}
    for dev in ("cpu", cuda):
        cw = ntt.ntt(gfx.from_u64(coeffs, dev), stir.domain.offset)
        ps = ProofStream()
        indices = stir.prove(cw, ps)
        words[str(dev)] = (indices, ps.to_proof().words)
    assert words["cuda"] == words["cpu"]
    indices, _ = stir.verify(ProofStream.decode(words["cuda"][1]), cuda)
    assert indices == words["cuda"][0]


def test_bezout_on_the_card_equals_cpu(cuda):
    """The RAM table's Bezout coefficients (ops/poly.py) on the card equal
    the CPU's and, at a small size, the O(N^2) plain version's."""
    from triton_vm_tpu_torch.tables import master as mt

    rng = np.random.default_rng(6)
    for n in (1, 5, 300, 5000):
        roots = sorted({int(x) for x in rng.integers(1 << 40, 1 << 50,
                                                      size=n)})
        got = mt.bezout_coefficient_polynomials_coefficients(roots, cuda)
        assert got == mt.bezout_coefficient_polynomials_coefficients(
            roots, "cpu")
        if n <= 300:
            assert got == mt._bezout_plain(roots)


def test_low_security_testable_program_on_the_card(cuda):
    """`TestableProgram` proves and verifies on the card by default, and
    its low-security proof hashes to the JAX package's digest that
    tests/test_torch_testing.py pins."""
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.testing import TestableProgram

    tp = TestableProgram(ex.fibonacci()).with_input([7])
    w = tp.prove_and_verify(seed=bytes(range(32))).words
    assert tp.stark.device.type == "cuda"
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) == (
        5451660588470763885, 7307061866663976276, 14817866948123220096,
        49005092894082727, 15240332116246682258)


@pytest.mark.parametrize("ldt", ["fri", "stir"])
def test_mesh_proof_on_the_card_equals_cpu(cuda, monkeypatch, ldt):
    """TVM_MESH=4 on the card (several shards share a card where fewer are
    visible): the small proof of tests/test_torch_mesh_prover.py equals
    the CPU mesh proof; with STIR, TVM_INTRA_NTT_MIN=64 sends its initial
    iNTT through the six-step transform."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.ops import ntt_sharded

    monkeypatch.setenv("TVM_MESH", "4")
    monkeypatch.setenv("TVM_INTRA_NTT_MIN", "64")
    program = tvm.triton_program(
        "push 3 call cnt halt\n"
        "cnt: dup 0 push 0 eq skiz return addi -1 recurse")
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([]))
    claim = tvm.Claim.about_program(program).with_output(list(output))
    proofs = {}
    for dev in ("cpu", cuda):
        stark = tvm.Stark(32, 2, ldt_choice=None if ldt == "fri" else ldt,
                          device=dev)
        tip5_cuda.reset_launch_counts()
        ntt_sharded.reset_launch_counts()
        proofs[str(dev)] = stark.prove(claim, aet, seed=bytes(range(32)))
    assert proofs["cuda"].words == proofs["cpu"].words
    assert all(n > 0 for n in tip5_cuda.launches.values())
    assert set(tip5_cuda.launches_by_device) == {"cuda:0"} or \
        torch.cuda.device_count() > 1
    assert (ntt_sharded.launches["ntt_sharded"] > 0) == (ldt == "stir")
    assert stark.verify(claim, proofs["cuda"])


@pytest.mark.parametrize("case", ["random", "ragged", "edge values",
                                  "permuted aux", "halo"])
def test_quotient_kernel_matches_plain(cuda, case):
    """K3 (csrc/quotient.cu) at the full widths (379 main, 91 aux
    columns) against its plain version, word for word."""
    from triton_vm_tpu_torch.tools import quotient_inputs as qi

    rng = np.random.default_rng(12)
    n = (1 << 12) + (3 if case == "ragged" else 0)
    inp = qi.make_inputs(rng, n, cuda, edge=case == "edge values",
                         permuted_aux=case == "permuted aux",
                         halo=8 if case == "halo" else 0)
    assert torch.equal(qi.k3(inp), qi.plain(inp))


def test_quotient_kernel_refuses_what_it_cannot_take(cuda):
    from triton_vm_tpu_torch.tools import quotient_inputs as qi

    inp = qi.make_inputs(np.random.default_rng(13), 64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qi.k3(dict(inp, ws=inp["ws"].T.contiguous().T))
    with pytest.raises(TypeError, match="int64"):
        qi.k3(dict(inp, main=inp["main"].to(torch.int32)))
    with pytest.raises(ValueError, match="do not match"):
        qi.k3(dict(inp, aux=inp["aux"][:, :, :32]))
    with pytest.raises(ValueError, match="main columns"):
        qi.k3(dict(inp, main=inp["main"][:100]))
    with pytest.raises(ValueError, match="power of two"):
        qi.k3(dict(inp, trace_len=6))


@pytest.mark.parametrize("rows,n_in,length,inverse", [
    (4096, 16, 32, False), (1001, 1 << 12, 1 << 12, False),
    (379, 1 << 13, 1 << 14, False), (3, 1 << 20, 1 << 20, True),
    (15, 1 << 22, 1 << 22, False)])
def test_ntt_kernel_matches_plain(cuda, rows, n_in, length, inverse):
    """K4 (csrc/ntt.cu) against its plain version, word for word: short
    zero-padded batches, one pass, two passes, an iNTT with its scale, a
    coset offset on the load."""
    from triton_vm_tpu_torch.fields import bfe
    from triton_vm_tpu_torch.ops import ntt, ntt_cuda

    x = gf.from_u64(_field(rows, (rows, n_in)), cuda)
    if inverse:
        root = bfe.inv(bfe.primitive_root_of_unity(length))
        pre, post = None, ntt._unscale(length, 7)
    else:
        root = bfe.primitive_root_of_unity(length)
        pre, post = ntt._coset_scale(7), None
    assert torch.equal(ntt_cuda.ntt_rows(x, root, length, pre, post),
                       ntt._rows_plain(x, root, length, pre, post))


def test_ntt_on_the_card_equals_cpu(cuda):
    """ntt, intt, lde and a zero-padded ntt of an XFE batch (2, 3, 2^13):
    K4 on the card, the plain version on the CPU."""
    from triton_vm_tpu_torch.ops import ntt

    a = _field(9, (2, 3, 1 << 13))
    for fn, args in ((ntt.ntt, (7,)), (ntt.intt, (7,)),
                     (ntt.lde, (4, 1, 7)), (ntt.ntt, (7, 1 << 14))):
        assert torch.equal(fn(gf.from_u64(a, cuda), *args).cpu(),
                           fn(gf.from_u64(a), *args))


def test_ntt_kernel_refuses_what_it_cannot_take(cuda):
    from triton_vm_tpu_torch.fields import bfe
    from triton_vm_tpu_torch.ops import ntt_cuda

    root = bfe.primitive_root_of_unity(64)
    x = torch.zeros((4, 64), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_rows(torch.zeros((64, 4), dtype=torch.int64,
                                      device=cuda).T, root, 64)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda.ntt_rows(x, root, 96)
    with pytest.raises(ValueError, match="overlaps"):
        ntt_cuda.ntt_rows(x, root, 64, out=x)


def _merkle_openings(device):
    """Openings of trees of 2^0 to 2^12 leaves (one leaf, adjacent
    siblings, repeated indices whose earlier copy is wrong, every leaf),
    each as given and with a leaf word, an authentication word or a root
    word changed: [(root, n, indices, digests, authentication nodes)]."""
    from triton_vm_tpu_torch.crypto import merkle

    out = []
    for log2_n in range(13):
        n = 1 << log2_n
        rng = np.random.default_rng(log2_n)
        leaves = _field(100 + log2_n, (n, 5))
        tree = merkle.MerkleTree(leaves, device)
        kinds = [[int(rng.integers(0, n))],
                 [n - 1 - (n > 1), n - 1] + [int(i) for i in
                                             rng.integers(0, n, 5)],
                 [int(i) for i in rng.integers(0, n, 9)],
                 [int(i) for i in rng.permutation(min(n, 256))]]
        for j, idx in enumerate(kinds):
            digests = [tuple(int(x) for x in leaves[i]) for i in idx]
            if j == 2:
                idx = idx + idx[:2]
                digests = [(1, 2, 3, 4, 5)] * 2 + digests[2:] + digests[:2]
            auth = tree.authentication_structure(idx)
            root = tree.root()
            out.append((root, n, idx, digests, auth))
            for tamper in range(3):
                d, a, r = list(digests), list(auth), root
                if tamper == 0:
                    d[-1] = (d[-1][0] ^ 1,) + d[-1][1:]
                elif tamper == 1 and a:
                    a[-1] = a[-1][:4] + ((a[-1][4] + 1) % P,)
                else:
                    r = (r[0], (r[1] + 1) % P) + r[2:]
                out.append((r, n, idx, d, a))
    return out


def test_merkle_path_checks_on_the_card_equal_cpu(cuda):
    """`verify_authentication_structures` on the card (one node buffer,
    K1 a step, one read of the roots) gives the CPU's verdicts (the
    native scalar Tip5) on every opening: as one batch, tree by tree, and
    with the leaf digests handed over as card tensors."""
    from triton_vm_tpu_torch.crypto import merkle

    corpus = _merkle_openings(cuda)
    want = merkle.verify_authentication_structures(corpus, "cpu")
    assert True in want and False in want
    assert merkle.verify_authentication_structures(corpus, cuda) == want
    on_card = [(r, n, i, gf.from_u64(np.asarray(d, np.uint64).T, cuda), a)
               for r, n, i, d, a in corpus]
    assert merkle.verify_authentication_structures(on_card, "cpu") == want
    assert [merkle.verify_authentication_structure(*o) for o in on_card] \
        == want


@pytest.mark.parametrize("log2_height", [16, 15])
def test_spin_verify_reads_once_a_tree(cuda, log2_height):
    """A profiled verify of a spin proof on the card (STIR at 2^16, FRI at
    2^15): every tree is rebuilt with one read of its root, so the
    `merkle` span reads three times (main, aux, quotient), each of STIR's
    inclusion proofs once and FRI's LDT once (its rounds and last
    codeword as one batch), as the leaf digests' reads did before; the
    parents hashed are counted (`merkle hashed nodes`)."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.crypto import merkle
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.utils import profiler

    program, iterations = ex.spin(log2_height)
    stark, claim, proof = tvm.prove_program(program, [iterations],
                                            seed=bytes(range(32)))
    profiler.start("verify")
    try:
        assert tvm.verify(stark, claim, proof)
    finally:
        profile = profiler.finish()
    reads, hashed = {}, {}
    for iv in profile.intervals():
        reads.setdefault(iv.path, []).append(
            iv.counts.get(profiler.DEVICE_READS, 0))
        hashed[iv.path] = hashed.get(iv.path, 0) + iv.counts.get(
            merkle.HASHED_NODES, 0)
    assert reads[("verify", "merkle")] == [3]
    assert hashed[("verify", "merkle")] > 0
    stir_path = ("verify", "LDT", "STIR verify inclusion proofs")
    if log2_height == 16:
        assert reads[stir_path] and set(reads[stir_path]) == {1}
        assert hashed[stir_path] > 0
    else:
        assert stir_path not in reads
        assert reads[("verify", "LDT")] == [1]
        assert hashed[("verify", "LDT")] > 0
