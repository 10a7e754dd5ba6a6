"""The port's BASELINE configs (triton_vm_tpu_torch.models.baseline)
against the JAX package's bench.py.

`bench.main()` builds each config in a table of its own (bench.py:136-163)
and hands it to `VM.trace_execution`; here it runs under `TVM_BENCH=name`
up to that call, which is stopped, so the program, public input and
non-determinism compared are the ones bench.py would trace. The port's
table must give the same program text, the same public input and the same
divined digests and RAM. Both packages' VMs (the port's native core and
its Python interpreter, and the JAX package's) must give the same
execution trace, table heights and padded height at bench.py's inputs and
at the small inputs whose proofs the test_torch_baseline_proof_*.py files
compare. Those files import `prove_both` and the checks from here."""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import bench
import triton_vm_tpu
import triton_vm_tpu_torch as tvm
from triton_vm_tpu.models import example_programs as jex
from triton_vm_tpu.stark.proof_stream import Claim as JClaim
from triton_vm_tpu.stark.proof_stream import Proof as JProof
from triton_vm_tpu.stark.prover import Stark as JStark
from triton_vm_tpu.vm.machine import VM as JVM
from triton_vm_tpu.vm.machine import NonDeterminism as JNonDeterminism
from triton_vm_tpu.vm.machine import PublicInput as JPublicInput
from triton_vm_tpu_torch import interop
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.models import baseline
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.vm.aet import AlgebraicExecutionTrace
from triton_vm_tpu_torch.vm.machine import (VM, NonDeterminism, PublicInput,
                                            VMState)

torch.set_num_threads(2)

SEED = bytes(range(32))
# the JAX package's proof digest of fibonacci input 7 (config 5's inner
# proof), pinned in chip_smoke.py as JAX_FIB7_DIGEST with its command
JAX_FIB7_DIGEST = (16776481165773445315, 11632406580342972184,
                   4551248486225805797, 9432930646896196063,
                   16369719787940908687)
TABLES = ("processor", "op_stack", "ram", "jump_stack", "hash", "cascade",
          "lookup", "u32", "program")


@contextlib.contextmanager
def uint64_draws():
    """bench.py's `_merkle_auth_fixture` draws its leaves with
    `rng.integers(0, P, size=5)`, which numpy refuses: P does not fit the
    default dtype, int64. Inside this context `np.random.default_rng`'s
    `integers` draws uint64, the one integer dtype that holds [0, P), as
    the port's `merkle_auth_fixture` does."""
    make = np.random.default_rng

    class Rng:
        def __init__(self, seed):
            self._rng = make(seed)

        def integers(self, low, high, size=None):
            return self._rng.integers(low, high, size=size, dtype=np.uint64)

    np.random.default_rng = Rng
    try:
        yield
    finally:
        np.random.default_rng = make


def jax_merkle_auth(height):
    """bench.py's `_merkle_auth_fixture(height)`, its leaves drawn as
    uint64."""
    with uint64_draws():
        return bench._merkle_auth_fixture(height=height)


class _Traced(Exception):
    """bench.main() stopped at VM.trace_execution, with its arguments."""


def bench_config(name, monkeypatch):
    """(program, public input, non-determinism) that bench.py's main()
    passes to VM.trace_execution under TVM_BENCH=name."""
    trace = triton_vm_tpu.VM.trace_execution

    def stop(program, public_input=None, non_determinism=None):
        if sys._getframe(1).f_code is not bench.main.__code__:
            # a fixture's own trace (config 5's inner proof)
            return trace(program, public_input, non_determinism)
        raise _Traced(program, list(public_input.individual_tokens),
                      non_determinism)

    monkeypatch.setenv("TVM_BENCH", name)
    # main() sets TVM_JAX_CACHE if unset; setenv restores it afterwards
    monkeypatch.setenv("TVM_JAX_CACHE", os.environ.get("TVM_JAX_CACHE", "1"))
    monkeypatch.setattr(triton_vm_tpu.VM, "trace_execution",
                        staticmethod(stop))
    # the watchdog main() starts returns silently once the run is final
    monkeypatch.setitem(bench._STATE, "final", True)
    with pytest.raises(_Traced) as stopped:
        if name == "merkle_auth":
            with uint64_draws():
                bench.main()
        else:
            bench.main()
    return stopped.value.args


def _same_config(got, want):
    (program, public_input, nd), (jprogram, jpublic_input, jnd) = got, want
    assert str(program) == str(jprogram)
    assert program.to_bwords() == [int(w) for w in jprogram.to_bwords()]
    assert tuple(program.hash()) == tuple(int(w) for w in jprogram.hash())
    assert list(public_input) == [int(x) for x in jpublic_input]
    if jnd is None:
        assert nd is None
        return
    assert list(nd.individual_tokens) == [int(x)
                                          for x in jnd.individual_tokens]
    assert [tuple(d) for d in nd.digests] == \
        [tuple(int(x) for x in d) for d in jnd.digests]
    assert dict(nd.ram) == {int(k): int(v) for k, v in jnd.ram.items()}


@pytest.mark.parametrize("name", ["fib_1024", "factorial_4096", "spin_65536",
                                  "spin_32768", "spin_1048576", "hash_chain",
                                  "merkle_auth"])
def test_config_equals_bench(name, monkeypatch):
    _same_config(baseline.config(name), bench_config(name, monkeypatch))


def test_unknown_config_raises():
    with pytest.raises(ValueError):
        baseline.config("fib_2048")


@pytest.fixture(scope="module")
def rv_inner():
    return baseline.recursive_verifier_inner(tvm.Stark(device="cpu"))


def test_recursive_verifier_inner_digest_equals_jax(rv_inner):
    _, proof = rv_inner
    w = proof.words
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) \
        == JAX_FIB7_DIGEST


def test_recursive_verifier_config_equals_bench(rv_inner, monkeypatch):
    """Config 5: the port proves the inner proof once; bench.py's fixture
    is handed the same words in place of its own JAX proof (the digest
    test above shows the two are equal) and builds the verifier core with
    the JAX package's `recursive_verifier.build`."""
    claim, proof = rv_inner
    monkeypatch.setattr(baseline, "recursive_verifier_inner",
                        lambda stark: rv_inner)
    got = baseline.config("recursive_verifier", device="cpu")

    def jax_prove(self, jclaim, aet, seed=None):
        assert jclaim.encode() == claim.encode() and seed == SEED
        return JProof(list(proof.words))

    monkeypatch.setattr(JStark, "prove", jax_prove)
    _same_config(got, bench_config("recursive_verifier", monkeypatch))
    program, public_input, nd = got
    aet, _ = VM.trace_execution(program, PublicInput(public_input), nd)
    assert aet.padded_height() == baseline.padded_height("recursive_verifier")


def test_bench_merkle_auth_fixture_draw_overflows_int64():
    """Why `uint64_draws` exists: bench.py's fixture as written raises."""
    with pytest.raises(ValueError, match="out of bounds for int64"):
        bench._merkle_auth_fixture(height=3)


@pytest.mark.parametrize("height", [3, 10])
def test_merkle_auth_fixture_equals_bench(height):
    _same_config(baseline.merkle_auth_fixture(height),
                 jax_merkle_auth(height))


def test_merkle_auth_divined_path_leads_to_the_root():
    """The divined siblings hash leaf 5 up to the root in the public input
    (merkle_verify's public input reads each digest in reversed order)."""
    _, public_input, nd = baseline.merkle_auth_fixture(10)
    height, index = public_input[:2]
    node = tuple(reversed(public_input[2:7]))
    for sibling in nd.digests:
        pair = (sibling, node) if index & 1 else (node, sibling)
        node = tuple(tip5.hash_pair(*pair))
        index //= 2
    assert len(nd.digests) == height == 10
    assert node == tuple(reversed(public_input[7:12]))


# ------------------------------------------------------------ the traces

def _python_trace(program, public_input, non_determinism):
    """The port's Python interpreter, without the native core."""
    state = VMState(program, public_input, non_determinism)
    aet = AlgebraicExecutionTrace(program)
    while not state.halting:
        aet.record_state(state)
        for call in state.step():
            aet.record_co_processor_call(call)
    return aet, state.public_output


def _record(aet, output):
    """An execution trace as plain values, dicts in insertion order."""
    rows = {name: np.asarray(getattr(aet, name), np.uint64).reshape(-1, 67)
            .tolist() for name in ("program_hash_rows", "hash_rows",
                                   "sponge_rows")}
    return dict(
        output=[int(x) for x in output],
        instruction_multiplicities=[int(x)
                                    for x in aet.instruction_multiplicities],
        processor_rows=np.asarray(aet.processor_rows, np.uint64).tolist(),
        op_stack_rows=[tuple(int(v) for v in r) for r in aet.op_stack_rows],
        ram_rows=[tuple(int(v) for v in r) for r in aet.ram_rows],
        u32_entries=[(k, int(v)) for k, v in aet.u32_entries.items()],
        cascade=[(int(k), int(v))
                 for k, v in aet.cascade_multiplicities.items()],
        lookup=[int(x) for x in aet.lookup_multiplicities],
        heights={t: aet.height_of_table(t) for t in TABLES},
        padded_height=aet.padded_height(), **rows)


def _jax_trace(name, public_input):
    if name == "merkle_auth":
        program, public_input, nd = jax_merkle_auth(public_input)
        return JVM.trace_execution(program, JPublicInput(public_input), nd)
    program = {"fib_1024": jex.fibonacci, "factorial_4096": jex.factorial,
               "hash_chain": jex.hash_chain}[name]()
    return JVM.trace_execution(program, JPublicInput(public_input),
                               JNonDeterminism())


def _port_config(name, public_input):
    if name == "merkle_auth":
        return baseline.merkle_auth_fixture(public_input)
    program = baseline.config(name)[0]
    return program, public_input, NonDeterminism()


# (config, input: public input, or the tree height of merkle_auth,
# padded height): bench.py's inputs, then the small proofs' inputs
TRACES = [("fib_1024", [85], 1 << 10), ("factorial_4096", [500], 1 << 13),
          ("hash_chain", [200], 1 << 14), ("merkle_auth", 10, 1 << 10),
          ("hash_chain", [1], 1 << 9), ("hash_chain", [10], 1 << 11),
          ("merkle_auth", 3, 1 << 9), ("factorial_4096", [10], 1 << 8)]


@pytest.mark.parametrize("name,public_input,padded_height", TRACES)
def test_traces_equal_jax_vm(name, public_input, padded_height):
    """The port's native core and its Python interpreter (merkle_step with
    divined digests: `_op_merkle_step`) against the JAX VM: the whole
    execution trace, so the table heights and the padded height too."""
    want = _record(*_jax_trace(name, public_input))
    program, inputs, nd = _port_config(name, public_input)
    native = _record(*VM.trace_execution(program, PublicInput(inputs), nd))
    python = _record(*_python_trace(program, PublicInput(inputs), nd))
    assert want["padded_height"] == padded_height
    for key in want:
        assert native[key] == want[key], key
        assert python[key] == want[key], key


@pytest.mark.parametrize("name", ["fib_1024", "factorial_4096",
                                  "spin_65536", "spin_32768", "hash_chain",
                                  "merkle_auth"])
def test_padded_heights_of_the_table(name):
    """Each config's stated padded height is its trace's (config 5's in
    test_recursive_verifier_config_equals_bench)."""
    program, public_input, nd = baseline.config(name)
    aet, _ = VM.trace_execution(program, PublicInput(public_input), nd)
    assert aet.padded_height() == baseline.padded_height(name)


def test_spin_65536_heights_equal_jax_vm():
    program, public_input, _ = baseline.config("spin_65536")
    aet, _ = VM.trace_execution(program, PublicInput(public_input))
    jprogram, jiterations = jex.spin(16)
    jaet, _ = JVM.trace_execution(jprogram, JPublicInput([jiterations]))
    assert {t: aet.height_of_table(t) for t in TABLES} == \
        {t: jaet.height_of_table(t) for t in TABLES}
    assert aet.padded_height() == jaet.padded_height() == 1 << 16


# ------------------------------------------- proofs, for the proof files

def prove_both(port, jax):
    """Each package proves its own trace of one claim with Stark() and seed
    SEED on the CPU. `port` and `jax` are (program, public input,
    non-determinism). Returns (JAX claim, JAX proof, port claim, port
    proof)."""
    program, public_input, nd = jax
    aet, output = JVM.trace_execution(program, JPublicInput(public_input),
                                      nd or JNonDeterminism())
    jclaim = (JClaim.about_program(program).with_input(public_input)
              .with_output(output))
    jproof = JStark().prove(jclaim, aet, seed=SEED)
    _, claim, proof = tvm.prove_program(*port, seed=SEED, device="cpu")
    return jclaim, jproof, claim, proof


def check_proofs_equal(proofs, padded_height):
    jclaim, jproof, claim, proof = proofs
    assert claim.encode() == jclaim.encode()
    assert proof.padded_height() == padded_height
    assert proof.words == [int(w) for w in jproof.words]


def check_cross_verification(proofs):
    """The JAX verifier accepts the port's proof, the port's verifier
    accepts the JAX package's and rejects it with one word changed."""
    jclaim, jproof, _, proof = proofs
    assert JStark().verify(jclaim, JProof(list(proof.words)))
    claim = interop.claim_from_fields(jclaim.program_digest, jclaim.input,
                                      jclaim.output)
    stark = tvm.Stark(device="cpu")
    assert stark.verify(claim, interop.proof_from_words(jproof.words))
    words = [int(w) for w in jproof.words]
    words[len(words) // 2] ^= 1
    assert not tvm.verify(stark, claim, interop.proof_from_words(words))


def small_configs(name):
    """(port, JAX) configs of the small proofs: hash_chain input 1 (2^9),
    merkle_auth of a height-3 tree (2^9), factorial input 10 (2^8)."""
    if name == "merkle_auth":
        return baseline.merkle_auth_fixture(3), jax_merkle_auth(3)
    public_input = {"hash_chain": [1], "factorial": [10]}[name]
    return ((getattr(ex, name)(), public_input, None),
            (getattr(jex, name)(), public_input, None))
