"""The port's slice as a whole on the CPU: `prove_program` -> `Stark.prove`
-> `Stark.verify` of triton_vm_tpu_torch. The fib(10) proof hashes to the
digest pinned for the JAX package (tests/test_stark_e2e.py), the verifier
rejects tampered claims and proofs, entry points refuse a missing card
rather than move to the CPU, a forced JIT LDE proves and verifies, and
the package imports nothing of JAX.
Word-for-word equality with the JAX package's proof and cross-package
verification are in test_torch_stark_interop.py."""

import subprocess
import sys

import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu_torch import config
from triton_vm_tpu_torch.crypto import tip5
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.models import example_programs as ex

torch.set_num_threads(2)

SEED = bytes(range(32))
PINNED_FIB10_DIGEST = (
    7024632114429628424,
    11029959989076809184,
    8246888127736946106,
    15137373578292407606,
    15772038778546270844,
)


@pytest.fixture(scope="module")
def fib10():
    return tvm.prove_program(ex.fibonacci(), [10], seed=SEED, device="cpu")


def test_fib10_proof_hashes_to_pinned_digest(fib10):
    _, _, proof = fib10
    w = proof.words
    assert tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w)) == \
        PINNED_FIB10_DIGEST


def test_verify_accepts_proof_and_its_word_list(fib10):
    stark, claim, proof = fib10
    assert stark.verify(claim, proof)
    reloaded = tvm.Proof(list(proof.words))
    assert reloaded.padded_height() == 512
    assert tvm.verify(stark, claim, reloaded)


def test_tampered_claim_is_rejected(fib10):
    stark, claim, proof = fib10
    bad_claim = tvm.Claim(claim.program_digest, list(claim.input),
                          [(claim.output[0] + 1) % P])
    with pytest.raises(tvm.VerificationError):
        stark.verify(bad_claim, proof)


def test_tampered_proof_word_is_rejected(fib10):
    stark, claim, proof = fib10
    bad = list(proof.words)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % P
    with pytest.raises(Exception):
        stark.verify(claim, tvm.Proof(bad))
    assert not tvm.verify(stark, claim, tvm.Proof(bad))


def test_entry_points_default_to_cuda_and_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvm.prove_program(ex.fibonacci(), [10], seed=SEED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvm.Stark()


def test_stir_and_jit_paths_prove_instead_of_raising():
    from triton_vm_tpu_torch.ldt.stir import Stir

    assert isinstance(tvm.Stark(device="cpu").ldt(1 << 16), Stir)
    assert isinstance(tvm.Stark(ldt_choice="stir", device="cpu").ldt(256),
                      Stir)
    config.overwrite_lde_trace_caching_to(config.CacheDecision.JIT)
    try:
        stark, claim, proof = tvm.prove_program(ex.fibonacci(), [3],
                                                seed=SEED, device="cpu")
    finally:
        config.overwrite_lde_trace_caching_to(None)
    assert stark.verify(claim, proof)


def test_package_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import triton_vm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton_vm_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("[]")
