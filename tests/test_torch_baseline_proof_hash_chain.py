"""BASELINE config 3, the Tip5 hash chain, proven by both packages on the
CPU at its smallest size: hash_chain input 1 (padded height 2^9), with
Stark() and seed bytes(range(32)). The proof words are equal, and each
package's verifier accepts the other's proof and the port's rejects the
JAX package's with a word changed (tests/test_torch_baseline_configs.py
holds the configs and the traces)."""

import pytest

from tests.test_torch_baseline_configs import (check_cross_verification,
                                               check_proofs_equal,
                                               prove_both, small_configs)


@pytest.fixture(scope="module")
def proofs():
    return prove_both(*small_configs("hash_chain"))


def test_proof_words_equal_jax(proofs):
    check_proofs_equal(proofs, 1 << 9)


def test_each_verifier_accepts_the_others_proof(proofs):
    check_cross_verification(proofs)
