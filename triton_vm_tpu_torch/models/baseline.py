"""BASELINE.md's benchmark configs on the port, under the names of the JAX
package's `bench.py` (its config table, bench.py:136-163, and its two
fixtures, bench.py:75-121), with the same programs, public inputs and
divined digests (tests/test_torch_baseline_configs.py).

    program, public_input, non_determinism = config("hash_chain")
    stark, claim, proof = prove_program(program, public_input,
                                        non_determinism)

`PADDED_HEIGHTS` gives the padded height each config's trace really has:
bench.py's name `factorial_4096` pads to 2^13, not 2^12.
"""

from __future__ import annotations

import numpy as np

from ..crypto import tip5
from ..fields.bfe import P
from ..stark.proof_stream import Claim
from ..stark.prover import Stark
from ..vm.machine import VM, NonDeterminism, PublicInput
from . import example_programs as ex
from . import recursive_verifier as rv

SEED = bytes(range(32))

# bench.py's names, each with its trace's padded height
PADDED_HEIGHTS = {
    "fib_1024": 1 << 10,        # config 1: fibonacci input 85
    "factorial_4096": 1 << 13,  # factorial input 500: 5,510 processor rows
    "spin_65536": 1 << 16,      # config 2: spin(16)
    "hash_chain": 1 << 14,      # config 3: hash_chain input 200
    "merkle_auth": 1 << 10,     # config 4: a height-10 tree
    "recursive_verifier": 1 << 17,  # config 5: one revealed index
}


def padded_height(name: str) -> int:
    """The padded height of `config(name)`'s trace (spin_<2^k>: 2^k)."""
    if name.startswith("spin_") and name not in PADDED_HEIGHTS:
        return 1 << _spin_log2(name)
    return PADDED_HEIGHTS[name]


def _spin_log2(name):
    # bench.py: TVM_BENCH=spin_<2^k> proves spin(k)
    return int(name.split("_")[1]).bit_length() - 1


def merkle_auth_fixture(height: int):
    """BASELINE config 4 (bench.py:75-104): the authentication path of leaf
    5 in a Tip5 Merkle tree of 2^height random leaves (seeded), checked by
    `merkle_verify` with the sibling digests divined. Returns (program,
    public input, non-determinism)."""
    rng = np.random.default_rng(11)
    leaves = [tuple(int(x) for x in rng.integers(0, P, size=5,
                                                      dtype=np.uint64))
              for _ in range(1 << height)]
    layers = [leaves]
    while len(layers[-1]) > 1:
        prev = layers[-1]
        layers.append([tuple(tip5.hash_pair(prev[2 * i], prev[2 * i + 1]))
                       for i in range(len(prev) // 2)])
    root = layers[-1][0]

    leaf_index = 5
    digests = []
    idx = leaf_index
    for layer in layers[:-1]:
        digests.append(layer[idx ^ 1])
        idx //= 2
    inputs = ([height, leaf_index]
              + list(reversed(leaves[leaf_index])) + list(reversed(root)))
    return ex.merkle_verify(), inputs, NonDeterminism(digests=digests)


def recursive_verifier_inner(stark):
    """Config 5's inner claim and proof: fibonacci input 7 proven with
    `stark` and seed bytes(range(32)) (bench.py:114-118)."""
    program = ex.fibonacci()
    aet, output = VM.trace_execution(program, PublicInput([7]))
    claim = Claim.about_program(program).with_input([7]).with_output(output)
    return claim, stark.prove(claim, aet, seed=SEED)


def recursive_verifier_fixture(stark, num_queries: int = 1, inner=None):
    """BASELINE config 5 (bench.py:107-121): the verifier-core program
    (`recursive_verifier.build`) checking the inner proof, `inner` =
    (claim, proof) or `recursive_verifier_inner(stark)`'s, for
    `num_queries` revealed indices. Returns the built RecursiveVerifier;
    its `programs["combined"]` and `non_determinism` are the proven
    workload."""
    claim, proof = inner if inner is not None else \
        recursive_verifier_inner(stark)
    return rv.build(claim, proof, stark, num_queries=num_queries)


def config(name: str, device="cuda"):
    """(program, public input, non-determinism) of bench.py's config
    `name` (non-determinism None where the program divines nothing).
    `device` is used only by `recursive_verifier`, which proves its inner
    proof there."""
    if name.startswith("spin_"):
        program, iterations = ex.spin(_spin_log2(name))
        return program, [iterations], None
    if name == "fib_1024":
        # 85 loop iterations put the padded height at 2^10
        return ex.fibonacci(), [85], None
    if name == "factorial_4096":
        return ex.factorial(), [500], None
    if name == "hash_chain":
        return ex.hash_chain(), [200], None
    if name == "merkle_auth":
        return merkle_auth_fixture(height=10)
    if name == "recursive_verifier":
        built = recursive_verifier_fixture(Stark(device=device))
        return built.programs["combined"], [], built.non_determinism
    raise ValueError(f"unknown config {name!r}; choose from "
                     f"{sorted(PADDED_HEIGHTS)} or spin_<2^k>")
