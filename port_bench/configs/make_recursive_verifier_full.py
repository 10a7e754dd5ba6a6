"""Write the frozen inputs of the configuration recursive_verifier_full.

Run once on the CPU, from the root of the repo:

    python -m port_bench.configs.make_recursive_verifier_full

recursive_verifier_full is BASELINE config 5 uncut: the verifier core
(`models/recursive_verifier.build`) checking the inner proof (fibonacci
input 7, proven on the CPU with the default Stark and seed
bytes(range(32)), as for recursive_verifier) for all 173 of its revealed
indices (`models/baseline.recursive_verifier_fixture(..., num_queries=
173)`). The program halts only if every in-VM check passed, so a valid
proof of it is one full recursive verification. The inner proof and its
intermediate values reach the program as non-determinism (RAM and
digests), which grow with each query.

It writes recursive_verifier_full.tasm, recursive_verifier_full.nondet.json
and recursive_verifier_full.json (each file's SHA-256, the public input,
output and cycle count at the padded height the trace pads to, 2^21, and
the Stark parameters). On the CPU it proves only the small inner proof,
and traces the verifier's ~800k cycles in the port's VM.
"""

from __future__ import annotations

import json

from port_bench.configs.make_inputs import HERE, STARK, _program_files, \
    _write

NAME = "recursive_verifier_full"
REVEALED_INDICES = 173
LOG2_HEIGHT = 21


def _nondet_text(nd) -> str:
    return json.dumps({
        "individual_tokens": [int(x) for x in nd.individual_tokens],
        "digests": [[int(x) for x in d] for d in nd.digests],
        "ram": sorted([int(k), int(v)] for k, v in nd.ram.items())},
        separators=(",", ":"))


def recursive_verifier_full():
    from triton_vm_tpu_torch import VM, NonDeterminism, PublicInput, Stark
    from triton_vm_tpu_torch.models import baseline

    built = baseline.recursive_verifier_fixture(
        Stark(device="cpu"), num_queries=REVEALED_INDICES)
    program = built.programs["combined"]
    nd = built.non_determinism
    aet, output = VM.trace_execution(
        program, PublicInput([]),
        NonDeterminism(ram=dict(nd.ram), digests=list(nd.digests)))
    if aet.padded_height() != 1 << LOG2_HEIGHT:
        raise AssertionError(f"{NAME} pads to {aet.padded_height()}")
    if list(output):
        raise AssertionError(f"{NAME} writes output {list(output)}")
    nondet = _nondet_text(nd)
    if nondet == (HERE / "recursive_verifier.nondet.json").read_text():
        raise AssertionError("the non-determinism is recursive_verifier's")
    record = {"name": NAME,
              "source": "BASELINE.md config 5 with nothing cut: the "
                        "verifier core (models/recursive_verifier.build) "
                        "checking fibonacci(7)'s proof at all 173 revealed "
                        "indices, the query count of the stated Stark's FRI "
                        "(recursive_verifier.json's published block)",
              "revealed_indices": REVEALED_INDICES,
              "stands_for": "one card proving one full recursive "
                            "verification, with the stated Stark",
              "stark": STARK}
    record.update(_program_files(NAME, program))
    record["non_determinism"] = {"file": f"{NAME}.nondet.json",
                                 "sha256": _write(f"{NAME}.nondet.json",
                                                  nondet)}
    record["heights"] = {str(LOG2_HEIGHT): {
        "public_input": [], "output": [],
        "cycles": aet.height_of_table("processor")}}
    _write(f"{NAME}.json", json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    recursive_verifier_full()
    print("wrote", NAME, flush=True)
