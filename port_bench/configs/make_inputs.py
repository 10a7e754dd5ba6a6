"""Write the frozen inputs of the benchmark's configurations.

Run once on the CPU, from the root of the repo:

    python -m port_bench.configs.make_inputs [spin] [recursive_verifier]

spin: the upstream benchmark generator ProgramToBench::spin
(triton-dev-util/src/lib.rs:52-60; the port's
`models/example_programs.spin`): the fibonacci loop, its iteration count
the public input, sized so the padded height is 2^k. Its output has a
plain model, reference/programs.py's `fibonacci`.

recursive_verifier: BASELINE config 5, the verifier core checking an
inner proof (fibonacci input 7, proven on the CPU with the default Stark
and seed bytes(range(32))) for one revealed index
(`models/baseline.recursive_verifier_fixture`); the inner proof and its
intermediate values reach the program as non-determinism (RAM and
digests).

For each configuration it writes <name>.tasm (the program, which the
program and the reference each assemble; the reference's digest comes
from its own assembler); recursive_verifier also gets
<name>.nondet.json. <name>.json records each file's SHA-256, the public
input and expected output at every padded height the configuration
runs at, and the Stark parameters.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SPIN_LOG2_HEIGHTS = (15, 16)
STARK = {"security_level": 160, "log2_expansion_factor": 2,
         "soundness": "proven"}


def _write(name: str, text: str) -> str:
    (HERE / name).write_text(text)
    return hashlib.sha256(text.encode()).hexdigest()


def _tasm(program) -> str:
    """The program as TASM text, each call naming its target's label."""
    lines = []
    address = 0
    for ins in program.instructions:
        if address in program.address_to_label:
            lines.append(f"{program.address_to_label[address]}:")
        text = str(ins)
        if ins.name == "call":
            text = f"call {program.address_to_label[ins.arg]}"
        lines.append(text)
        address += ins.size()
    return "\n".join(lines) + "\n"


def _program_files(name, program) -> dict:
    from triton_vm_tpu_torch.isa.program import Program

    text = _tasm(program)
    if Program.from_code(text).to_bwords() != program.to_bwords():
        raise AssertionError(f"{name}: the TASM text does not reassemble")
    return {"program": {"file": f"{name}.tasm",
                        "sha256": _write(f"{name}.tasm", text)}}


def spin():
    from triton_vm_tpu_torch import VM, PublicInput
    from triton_vm_tpu_torch.models import example_programs as ex

    record = {"name": "spin",
              "source": "triton-dev-util/src/lib.rs:52-60 "
                        "ProgramToBench::spin(log2_padded_height)",
              "model": "fibonacci", "stark": STARK}
    heights = {}
    for k in SPIN_LOG2_HEIGHTS:
        program, iterations = ex.spin(k)
        aet, output = VM.trace_execution(program, PublicInput([iterations]))
        if aet.padded_height() != 1 << k:
            raise AssertionError(f"spin({k}) pads to {aet.padded_height()}")
        heights[str(k)] = {"public_input": [iterations],
                           "output": [int(x) for x in output],
                           "cycles": aet.height_of_table("processor")}
    record.update(_program_files("spin", program))
    record["heights"] = heights
    _write("spin.json", json.dumps(record, indent=1) + "\n")


def recursive_verifier():
    from triton_vm_tpu_torch import VM, NonDeterminism, PublicInput, Stark
    from triton_vm_tpu_torch.models import baseline

    built = baseline.recursive_verifier_fixture(Stark(device="cpu"))
    program = built.programs["combined"]
    nd = built.non_determinism
    aet, output = VM.trace_execution(
        program, PublicInput([]),
        NonDeterminism(ram=dict(nd.ram), digests=list(nd.digests)))
    log2 = aet.padded_height().bit_length() - 1
    nondet = json.dumps({
        "individual_tokens": [int(x) for x in nd.individual_tokens],
        "digests": [[int(x) for x in d] for d in nd.digests],
        "ram": sorted([int(k), int(v)] for k, v in nd.ram.items())},
        separators=(",", ":"))
    record = {"name": "recursive_verifier",
              "source": "BASELINE.md config 5: the verifier core "
                        "(models/recursive_verifier.build) checking "
                        "fibonacci(7)'s proof for one revealed index",
              "revealed_indices": 1,
              "published": {"revealed_indices": 173,
                            "log2_padded_height": 21,
                            "why_cut": "one card proves the full "
                                       "verification in about 185 s, "
                                       "longer than a run's window"},
              "stark": STARK}
    record.update(_program_files("recursive_verifier", program))
    record["non_determinism"] = {
        "file": "recursive_verifier.nondet.json",
        "sha256": _write("recursive_verifier.nondet.json", nondet)}
    record["heights"] = {str(log2): {
        "public_input": [], "output": [int(x) for x in output],
        "cycles": aet.height_of_table("processor")}}
    _write("recursive_verifier.json", json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    for which in sys.argv[1:] or ("spin", "recursive_verifier"):
        {"spin": spin, "recursive_verifier": recursive_verifier}[which]()
        print("wrote", which, flush=True)
