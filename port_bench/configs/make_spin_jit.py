"""Write the frozen inputs of the configuration spin_jit.

Run once on the CPU, from the root of the repo:

    python -m port_bench.configs.make_spin_jit

spin_jit is the upstream benchmark generator ProgramToBench::spin
(triton-dev-util/src/lib.rs:52-60; the port's `models/example_programs.
spin`) at padded height 2^20, the height at which one 80-GB card proves
on the JIT (coset-by-coset) LDE. It runs spin's program, the frozen
configs/spin.tasm, which this script checks and does not write again; it
writes only spin_jit.json: the program's SHA-256, the public input, the
output and the cycle count at 2^20, and the Stark parameters. The output
is checked against the reference's plain model (reference/programs.py's
`fibonacci`), the padded height against the port's VM trace.
"""

from __future__ import annotations

import hashlib
import json

from port_bench.configs.make_inputs import HERE, STARK, _tasm, _write
from port_bench.reference import programs

LOG2_HEIGHT = 20


def spin_jit():
    from triton_vm_tpu_torch import VM, PublicInput
    from triton_vm_tpu_torch.isa.program import Program
    from triton_vm_tpu_torch.models import example_programs as ex

    program, iterations = ex.spin(LOG2_HEIGHT)
    text = _tasm(program)
    if Program.from_code(text).to_bwords() != program.to_bwords():
        raise AssertionError("spin's TASM text does not reassemble")
    if (HERE / "spin.tasm").read_text() != text:
        raise AssertionError("spin(20)'s program is not configs/spin.tasm")
    aet, output = VM.trace_execution(program, PublicInput([iterations]))
    if aet.padded_height() != 1 << LOG2_HEIGHT:
        raise AssertionError(f"spin({LOG2_HEIGHT}) pads to "
                             f"{aet.padded_height()}")
    output = [int(x) for x in output]
    if output != programs.fibonacci([iterations]):
        raise AssertionError("the VM's output is not the plain model's")
    record = {
        "name": "spin_jit",
        "source": f"triton-dev-util/src/lib.rs:52-60 "
                  f"ProgramToBench::spin({LOG2_HEIGHT})",
        "model": "fibonacci", "stark": STARK,
        "program": {"file": "spin.tasm",
                    "sha256": hashlib.sha256(text.encode()).hexdigest()},
        "heights": {str(LOG2_HEIGHT): {
            "public_input": [iterations], "output": output,
            "cycles": aet.height_of_table("processor")}}}
    _write("spin_jit.json", json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    spin_jit()
    print("wrote spin_jit", flush=True)
