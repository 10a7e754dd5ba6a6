"""The plain reference (port_bench/reference/) against the port on the
CPU: its hash, its frozen AIR, its assembler and program models, and its
verdict on sound and altered proofs, FRI and STIR."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.reference import air, assembler, programs, tip5, verifier
from port_bench.reference.proof_stream import Claim

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "port_bench" / "configs"


def test_batched_tip5_matches_the_scalar_one():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, tip5.P, size=(7, 23), dtype=np.uint64)
    rows[0, :] = tip5.P - 1
    got = tip5.hash_varlen_rows(rows)
    for r, d in zip(rows, got):
        assert [int(x) for x in d] == tip5.hash_varlen([int(x) for x in r])


def test_tip5_matches_the_port():
    from triton_vm_tpu_torch.crypto import tip5 as port_tip5

    words = list(range(3, 40))
    assert tip5.hash_varlen(words) == port_tip5.hash_varlen(words)


@pytest.mark.parametrize("name", ["spin", "recursive_verifier"])
def test_reference_assembly_gives_the_ports_words_and_digest(name):
    from triton_vm_tpu_torch.isa.program import Program

    text = (CONFIGS / f"{name}.tasm").read_text()
    words = assembler.assemble(text)
    program = Program.from_code(text)
    assert words == program.to_bwords()
    assert verifier.program_digest(words) == program.hash()


def test_assembler_resolves_labels_and_reduces_arguments():
    text = "push -1 // a comment\ncall f\nhalt\nf:\ndup 3\nreturn\n"
    assert assembler.assemble(text) == [1, tip5.P - 1, 49, 5, 0, 33, 3, 16]


def test_fibonacci_model_gives_the_frozen_outputs():
    spin = json.loads((CONFIGS / "spin.json").read_text())
    for at in spin["heights"].values():
        assert programs.fibonacci(at["public_input"]) == at["output"]


def test_frozen_air_matches_the_port():
    """The frozen constraints at a random point against the port's AIR."""
    from triton_vm_tpu_torch.air.evaluate import eval_host, linearize
    from triton_vm_tpu_torch.air.master import master_air

    rng = np.random.default_rng(9)
    point = {k: [tuple(int(x) for x in rng.integers(0, tip5.P, 3,
                                                    dtype=np.uint64))
                 for _ in range(n)]
             for k, n in (("main", 379), ("aux", 91), ("next_main", 379),
                          ("next_aux", 91), ("ch", 63))}
    for phase, exprs in master_air().constraints.items():
        steps, ids = linearize(exprs)
        theirs = eval_host(steps, ids, point["main"], point["aux"],
                           point["ch"], point["next_main"],
                           point["next_aux"])
        mine = air.evaluate(phase, point["main"], point["aux"], point["ch"],
                            point["next_main"], point["next_aux"])
        assert [tuple(v) for v in mine] == [tuple(v) for v in theirs]


@pytest.fixture(scope="module", params=["fri", "stir"])
def tiny_proof(request):
    """A fibonacci(7) proof by the port on the CPU at 32 bits of security,
    with the low-degree test forced."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import example_programs as ex

    stark = tvm.Stark(security_level=32, ldt_choice=request.param,
                      device="cpu")
    program = ex.fibonacci()
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([7]))
    claim = tvm.Claim.about_program(program).with_input([7]) \
        .with_output(output)
    proof = stark.prove(claim, aet, seed=bytes(range(32)))
    ref_claim = Claim(verifier.program_digest(program.to_bwords()), [7],
                      programs.fibonacci([7]))
    params = verifier.Parameters(security_level=32,
                                 ldt_choice=request.param)
    return list(proof.words), ref_claim, aet.padded_height(), params


def _item_offsets(words):
    """Start of each proof item's payload in the proof's words."""
    out = []
    pos = 2
    for _ in range(words[1]):
        out.append(pos + 1)
        pos += 1 + words[pos]
    return out


def test_reference_accepts_the_ports_proof(tiny_proof):
    words, claim, height, params = tiny_proof
    assert verifier.check(words, claim, height, params) == dict.fromkeys(
        verifier.LAYERS, 0)


def test_reference_rejects_another_claim(tiny_proof):
    words, claim, height, params = tiny_proof
    other = Claim(claim.program_digest, claim.input, [claim.output[0] + 1])
    assert verifier.check(words, other, height, params)["ood_quotient"] == 1


@pytest.mark.parametrize("item, layer", [(7, "ood_quotient"),
                                         (-1, "merkle"), (-2, "merkle")])
def test_reference_rejects_an_altered_word(tiny_proof, item, layer):
    words, claim, height, params = tiny_proof
    # items: the height, three roots, then the OOD rows from item 4 on
    start = _item_offsets(words)[item]
    altered = list(words)
    altered[start + 3] = (altered[start + 3] + 1) % tip5.P
    assert verifier.check(altered, claim, height, params)[layer] == 1


def test_reference_flags_another_height(tiny_proof):
    words, claim, height, params = tiny_proof
    assert verifier.check(words, claim, 2 * height, params)["height"] == 1


def test_reference_rejects_a_cut_proof(tiny_proof):
    words, claim, height, params = tiny_proof
    cut = [len(words) - 2] + words[1:-1]
    assert verifier.check(cut, claim, height, params)["decode"] == 1
