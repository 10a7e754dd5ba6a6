"""The port's TASM AIR-evaluation generators (triton_vm_tpu_torch.air.tasm)
against the JAX package's: the same Triton assembly line for line, for
the static and the dynamic memory layout, and the same layout checks.
The evaluators' values, executed step by step in the port's VM (about a
second each), are held against the port's host AIR evaluator, as the
`slow` tests of tests/test_tasm.py do for the JAX package."""

import pytest

from triton_vm_tpu.air import tasm as jtasm
from triton_vm_tpu_torch.air import evaluate as ev
from triton_vm_tpu_torch.air import tasm
from triton_vm_tpu_torch.air.master import master_air
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.isa.program import Program
from triton_vm_tpu_torch.utils.stdrng import ChaCha12Rng, seed_from_u64
from triton_vm_tpu_torch.vm.machine import (NonDeterminism, PublicInput,
                                            VMState)

NM, NA, NCH = 379, 91, 63
CURR_MAIN = 1 << 40
CURR_AUX = CURR_MAIN + 3 * NM + 10
NEXT_MAIN = CURR_AUX + 3 * NA + 10
NEXT_AUX = NEXT_MAIN + 3 * NM + 10
CHALLENGES = NEXT_AUX + 3 * NA + 10
FREE_PAGE = 1 << 44
STATIC = dict(free_mem_page_ptr=FREE_PAGE, curr_main_row_ptr=CURR_MAIN,
              curr_aux_row_ptr=CURR_AUX, next_main_row_ptr=NEXT_MAIN,
              next_aux_row_ptr=NEXT_AUX, challenges_ptr=CHALLENGES)
DYNAMIC = dict(free_mem_page_ptr=FREE_PAGE, challenges_ptr=CHALLENGES)


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_generated_tasm_equals_jax(kind):
    if kind == "static":
        got = tasm.static_air_constraint_evaluation_tasm(
            tasm.StaticTasmConstraintEvaluationMemoryLayout(**STATIC))
        want = jtasm.static_air_constraint_evaluation_tasm(
            jtasm.StaticTasmConstraintEvaluationMemoryLayout(**STATIC))
    else:
        got = tasm.dynamic_air_constraint_evaluation_tasm(
            tasm.DynamicTasmConstraintEvaluationMemoryLayout(**DYNAMIC))
        want = jtasm.dynamic_air_constraint_evaluation_tasm(
            jtasm.DynamicTasmConstraintEvaluationMemoryLayout(**DYNAMIC))
    assert isinstance(got, list) and all(isinstance(x, str) for x in got)
    assert got == want
    # straight-line code ending in the push of *evaluated_constraints
    out_ptr = (FREE_PAGE + (4 if kind == "dynamic" else 0)
               + tasm.OUT_ARRAY_OFFSET * tasm.EXTENSION_DEGREE) % P
    assert got[-1] == f"push {out_ptr}"
    assert not any(line.endswith(":") or line == "halt" for line in got)


def test_constants_equal_jax():
    for name in ("EXTENSION_DEGREE", "MEM_PAGE_SIZE", "OUT_ARRAY_OFFSET",
                 "NUM_MAIN_COLUMNS", "NUM_AUX_COLUMNS", "NUM_CHALLENGES"):
        assert getattr(tasm, name) == getattr(jtasm, name), name


@pytest.mark.parametrize("layout", [
    STATIC,
    dict(STATIC, curr_aux_row_ptr=CURR_MAIN + 1),       # overlaps main
    dict(STATIC, challenges_ptr=FREE_PAGE + 5),         # in the free page
    dict(STATIC, next_aux_row_ptr=CURR_AUX),            # duplicate region
    DYNAMIC,
    dict(DYNAMIC, challenges_ptr=FREE_PAGE + (1 << 32) - 1),
    dict(DYNAMIC, challenges_ptr=FREE_PAGE + (1 << 32)),
])
def test_memory_layout_integrity_equals_jax(layout):
    if "curr_main_row_ptr" in layout:
        got = tasm.StaticTasmConstraintEvaluationMemoryLayout(**layout)
        want = jtasm.StaticTasmConstraintEvaluationMemoryLayout(**layout)
    else:
        got = tasm.DynamicTasmConstraintEvaluationMemoryLayout(**layout)
        want = jtasm.DynamicTasmConstraintEvaluationMemoryLayout(**layout)
    assert got.is_integral() == want.is_integral()
    assert ([(r.start, r.size) for r in got.memory_regions()]
            == [(r.start, r.size) for r in want.memory_regions()])
    if layout in (STATIC, DYNAMIC):
        assert got.is_integral()


def test_non_integral_layout_is_refused():
    layout = tasm.StaticTasmConstraintEvaluationMemoryLayout(
        **dict(STATIC, curr_aux_row_ptr=CURR_MAIN + 1))
    assert not layout.is_integral()
    with pytest.raises(AssertionError):
        tasm.static_air_constraint_evaluation_tasm(layout)


# ------------------------------------------------------- in-VM evaluation

def _random_inputs():
    rng = ChaCha12Rng(seed_from_u64(0xC0FFEE))
    return (rng.random_xfes(NM), rng.random_xfes(NA),
            rng.random_xfes(NM), rng.random_xfes(NA),
            rng.random_xfes(NCH))


def _expected_values(curr_main, curr_aux, next_main, next_aux, challenges):
    air = master_air()
    out = []
    for key in ("init", "cons", "tran", "term"):
        steps, out_ids = ev.linearize(air.constraints[key])
        out.extend(ev.eval_host(
            steps, out_ids, curr_main, curr_aux, challenges,
            next_main_row=next_main if key == "tran" else None,
            next_aux_row=next_aux if key == "tran" else None))
    return out


def _ram_for_rows(rows):
    ram = {}
    for base, xfes in zip((CURR_MAIN, CURR_AUX, NEXT_MAIN, NEXT_AUX,
                           CHALLENGES), rows):
        for i, x in enumerate(xfes):
            for c in range(3):
                ram[(base + 3 * i + c) % P] = x[c]
    return ram


def _run_straight_line(code_lines, ram, stack_pushes=()):
    source = "\n".join(
        [f"push {v}" for v in stack_pushes] + list(code_lines) + ["halt"])
    state = VMState(Program.from_code(source), PublicInput([]),
                    NonDeterminism(ram=ram))
    while not state.halting:
        state.step()
    return state


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_tasm_evaluator_matches_host_evaluator(kind):
    rows = _random_inputs()
    if kind == "static":
        code = tasm.static_air_constraint_evaluation_tasm(
            tasm.StaticTasmConstraintEvaluationMemoryLayout(**STATIC))
        pushes = ()
    else:
        code = tasm.dynamic_air_constraint_evaluation_tasm(
            tasm.DynamicTasmConstraintEvaluationMemoryLayout(**DYNAMIC))
        # BEFORE: _ *curr_main *curr_aux *next_main *next_aux (top)
        pushes = (CURR_MAIN, CURR_AUX, NEXT_MAIN, NEXT_AUX)
    state = _run_straight_line(code, _ram_for_rows(rows), pushes)
    out_ptr = state.op_stack[0]
    expected = _expected_values(*rows)
    got = [tuple(state.ram.get((out_ptr + 3 * i + c) % P, 0)
                 for c in range(3)) for i in range(len(expected))]
    assert got == [tuple(x) for x in expected]
