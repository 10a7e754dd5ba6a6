"""TASM backend: generate Triton assembly that evaluates the master AIR.

Recursion support — the verifier-in-the-VM needs the 604 lowered
constraints evaluated *inside* Triton VM on out-of-domain rows stored in
RAM. Mirrors the reference's generated-code semantics:

  * triton-constraint-builder/src/codegen.rs:423-887
    (`TasmBackend`): shared-node store passes by descending reference
    count, per-phase scope, base-field-evaluating constraints first,
    XFE stack representation [c2, c1, c0] (c0 on top), ``read_mem 3`` /
    ``write_mem 3`` element moves, ``addi``/``xb_mul`` shortcuts for
    base-field constants.
  * triton-vm/src/memory_layout.rs:18-141: static and
    dynamic memory layouts with integrality checking.

The emitted code is straight-line (no labels, no control flow, no
``halt``); the final instruction pushes ``*evaluated_constraints``. The
counterpart of `triton_vm_tpu.air.tasm`, whose text it reproduces line
for line (tests/test_torch_tasm.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bfe import P
from .master import master_air

EXTENSION_DEGREE = 3

#: Minimal required size of a memory page, in BFieldElements
#: (codegen.rs:370).
MEM_PAGE_SIZE = 1 << 32

#: Offset from `free_mem_page_ptr`, in XFieldElements, of the output
#: array (codegen.rs:376-383).
OUT_ARRAY_OFFSET = (MEM_PAGE_SIZE - (1 << 16)) // EXTENSION_DEGREE

NUM_MAIN_COLUMNS = 379
NUM_AUX_COLUMNS = 91
NUM_CHALLENGES = 63


@dataclass(frozen=True)
class MemoryRegion:
    """memory_layout.rs:121-150."""

    start: int
    size: int

    def contains_address(self, addr: int) -> bool:
        return self.start <= addr < self.start + self.size

    def overlaps(self, other: "MemoryRegion") -> bool:
        return (self.contains_address(other.start)
                or other.contains_address(self.start))


def _is_integral(regions) -> bool:
    if len(set(regions)) != len(regions):
        return False
    return all(not a.overlaps(b)
               for i, a in enumerate(regions)
               for b in regions[i + 1:])


@dataclass(frozen=True)
class StaticTasmConstraintEvaluationMemoryLayout:
    """memory_layout.rs:36-66: all input lists at statically known
    addresses."""

    free_mem_page_ptr: int
    curr_main_row_ptr: int
    curr_aux_row_ptr: int
    next_main_row_ptr: int
    next_aux_row_ptr: int
    challenges_ptr: int

    def memory_regions(self):
        return [
            MemoryRegion(self.free_mem_page_ptr, MEM_PAGE_SIZE),
            MemoryRegion(self.curr_main_row_ptr, NUM_MAIN_COLUMNS),
            MemoryRegion(self.curr_aux_row_ptr, NUM_AUX_COLUMNS),
            MemoryRegion(self.next_main_row_ptr, NUM_MAIN_COLUMNS),
            MemoryRegion(self.next_aux_row_ptr, NUM_AUX_COLUMNS),
            MemoryRegion(self.challenges_ptr, NUM_CHALLENGES),
        ]

    def is_integral(self) -> bool:
        return _is_integral(self.memory_regions())


@dataclass(frozen=True)
class DynamicTasmConstraintEvaluationMemoryLayout:
    """memory_layout.rs:14-34: row pointers arrive on the stack."""

    free_mem_page_ptr: int
    challenges_ptr: int

    def memory_regions(self):
        return [
            MemoryRegion(self.free_mem_page_ptr, MEM_PAGE_SIZE),
            MemoryRegion(self.challenges_ptr, NUM_CHALLENGES),
        ]

    def is_integral(self) -> bool:
        return _is_integral(self.memory_regions())


# ---------------------------------------------------------------- generator

def _path_counts(roots):
    """Reference-count semantics of lib.rs:454-500 (assert_unique_ids):
    each node's count is the number of paths from any constraint root,
    both child slots counted."""
    counts: dict[int, int] = {}
    order: list = []
    seen = set()

    def topo(node):
        if node.id in seen:
            return
        seen.add(node.id)
        if node.kind == "binop":
            topo(node.lhs)
            topo(node.rhs)
        order.append(node)

    for c in roots:
        topo(c.node)
    for c in roots:
        counts[c.node.id] = counts.get(c.node.id, 0) + 1
    for node in reversed(order):  # parents before children
        if node.kind == "binop":
            n = counts.get(node.id, 0)
            counts[node.lhs.id] = counts.get(node.lhs.id, 0) + n
            counts[node.rhs.id] = counts.get(node.rhs.id, 0) + n
    return counts


class _TasmGen:
    def __init__(self, lists: dict, input_location_is_static: bool):
        self.lists = lists  # IOList name -> base address
        self.static = input_location_is_static
        self.scope: set[int] = set()
        self.elements_written = 0
        self.code: list[str] = []

    # ------------------------------------------------- element move helpers

    def _load_xfe_from_list(self, base: int, element_index: int):
        word_index = element_index * EXTENSION_DEGREE + (EXTENSION_DEGREE - 1)
        self.code += [f"push {(base + word_index) % P}", "read_mem 3",
                      "pop 1"]

    def _load_xfe_from_pointed_to_list(self, ptr_addr: int,
                                       element_index: int):
        word_index = element_index * EXTENSION_DEGREE + (EXTENSION_DEGREE - 1)
        self.code += [f"push {ptr_addr % P}", "read_mem 1", "pop 1",
                      f"addi {word_index}", "read_mem 3", "pop 1"]

    def _store_xfe(self, element_index: int):
        word_index = element_index * EXTENSION_DEGREE
        self.code += [f"push {(self.lists['free'] + word_index) % P}",
                      "write_mem 3", "pop 1"]

    # --------------------------------------------------------- node loading

    def _load_node(self, node):
        if node.kind == "bconst":
            self.code.append(f"push {node.value}")
        elif node.kind == "xconst":
            c0, c1, c2 = node.value
            self.code += [f"push {c2}", f"push {c1}", f"push {c0}"]
        elif node.kind == "input":
            self._load_input(node.value)
        elif node.kind == "challenge":
            self._load_xfe_from_list(self.lists["challenges"], node.value)
        else:  # evaluated binop in scope
            self._load_xfe_from_list(self.lists["free"], node.id)

    def _load_input(self, value):
        input_kind, col = value
        list_name = {"main": "curr_main", "aux": "curr_aux",
                     "next_main": "next_main", "next_aux": "next_aux"}[
                         input_kind]
        if self.static:
            self._load_xfe_from_list(self.lists[list_name], col)
        else:
            self._load_xfe_from_pointed_to_list(
                self.lists[list_name + "_ptr_ptr"], col)

    # ------------------------------------------------------ node evaluation

    def _evaluate(self, node):
        """codegen.rs:745-785 evaluate_single_node."""
        if node.id in self.scope or node.kind != "binop":
            return self._load_node(node)
        lhs, rhs = node.lhs, node.rhs
        lhs_const = lhs.value if lhs.kind == "bconst" else None
        rhs_const = rhs.value if rhs.kind == "bconst" else None
        assert not (lhs_const is not None and rhs_const is not None), \
            "constant folding should have eliminated this"
        if node.op == "+" and rhs_const is not None:
            self._evaluate(lhs)
            self.code.append(f"addi {rhs_const}")
        elif node.op == "+" and lhs_const is not None:
            self._evaluate(rhs)
            self.code.append(f"addi {lhs_const}")
        elif node.op == "*" and rhs_const is not None:
            self._evaluate(lhs)
            self.code.append(f"push {rhs_const}")
            self.code.append("xb_mul")
        elif node.op == "*" and lhs_const is not None:
            self._evaluate(rhs)
            self.code.append(f"push {lhs_const}")
            self.code.append("xb_mul")
        else:
            self._evaluate(lhs)
            self._evaluate(rhs)
            self.code.append("xx_add" if node.op == "+" else "xx_mul")

    # --------------------------------------------------- shared-node stores

    def _store_shared(self, node, count, counts):
        if node.id in self.scope or node.kind != "binop":
            return
        if counts.get(node.id, 0) < count:
            self._store_shared(node.lhs, count, counts)
            self._store_shared(node.rhs, count, counts)
            return
        assert counts[node.id] == count
        self._evaluate(node)
        self._store_xfe(node.id)
        self.scope.add(node.id)

    def tokenize_circuits(self, constraints):
        """codegen.rs:676-694: store shared nodes (descending ref count),
        then evaluate each constraint — base-field-evaluating ones first —
        into the output array."""
        from . import circuit as C

        self.scope = set()
        counts = _path_counts(constraints)
        shared = sorted({c for c in counts.values() if c > 1}, reverse=True)
        for count in shared:
            for c in constraints:
                self._store_shared(c.node, count, counts)
        base = [c for c in constraints
                if C.evaluates_to_base_element(c.node)]
        ext = [c for c in constraints
               if not C.evaluates_to_base_element(c.node)]
        for c in list(base) + list(ext):
            self._evaluate(c.node)
            self._store_xfe(OUT_ARRAY_OFFSET + self.elements_written)
            self.elements_written += 1


def _generate(lists: dict, static: bool, preamble=()) -> list[str]:
    air = master_air()
    gen = _TasmGen(lists, static)
    gen.code.extend(preamble)
    for phase in ("init", "cons", "tran", "term"):
        gen.tokenize_circuits(air.constraints[phase])
    out_ptr = (lists["free"] + OUT_ARRAY_OFFSET * EXTENSION_DEGREE) % P
    gen.code.append(f"push {out_ptr}")
    return gen.code


def static_air_constraint_evaluation_tasm(
        layout: StaticTasmConstraintEvaluationMemoryLayout) -> list[str]:
    """codegen.rs:461-483: BEFORE: _  AFTER: _ *evaluated_constraints."""
    assert layout.is_integral()
    lists = {
        "free": layout.free_mem_page_ptr,
        "curr_main": layout.curr_main_row_ptr,
        "curr_aux": layout.curr_aux_row_ptr,
        "next_main": layout.next_main_row_ptr,
        "next_aux": layout.next_aux_row_ptr,
        "challenges": layout.challenges_ptr,
    }
    return _generate(lists, static=True)


def dynamic_air_constraint_evaluation_tasm(
        layout: DynamicTasmConstraintEvaluationMemoryLayout) -> list[str]:
    """codegen.rs:487-530: row pointers are consumed from the stack and
    parked in the first four words of the free memory page.

    BEFORE: _ *curr_main *curr_aux *next_main *next_aux
    AFTER:  _ *evaluated_constraints
    """
    assert layout.is_integral()
    fmp = layout.free_mem_page_ptr
    lists = {
        "free": fmp + 4,  # first four words hold the row pointers
        "curr_main_ptr_ptr": fmp + 0,
        "curr_aux_ptr_ptr": fmp + 1,
        "next_main_ptr_ptr": fmp + 2,
        "next_aux_ptr_ptr": fmp + 3,
        "challenges": layout.challenges_ptr,
    }
    # codegen.rs:652-675: pop the row pointers from the stack, top first
    preamble = []
    for addr in (fmp + 3, fmp + 2, fmp + 1, fmp + 0):
        preamble += [f"push {addr % P}", "write_mem 1", "pop 1"]
    return _generate(lists, static=False, preamble=preamble)
