"""Master main table: fill and pad.

Transcribes the witness-side main-table logic of
triton-vm/src/table/{master_table,program,processor,
op_stack,ram,jump_stack,hash,cascade,lookup,u32}.rs.

Main table: numpy uint64, shape (padded_height, 379), row-major host side;
the RAM table's Bezout coefficients alone are computed on the prover's
device (ops/poly.py), in the span `RAM Bezout` within `RAM table`, and
`_bezout_plain` is their O(N^2) host version, kept as the tests' oracle.
The derived (degree-lowering) main columns and the whole aux table are
filled on the prover's device by tables/extend_device.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air import columns
from ..crypto import tip5
from ..fields import bfe, poly
from ..fields.bfe import P
from ..isa.instruction import _SPEC
from ..ops import gf
from ..ops import poly as dev_poly
from ..utils import profiler
from ..vm.aet import LOOKUP_TABLE_HEIGHT

M = columns.main_index

NUM_MAIN = 379


def _inverse_or_zero(x):
    return pow(x, P - 2, P) if x % P else 0


def _rows_array(rows, width) -> np.ndarray:
    """(n, width) uint64 view of AET rows (native path already stores
    numpy; the Python interpreter stores lists of tuples)."""
    if isinstance(rows, np.ndarray):
        return rows if rows.size else rows.reshape(0, width)
    a = np.asarray(rows, dtype=np.uint64)
    return a.reshape(-1, width) if a.size else a.reshape(0, width)


def _batch_inverse_or_zero(values: np.ndarray) -> np.ndarray:
    """Vectorized-ish _inverse_or_zero over a uint64 array: Montgomery
    batch inversion on the nonzero entries (one modpow total)."""
    out = np.zeros(len(values), np.uint64)
    nz = np.nonzero(values % P)[0]
    if len(nz):
        inverted = bfe.batch_inverse([int(v) for v in values[nz]])
        out[nz] = np.array(inverted, np.uint64)
    return out


# ============================================================== main table

def fill_main_table(aet, padded_height=None, device="cuda") -> np.ndarray:
    """The main table from the execution trace, on the host; the RAM
    table's Bezout coefficients are computed on `device`. In a profiler
    session each table's fill, and the padding of all nine, has its own
    span within `host table fill`."""
    with profiler.span("host table fill", "witness"):
        h = padded_height or aet.padded_height()
        main = np.zeros((h, NUM_MAIN), np.uint64)

        clk_jump_diffs = {"op_stack": [], "ram": [], "jump_stack": []}
        with profiler.span("op stack table", "witness"):
            _fill_op_stack(main, aet, clk_jump_diffs)
        with profiler.span("RAM table", "witness"):
            _fill_ram(main, aet, clk_jump_diffs, device)
        with profiler.span("jump stack table", "witness"):
            _fill_jump_stack(main, aet, clk_jump_diffs)
        with profiler.span("processor table", "witness"):
            _fill_processor(main, aet, clk_jump_diffs)
        with profiler.span("program table", "witness"):
            _fill_program(main, aet)
        with profiler.span("hash table", "witness"):
            _fill_hash(main, aet)
        with profiler.span("cascade and lookup tables", "witness"):
            _fill_cascade(main, aet)
            _fill_lookup(main, aet)
        with profiler.span("U32 table", "witness"):
            _fill_u32(main, aet)

        with profiler.span("table padding", "witness"):
            _pad_program(main, aet)
            _pad_processor(main, aet)
            _pad_op_stack(main, aet)
            _pad_ram(main, aet)
            _pad_jump_stack(main, aet)
            _pad_hash(main, aet)
            _pad_cascade(main, aet)
            _pad_lookup(main, aet)
            _pad_u32(main, aet)
        return main


def _fill_program(main, aet):
    instructions = aet.program.to_bwords()
    program_len = len(instructions)
    padded_len = aet.padded_program_length()
    padded = instructions + [1] + [0] * (padded_len - program_len - 1)
    for i in range(padded_len):
        main[i, M("program", "Address")] = i
        main[i, M("program", "Instruction")] = padded[i]
        main[i, M("program", "LookupMultiplicity")] = (
            aet.instruction_multiplicities[i] if i < program_len else 0)
        idx_in_chunk = i % tip5.RATE
        main[i, M("program", "IndexInChunk")] = idx_in_chunk
        main[i, M("program", "MaxMinusIndexInChunkInv")] = _inverse_or_zero(
            tip5.RATE - 1 - idx_in_chunk)
        main[i, M("program", "IsHashInputPadding")] = int(i >= program_len)


def _pad_program(main, aet):
    start = aet.padded_program_length()
    h = main.shape[0]
    if start >= h:
        return
    idx = np.arange(start, h, dtype=np.uint64)
    iic = idx % np.uint64(tip5.RATE)
    inv_by_chunk_index = np.array(
        [_inverse_or_zero(tip5.RATE - 1 - j) for j in range(tip5.RATE)],
        np.uint64)
    main[start:h, M("program", "Address")] = idx
    main[start:h, M("program", "IndexInChunk")] = iic
    main[start:h, M("program", "MaxMinusIndexInChunkInv")] = \
        inv_by_chunk_index[iic.astype(np.int64)]
    main[start:h, M("program", "IsHashInputPadding")] = 1
    main[start:h, M("program", "IsTablePadding")] = 1


def _fill_processor(main, aet, clk_jump_diffs):
    n = len(aet.processor_rows)
    start = columns.MAIN_TABLE_START["processor"]
    proc = _rows_array(aet.processor_rows, 39)
    if n:
        main[:n, start:start + 39] = proc % np.uint64(P)
    diffs = np.concatenate([
        np.asarray(clk_jump_diffs[t], np.int64).reshape(-1)
        for t in ("op_stack", "ram", "jump_stack")])
    # every clock-jump difference is a forward jump within the trace: < n
    mult = np.bincount(diffs, minlength=n).astype(np.uint64)
    main[:n, M("processor", "ClockJumpDifferenceLookupMultiplicity")] = mult


def _pad_processor(main, aet):
    n = len(aet.processor_rows)
    h = main.shape[0]
    if n == h:
        return
    start = columns.MAIN_TABLE_START["processor"]
    end = start + len(columns.MAIN_COLUMNS["processor"])
    template = main[n - 1, start:end].copy()
    template[columns.local_main_index("processor", "IsPadding")] = 1
    template[columns.local_main_index(
        "processor", "ClockJumpDifferenceLookupMultiplicity")] = 0
    main[n:h, start:end] = template
    main[n:h, M("processor", "CLK")] = np.arange(n, h, dtype=np.uint64)
    # jump-stack padding rows keep looking up clock jump differences of 1
    main[1, M("processor", "ClockJumpDifferenceLookupMultiplicity")] += h - n


def _fill_op_stack(main, aet, clk_jump_diffs):
    a = _rows_array(aet.op_stack_rows, 4)
    n = len(a)
    if n == 0:
        clk_jump_diffs["op_stack"] = []
        return
    # stable sort by (pointer, clk) — matches sorted() on (r[2], r[0])
    s = a[np.lexsort((a[:, 0], a[:, 2]))]
    main[:n, M("op_stack", "CLK")] = s[:, 0]
    main[:n, M("op_stack", "IB1ShrinkStack")] = s[:, 1]
    main[:n, M("op_stack", "StackPointer")] = s[:, 2]
    main[:n, M("op_stack", "FirstUnderflowElement")] = s[:, 3]
    same_ptr = s[:-1, 2] == s[1:, 2]
    clk_jump_diffs["op_stack"] = (s[1:, 0] - s[:-1, 0])[same_ptr]


def _pad_op_stack(main, aet):
    n = len(aet.op_stack_rows)
    h = main.shape[0]
    start = columns.MAIN_TABLE_START["op_stack"]
    end = start + 4
    template = main[max(0, n - 1), start:end].copy()
    template[columns.local_main_index("op_stack", "IB1ShrinkStack")] = 2
    if n == 0:
        template[columns.local_main_index("op_stack", "StackPointer")] = 16
    main[n:h, start:end] = template


def _fill_ram(main, aet, clk_jump_diffs, device):
    a = _rows_array(aet.ram_rows, 4)
    n = len(a)
    if n == 0:
        clk_jump_diffs["ram"] = []
        return
    # stable sort by (pointer, clk)
    s = a[np.lexsort((a[:, 0], a[:, 2]))]
    main[:n, M("ram", "CLK")] = s[:, 0]
    main[:n, M("ram", "InstructionType")] = s[:, 1]
    main[:n, M("ram", "RamPointer")] = s[:, 2]
    main[:n, M("ram", "RamValue")] = s[:, 3]

    # Bezout coefficient polynomials for the unique (sorted) RAM pointers.
    # Row r carries coefficient index (n_unique - 1 - rank(ptr_r)): the
    # reference pops from the back of the coefficient list on every
    # pointer change (ram.rs:117-141).
    unique_ptrs, ranks = np.unique(s[:, 2], return_inverse=True)
    b0, b1 = bezout_coefficient_polynomials_coefficients(
        [int(p) for p in unique_ptrs], device)
    idx = len(unique_ptrs) - 1 - ranks
    main[:n, M("ram", "BezoutCoefficientPolynomialCoefficient0")] = \
        np.array(b0, np.uint64)[idx]
    main[:n, M("ram", "BezoutCoefficientPolynomialCoefficient1")] = \
        np.array(b1, np.uint64)[idx]

    # pointers are sorted ascending and < P: plain uint64 subtraction is
    # exact and already reduced mod P
    ramp_diff = s[1:, 2] - s[:-1, 2]
    main[:n - 1, M("ram", "InverseOfRampDifference")] = \
        _batch_inverse_or_zero(ramp_diff)
    same_ptr = ramp_diff == 0
    clk_jump_diffs["ram"] = (s[1:, 0] - s[:-1, 0])[same_ptr]


def bezout_coefficient_polynomials_coefficients(unique_roots,
                                                device="cuda"):
    """(a, b) with a*rp + b*fd = 1, deg-padded to n coefficients
    (triton-vm/src/table/ram.rs:162-206): lists of n ints, computed on
    `device` in O(n log^2 n) (ops/poly.py: subproduct tree, scaled
    remainder tree, Lagrange combination). The same ints as
    `_bezout_plain`."""
    if not unique_roots:
        return [], []
    device = torch.device(device)
    with profiler.device_span("RAM Bezout", "witness", device):
        roots = gf.from_u64(np.asarray(unique_roots, np.uint64), device)
        a, b = dev_poly.bezout_coefficients(roots)
        return gf.to_u64(a).tolist(), gf.to_u64(b).tolist()


def _bezout_plain(unique_roots):
    """The O(n^2) host version of
    `bezout_coefficient_polynomials_coefficients` (list polynomials of
    fields/poly.py), kept as the tests' oracle."""
    if not unique_roots:
        return [], []
    rp = poly.zerofier(unique_roots)
    fd = poly.formal_derivative(rp)
    fd_in_roots = poly.batch_evaluate(fd, unique_roots)
    b_in_roots = bfe.batch_inverse(fd_in_roots)
    b = poly.interpolate(unique_roots, b_in_roots)
    one_minus_fd_b = poly.sub([1], poly.mul(fd, b))
    a, rem = poly.divide(one_minus_fd_b, rp)
    assert not rem
    n = len(unique_roots)
    a = (a + [0] * n)[:n]
    b = (b + [0] * n)[:n]
    return a, b


def _pad_ram(main, aet):
    n = len(aet.ram_rows)
    h = main.shape[0]
    start = columns.MAIN_TABLE_START["ram"]
    end = start + 7
    template = main[max(0, n - 1), start:end].copy()
    template[columns.local_main_index("ram", "InstructionType")] = 2
    if n == 0:
        template[columns.local_main_index(
            "ram", "BezoutCoefficientPolynomialCoefficient1")] = 1
    main[n:h, start:end] = template


def _fill_jump_stack(main, aet, clk_jump_diffs):
    CLK_, CI_, JSP_, JSO_, JSD_ = 0, 3, 12, 13, 14  # processor row offsets
    proc = _rows_array(aet.processor_rows, 39)
    n = len(proc)
    # bucket-by-JSP in trace order == stable sort by JSP (rows are
    # recorded in CLK order)
    order = np.argsort(proc[:, JSP_], kind="stable")
    s = proc[order]
    main[:n, M("jump_stack", "CLK")] = s[:, CLK_]
    main[:n, M("jump_stack", "CI")] = s[:, CI_]
    main[:n, M("jump_stack", "JSP")] = s[:, JSP_]
    main[:n, M("jump_stack", "JSO")] = s[:, JSO_]
    main[:n, M("jump_stack", "JSD")] = s[:, JSD_]
    same_jsp = s[:-1, JSP_] == s[1:, JSP_]
    clk_jump_diffs["jump_stack"] = (s[1:, CLK_] - s[:-1, CLK_])[same_jsp]


def _pad_jump_stack(main, aet):
    n = len(aet.processor_rows)
    h = main.shape[0]
    if n == h:
        return
    start = columns.MAIN_TABLE_START["jump_stack"]
    end = start + 5
    num_padding = h - n
    clk_col = M("jump_stack", "CLK")
    max_clk_before = n - 1
    row_idx = int(np.nonzero(main[:n, clk_col]
                             == np.uint64(max_clk_before))[0][0])
    move_src = slice(row_idx + 1, n)
    num_moved = n - (row_idx + 1)
    if num_moved > 0:
        moved = main[move_src, start:end].copy()
        main[row_idx + 1 + num_padding:h, start:end] = moved
    template = main[row_idx, start:end].copy()
    main[row_idx + 1:row_idx + 1 + num_padding, start:end] = template
    main[row_idx + 1:row_idx + 1 + num_padding, clk_col] = np.arange(
        n, h, dtype=np.uint64)


def _fill_hash(main, aet):
    start = columns.MAIN_TABLE_START["hash"]
    width = len(columns.MAIN_COLUMNS["hash"])
    mode_off = columns.local_main_index("hash", "Mode")
    i = 0
    for rows, mode in ((aet.program_hash_rows, 1), (aet.sponge_rows, 2),
                       (aet.hash_rows, 3)):
        a = _rows_array(rows, width)
        n = len(a)
        if n:
            main[i:i + n, start:start + width] = a % np.uint64(P)
            main[i:i + n, start + mode_off] = mode
        i += n


def _pad_hash(main, aet):
    n = aet.height_of_table("hash")
    h = main.shape[0]
    inv = _inverse_or_zero(((1 << 32) - 1) % P)
    for j in range(4):
        main[n:h, M("hash", f"State{j}Inv")] = inv
    rcs = tip5.ROUND_CONSTANTS[:16]
    for j in range(16):
        main[n:h, M("hash", f"Constant{j}")] = rcs[j]
    main[n:h, M("hash", "Mode")] = 0
    main[n:h, M("hash", "CI")] = _SPEC["hash"][0]


def _fill_cascade(main, aet):
    for i, (limb, mult) in enumerate(aet.cascade_multiplicities.items()):
        lo, hi = limb & 0xFF, (limb >> 8) & 0xFF
        main[i, M("cascade", "LookInLo")] = lo
        main[i, M("cascade", "LookInHi")] = hi
        main[i, M("cascade", "LookOutLo")] = tip5.LOOKUP_TABLE[lo]
        main[i, M("cascade", "LookOutHi")] = tip5.LOOKUP_TABLE[hi]
        main[i, M("cascade", "LookupMultiplicity")] = mult


def _pad_cascade(main, aet):
    n = len(aet.cascade_multiplicities)
    main[n:, M("cascade", "IsPadding")] = 1


def _fill_lookup(main, aet):
    n = LOOKUP_TABLE_HEIGHT
    main[:n, M("lookup", "LookIn")] = np.arange(n, dtype=np.uint64)
    main[:n, M("lookup", "LookOut")] = np.array(tip5.LOOKUP_TABLE, np.uint64)
    main[:n, M("lookup", "LookupMultiplicity")] = np.array(
        aet.lookup_multiplicities, np.uint64)


def _pad_lookup(main, aet):
    main[LOOKUP_TABLE_HEIGHT:, M("lookup", "IsPadding")] = 1


_U32_RESULT_FINAL = {"split": 0, "lt": 2, "and": 0, "log_2_floor": P - 1,
                     "pow": 1, "pop_count": 0}


def _u32_section(name, lhs, rhs, multiplicity):
    """Rows for one u32 table entry (u32.rs:u32_section_next_row),
    iteratively."""
    neg33inv = _inverse_or_zero((0 - 33) % P)
    rows = []  # dicts
    row = {"CopyFlag": 1, "Bits": 0, "BitsMinus33Inv": neg33inv,
           "CI": _SPEC[name][0], "LHS": lhs, "RHS": rhs, "LhsInv": 0,
           "RhsInv": 0, "Result": 0, "LookupMultiplicity": multiplicity}
    rows.append(row)
    # forward: build rows until the last one
    while not ((rows[-1]["LHS"] == 0 or name == "pow") and rows[-1]["RHS"] == 0):
        cur = rows[-1]
        nxt = dict(cur)
        nxt["CopyFlag"] = 0
        nxt["Bits"] = cur["Bits"] + 1
        nxt["BitsMinus33Inv"] = _inverse_or_zero((nxt["Bits"] - 33) % P)
        if name != "pow":
            nxt["LHS"] = cur["LHS"] >> 1
        nxt["RHS"] = cur["RHS"] >> 1
        nxt["LookupMultiplicity"] = 0
        rows.append(nxt)
    # last row result
    last = rows[-1]
    last["Result"] = _U32_RESULT_FINAL[name]
    if name == "lt" and last["Bits"] == 0:
        last["Result"] = 0
    last["LhsInv"] = _inverse_or_zero(last["LHS"])
    # backward pass
    for i in range(len(rows) - 2, -1, -1):
        row, nxt = rows[i], rows[i + 1]
        lhs_lsb = row["LHS"] % 2 if name != "pow" else None
        rhs_lsb = row["RHS"] % 2
        row["LhsInv"] = _inverse_or_zero(row["LHS"])
        row["RhsInv"] = _inverse_or_zero(row["RHS"])
        nr = nxt["Result"]
        if name == "split":
            row["Result"] = nr
        elif name == "lt":
            if nr in (0, 1):
                row["Result"] = nr
            elif lhs_lsb == 0 and rhs_lsb == 1:
                row["Result"] = 1
            elif lhs_lsb == 1 and rhs_lsb == 0:
                row["Result"] = 0
            elif row["CopyFlag"] == 1:
                row["Result"] = 0
            else:
                row["Result"] = 2
        elif name == "and":
            row["Result"] = 2 * nr + (row["LHS"] % 2) * rhs_lsb
        elif name == "log_2_floor":
            if row["LHS"] == 0:
                row["Result"] = P - 1
            elif nxt["LHS"] != 0:
                row["Result"] = nr
            else:
                row["Result"] = row["Bits"]
        elif name == "pow":
            if rhs_lsb == 0:
                row["Result"] = nr * nr % P
            else:
                row["Result"] = nr * nr % P * row["LHS"] % P
        elif name == "pop_count":
            row["Result"] = nr + (row["LHS"] % 2)
        else:
            raise AssertionError(name)
    return rows


def _fill_u32(main, aet):
    i = 0
    for (name, lhs, rhs), mult in aet.u32_entries.items():
        for row in _u32_section(name, lhs, rhs, mult):
            for col, val in row.items():
                main[i, M("u32", col)] = val % P
            i += 1


def _pad_u32(main, aet):
    n = aet.height_of_table("u32")
    h = main.shape[0]
    neg33inv = _inverse_or_zero((0 - 33) % P)
    padding = {"CI": _SPEC["split"][0], "BitsMinus33Inv": neg33inv}
    if n > 0:
        padding["CI"] = int(main[n - 1, M("u32", "CI")])
        padding["LHS"] = int(main[n - 1, M("u32", "LHS")])
        padding["LhsInv"] = int(main[n - 1, M("u32", "LhsInv")])
        padding["Result"] = int(main[n - 1, M("u32", "Result")])
        if padding["CI"] == _SPEC["lt"][0]:
            padding["Result"] = 2
    start = columns.MAIN_TABLE_START["u32"]
    main[n:h, start:start + 10] = 0
    for col, val in padding.items():
        main[n:h, M("u32", col)] = val
