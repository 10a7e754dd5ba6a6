"""Master main & aux tables: fill, pad, derived columns, extend.

Transcribes the witness-side table logic of
triton-vm/src/table/{master_table,program,processor,
op_stack,ram,jump_stack,hash,cascade,lookup,u32}.rs.

Main table: numpy uint64, shape (padded_height, 379), row-major host side;
the RAM table's Bezout coefficients alone are computed on the prover's
device (ops/poly.py), in the span `RAM Bezout` within `fill main`.
Aux table: numpy uint64, shape (padded_height, 91, 3) (XFE coefficients).
The prover fills the main table from the execution trace here. The
derived (degree-lowering) columns and the sequential-scan aux columns
computed here on the host, vectorized over rows where the math allows,
are the oracle of the prover's device witness (tables/extend_device.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..air import challenges as chal
from ..air import circuit as C
from ..air import columns
from ..air.evaluate import eval_host, linearize, substitution_pairs
from ..air.master import master_air
from ..crypto import tip5
from ..fields import bfe, poly, xfe
from ..fields.bfe import P
from ..isa.instruction import OPCODE_TO_NAME, _SPEC
from ..ops import gf
from ..ops import poly as dev_poly
from ..utils import profiler
from ..vm.aet import LOOKUP_TABLE_HEIGHT

M = columns.main_index
A = columns.aux_index

NUM_MAIN = 379
NUM_AUX = 91


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
    table's Bezout coefficients are computed on `device`."""
    with profiler.span("host table fill", "witness"):
        h = padded_height or aet.padded_height()
        main = np.zeros((h, NUM_MAIN), np.uint64)

        clk_jump_diffs = {"op_stack": [], "ram": [], "jump_stack": []}
        _fill_op_stack(main, aet, clk_jump_diffs)
        _fill_ram(main, aet, clk_jump_diffs, device)
        _fill_jump_stack(main, aet, clk_jump_diffs)
        _fill_processor(main, aet, clk_jump_diffs)
        _fill_program(main, aet)
        _fill_hash(main, aet)
        _fill_cascade(main, aet)
        _fill_lookup(main, aet)
        _fill_u32(main, aet)

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


# ================================================== derived main columns

def fill_derived_main_columns(main: np.ndarray):
    """Populate the 230 degree-lowering main columns (host, exact
    object-int math vectorized over rows)."""
    air = master_air()
    _fill_derived(main, None, air.main_subs, main_only=True)


def _fill_derived(main, aux, subs_by_phase, main_only):
    """Evaluate substitution RHSes sequentially, vectorized over rows."""
    h = main.shape[0]
    main_cols = {}
    for phase in ("init", "cons", "tran", "term"):
        subs = subs_by_phase[phase]
        if not subs:
            continue
        pairs = substitution_pairs(subs)
        for kind, col, rhs in pairs:
            steps, out_ids = linearize([C.Expr(None, rhs)])
            # Transition-phase derived columns are filled dual-row for rows
            # 0..h-2 and left ZERO in the last row — even when the RHS has
            # no next-row reads (substitutions.rs:266-301 slices
            # s![0..num_rows-1] unconditionally for the tran section).
            dual = phase == "tran"
            vals = _eval_sub_host_vectorized(steps, out_ids[0], main, aux, dual)
            if kind == C.MAIN:
                main[:, col] = vals
            else:
                aux[:, col - 0, :] = vals  # (h, 3)


def _eval_sub_host_vectorized(steps, out_id, main, aux, dual):
    """Vectorized host evaluation of one substitution RHS over all rows,
    using numpy object arrays of Python ints (exact, no overflow)."""
    h = main.shape[0]

    def as_obj(col_vals):
        return col_vals.astype(object)

    env = {}
    for nid, kind, payload in steps:
        if kind == "bconst":
            env[nid] = payload  # scalar int
        elif kind == "xconst":
            env[nid] = tuple(payload)
        elif kind == "challenge":
            raise AssertionError("main substitutions cannot use challenges")
        elif kind == "input":
            ik, col = payload
            if ik == C.MAIN:
                env[nid] = as_obj(main[:, col])
            elif ik == C.NEXT_MAIN:
                rolled = np.roll(main[:, col], -1)
                rolled[-1] = 0
                env[nid] = as_obj(rolled)
            else:
                raise AssertionError("aux inputs in main substitution")
        else:
            op, lid, rid = payload
            l, r = env[lid], env[rid]
            env[nid] = (l + r) % P if op == "+" else (l * r) % P
    out = env[out_id]
    if isinstance(out, int):
        out = np.full(h, out, object)
    if dual:
        out[-1] = 0  # dual-row derived columns are 0 in the last row
    return out.astype(np.uint64)


# =========================================================== aux (extend)

class X:
    """Tiny scalar XFE helper namespace for readable extend code."""
    add = staticmethod(xfe.add)
    mul = staticmethod(xfe.mul)
    inv = staticmethod(xfe.inv)
    lift = staticmethod(xfe.lift)
    bmul = staticmethod(lambda a, s: xfe.bfe_mul(a, s % P))
    ZERO = xfe.ZERO
    ONE = xfe.ONE


def extend_host(main: np.ndarray, challenges) -> np.ndarray:
    """Host reference implementation of the aux extension (per-row
    Python scans; master_table.rs:1006-1075 semantics)."""
    h = main.shape[0]
    aux = np.zeros((h, NUM_AUX, 3), np.uint64)

    def ch(name):
        return challenges[name]

    mrow = lambda i, table, name: int(main[i, M(table, name)])

    _extend_program(main, aux, ch, h)
    _extend_processor(main, aux, ch, h)
    _extend_op_stack(main, aux, ch, h)
    _extend_ram(main, aux, ch, h)
    _extend_jump_stack(main, aux, ch, h)
    _extend_hash(main, aux, ch, h)
    _extend_cascade(main, aux, ch, h)
    _extend_lookup(main, aux, ch, h)
    _extend_u32(main, aux, ch, h)
    return aux


def _set(aux, i, table, name, value):
    aux[i, A(table, name)] = np.array(value, np.uint64)


def _extend_program(main, aux, ch, h):
    log_der = X.ZERO
    prep = X.ONE
    send = X.ONE
    for i in range(h):
        row = lambda name: int(main[i, M("program", name)])
        nxt = lambda name: int(main[min(i + 1, h - 1), M("program", name)])
        _set(aux, i, "program", "InstructionLookupServerLogDerivative", log_der)
        if i < h - 1 and row("IsHashInputPadding") == 0:
            compressed = xfe.add(
                xfe.add(X.bmul(ch("ProgramAddressWeight"), row("Address")),
                        X.bmul(ch("ProgramInstructionWeight"), row("Instruction"))),
                X.bmul(ch("ProgramNextInstructionWeight"), nxt("Instruction")))
            summand = X.mul(
                X.inv(xfe.sub(ch("InstructionLookupIndeterminate"), compressed)),
                xfe.lift(row("LookupMultiplicity")))
            log_der = X.add(log_der, summand)
        if row("IndexInChunk") == 0:
            prep = X.ONE
        prep = xfe.add(X.mul(prep, ch("ProgramAttestationPrepareChunkIndeterminate")),
                       xfe.lift(row("Instruction")))
        if row("IsTablePadding") == 0 and row("IndexInChunk") == tip5.RATE - 1:
            send = xfe.add(X.mul(send, ch("ProgramAttestationSendChunkIndeterminate")),
                           prep)
        _set(aux, i, "program", "PrepareChunkRunningEvaluation", prep)
        _set(aux, i, "program", "SendChunkRunningEvaluation", send)
        if i == h - 1:
            _set(aux, i, "program", "InstructionLookupServerLogDerivative",
                 log_der)


def _instruction_from_processor_row(main, i):
    opcode = int(main[i, M("processor", "CI")])
    name = OPCODE_TO_NAME.get(opcode)
    if name is None:
        return None, None
    arg = None
    if _SPEC[name][1] is not None:
        arg = int(main[i, M("processor", "NIA")])
        if _SPEC[name][1] in ("num_words", "stack_elem"):
            if _SPEC[name][1] == "num_words" and arg not in (1, 2, 3, 4, 5):
                return None, None
            if _SPEC[name][1] == "stack_elem" and arg not in range(16):
                return None, None
    return name, arg


def _extend_processor(main, aux, ch, h):
    def st(i, k):
        return int(main[i, M("processor", f"ST{k}")])

    def pcol(i, name):
        return int(main[i, M("processor", name)])

    # input table eval arg
    acc = X.ONE
    _set(aux, 0, "processor", "InputTableEvalArg", acc)
    for i in range(1, h):
        name, arg = _instruction_from_processor_row(main, i - 1)
        if name == "read_io":
            for k in reversed(range(arg)):
                acc = xfe.add(X.mul(acc, ch("StandardInputIndeterminate")),
                              xfe.lift(st(i, k)))
        _set(aux, i, "processor", "InputTableEvalArg", acc)

    # output table eval arg
    acc = X.ONE
    _set(aux, 0, "processor", "OutputTableEvalArg", acc)
    for i in range(1, h):
        name, arg = _instruction_from_processor_row(main, i - 1)
        if name == "write_io":
            for k in range(arg):
                acc = xfe.add(X.mul(acc, ch("StandardOutputIndeterminate")),
                              xfe.lift(st(i - 1, k)))
        _set(aux, i, "processor", "OutputTableEvalArg", acc)

    # instruction lookup log derivative
    acc = X.ZERO
    for i in range(h):
        if pcol(i, "IsPadding") == 1:
            _set(aux, i, "processor", "InstructionLookupClientLogDerivative", acc)
            continue
        compressed = xfe.add(
            xfe.add(X.bmul(ch("ProgramAddressWeight"), pcol(i, "IP")),
                    X.bmul(ch("ProgramInstructionWeight"), pcol(i, "CI"))),
            X.bmul(ch("ProgramNextInstructionWeight"), pcol(i, "NIA")))
        acc = X.add(acc, X.inv(xfe.sub(ch("InstructionLookupIndeterminate"),
                                       compressed)))
        _set(aux, i, "processor", "InstructionLookupClientLogDerivative", acc)

    # op stack table perm arg
    acc = X.ONE
    _set(aux, 0, "processor", "OpStackTablePermArg", acc)
    for i in range(1, h):
        factor = _op_stack_factor(main, i - 1, i, ch)
        acc = X.mul(acc, factor)
        _set(aux, i, "processor", "OpStackTablePermArg", acc)

    # ram table perm arg
    acc = X.ONE
    _set(aux, 0, "processor", "RamTablePermArg", acc)
    for i in range(1, h):
        f = _ram_factor(main, i - 1, i, ch)
        if f is not None:
            acc = X.mul(acc, f)
        _set(aux, i, "processor", "RamTablePermArg", acc)

    # jump stack perm arg
    acc = X.ONE
    for i in range(h):
        compressed = X.ZERO
        for name, w in (("CLK", "JumpStackClkWeight"), ("CI", "JumpStackCiWeight"),
                        ("JSP", "JumpStackJspWeight"), ("JSO", "JumpStackJsoWeight"),
                        ("JSD", "JumpStackJsdWeight")):
            compressed = xfe.add(compressed, X.bmul(ch(w), pcol(i, name)))
        acc = X.mul(acc, xfe.sub(ch("JumpStackIndeterminate"), compressed))
        _set(aux, i, "processor", "JumpStackTablePermArg", acc)

    # hash input eval arg
    acc = X.ONE
    HASH_OP, MS_OP, MSM_OP = _SPEC["hash"][0], _SPEC["merkle_step"][0], \
        _SPEC["merkle_step_mem"][0]
    for i in range(h):
        ci = pcol(i, "CI")
        if ci in (HASH_OP, MS_OP, MSM_OP):
            if ci == HASH_OP:
                cols = [f"ST{k}" for k in range(10)]
            else:
                left = st(i, 5) % 2 == 0
                if left:
                    cols = [f"ST{k}" for k in range(5)] + \
                           [f"HV{k}" for k in range(5)]
                else:
                    cols = [f"HV{k}" for k in range(5)] + \
                           [f"ST{k}" for k in range(5)]
            compressed = X.ZERO
            for k, cname in enumerate(cols):
                compressed = xfe.add(compressed,
                                     X.bmul(ch(f"StackWeight{k}"), pcol(i, cname)))
            acc = xfe.add(X.mul(acc, ch("HashInputIndeterminate")), compressed)
        _set(aux, i, "processor", "HashInputEvalArg", acc)

    # hash digest eval arg
    acc = X.ONE
    _set(aux, 0, "processor", "HashDigestEvalArg", acc)
    for i in range(1, h):
        prev_ci = pcol(i - 1, "CI")
        if prev_ci in (HASH_OP, MS_OP, MSM_OP):
            compressed = X.ZERO
            for k in range(5):
                compressed = xfe.add(compressed,
                                     X.bmul(ch(f"StackWeight{k}"), st(i, k)))
            acc = xfe.add(X.mul(acc, ch("HashDigestIndeterminate")), compressed)
        _set(aux, i, "processor", "HashDigestEvalArg", acc)

    # sponge eval arg
    acc = X.ONE
    SI, SA, SAM, SS = (_SPEC["sponge_init"][0], _SPEC["sponge_absorb"][0],
                       _SPEC["sponge_absorb_mem"][0], _SPEC["sponge_squeeze"][0])
    _set(aux, 0, "processor", "SpongeEvalArg", acc)
    for i in range(1, h):
        prev_ci = pcol(i - 1, "CI")
        if prev_ci == SI:
            acc = xfe.add(X.mul(acc, ch("SpongeIndeterminate")),
                          X.bmul(ch("HashCIWeight"), SI))
        elif prev_ci == SA:
            compressed = X.ZERO
            for k in range(10):
                compressed = xfe.add(compressed,
                                     X.bmul(ch(f"StackWeight{k}"), st(i - 1, k)))
            acc = xfe.add(xfe.add(X.mul(acc, ch("SpongeIndeterminate")),
                                  X.bmul(ch("HashCIWeight"), SA)), compressed)
        elif prev_ci == SAM:
            elements = ([st(i, k) for k in (1, 2, 3, 4)]
                        + [pcol(i - 1, f"HV{k}") for k in range(6)])
            compressed = X.ZERO
            for k, e in enumerate(elements):
                compressed = xfe.add(compressed, X.bmul(ch(f"StackWeight{k}"), e))
            acc = xfe.add(xfe.add(X.mul(acc, ch("SpongeIndeterminate")),
                                  X.bmul(ch("HashCIWeight"), SA)), compressed)
        elif prev_ci == SS:
            compressed = X.ZERO
            for k in range(10):
                compressed = xfe.add(compressed,
                                     X.bmul(ch(f"StackWeight{k}"), st(i, k)))
            acc = xfe.add(xfe.add(X.mul(acc, ch("SpongeIndeterminate")),
                                  X.bmul(ch("HashCIWeight"), SS)), compressed)
        _set(aux, i, "processor", "SpongeEvalArg", acc)

    # u32 lookup client log derivative
    acc = X.ZERO
    _set(aux, 0, "processor", "U32LookupClientLogDerivative", acc)
    SPLIT, LT, AND, XOR = (_SPEC["split"][0], _SPEC["lt"][0], _SPEC["and"][0],
                           _SPEC["xor"][0])
    LOG2, POW, DIVMOD, POPCNT = (_SPEC["log_2_floor"][0], _SPEC["pow"][0],
                                 _SPEC["div_mod"][0], _SPEC["pop_count"][0])
    inv2 = pow(2, P - 2, P)
    for i in range(1, h):
        prev_ci = pcol(i - 1, "CI")
        summands = []
        if prev_ci == SPLIT:
            compressed = xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i, 0)),
                        X.bmul(ch("U32RhsWeight"), st(i, 1))),
                X.bmul(ch("U32CiWeight"), prev_ci))
            summands.append(compressed)
        elif prev_ci in (LT, AND, POW):
            compressed = xfe.add(xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i - 1, 0)),
                        X.bmul(ch("U32RhsWeight"), st(i - 1, 1))),
                X.bmul(ch("U32CiWeight"), prev_ci)),
                X.bmul(ch("U32ResultWeight"), st(i, 0)))
            summands.append(compressed)
        elif prev_ci == XOR:
            and_result = (st(i - 1, 0) + st(i - 1, 1) - st(i, 0)) * inv2 % P
            compressed = xfe.add(xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i - 1, 0)),
                        X.bmul(ch("U32RhsWeight"), st(i - 1, 1))),
                X.bmul(ch("U32CiWeight"), AND)),
                X.bmul(ch("U32ResultWeight"), and_result))
            summands.append(compressed)
        elif prev_ci in (LOG2, POPCNT):
            compressed = xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i - 1, 0)),
                        X.bmul(ch("U32CiWeight"), prev_ci)),
                X.bmul(ch("U32ResultWeight"), st(i, 0)))
            summands.append(compressed)
        elif prev_ci == DIVMOD:
            lt_check = xfe.add(xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i, 0)),
                        X.bmul(ch("U32RhsWeight"), st(i - 1, 1))),
                X.bmul(ch("U32CiWeight"), LT)),
                X.bmul(ch("U32ResultWeight"), 1))
            range_check = xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i - 1, 0)),
                        X.bmul(ch("U32RhsWeight"), st(i, 1))),
                X.bmul(ch("U32CiWeight"), SPLIT))
            summands.extend([lt_check, range_check])
        elif prev_ci in (_SPEC["merkle_step"][0], _SPEC["merkle_step_mem"][0]):
            compressed = xfe.add(
                xfe.add(X.bmul(ch("U32LhsWeight"), st(i - 1, 5)),
                        X.bmul(ch("U32RhsWeight"), st(i, 5))),
                X.bmul(ch("U32CiWeight"), SPLIT))
            summands.append(compressed)
        for s in summands:
            acc = X.add(acc, X.inv(xfe.sub(ch("U32Indeterminate"), s)))
        _set(aux, i, "processor", "U32LookupClientLogDerivative", acc)

    # clock jump difference lookup server log derivative
    acc = X.ZERO
    for i in range(h):
        mult = pcol(i, "ClockJumpDifferenceLookupMultiplicity")
        if mult != 0:
            inv = X.inv(xfe.sub(ch("ClockJumpDifferenceLookupIndeterminate"),
                                xfe.lift(pcol(i, "CLK"))))
            acc = X.add(acc, X.bmul(inv, mult))
        _set(aux, i, "processor",
             "ClockJumpDifferenceLookupServerLogDerivative", acc)


def _op_stack_factor(main, prev_i, cur_i, ch):
    """processor.rs:598-644 (factor_for_op_stack_table_running_product)."""
    if int(main[cur_i, M("processor", "IsPadding")]) == 1:
        return X.ONE
    name, arg = _instruction_from_processor_row(main, prev_i)
    if name is None:
        return X.ONE
    influence = _op_stack_influence(name, arg)
    row_shorter = prev_i if influence > 0 else cur_i
    delta = abs(influence)
    factor = X.ONE
    for offset in range(delta):
        underflow = int(main[row_shorter, M("processor", f"ST{15 - offset}")])
        pointer = int(main[row_shorter, M("processor", "OpStackPointer")]) + offset
        clk_v = int(main[prev_i, M("processor", "CLK")])
        ib1 = int(main[prev_i, M("processor", "IB1")])
        compressed = xfe.add(xfe.add(
            xfe.add(X.bmul(ch("OpStackClkWeight"), clk_v),
                    X.bmul(ch("OpStackIb1Weight"), ib1)),
            X.bmul(ch("OpStackPointerWeight"), pointer)),
            X.bmul(ch("OpStackFirstUnderflowElementWeight"), underflow))
        factor = X.mul(factor, xfe.sub(ch("OpStackIndeterminate"), compressed))
    return factor


def _op_stack_influence(name, arg):
    inf = _SPEC[name][2]
    if inf is not None:
        return inf
    if name in ("pop", "write_mem", "write_io"):
        return -arg
    return arg


def _ram_factor(main, prev_i, cur_i, ch):
    """processor.rs:646-741 (factor_for_ram_table_running_product)."""
    if int(main[cur_i, M("processor", "IsPadding")]) == 1:
        return None
    name, arg = _instruction_from_processor_row(main, prev_i)
    if name is None:
        return None
    prow = lambda cname: int(main[prev_i, M("processor", cname)])
    crow = lambda cname: int(main[cur_i, M("processor", cname)])
    if name == "read_mem":
        itype = 1
    elif name == "write_mem":
        itype = 0
    elif name in ("sponge_absorb_mem", "merkle_step_mem", "b_horner_step",
                  "x_horner_step"):
        itype = 1
    else:
        return None

    accesses = []
    if name in ("read_mem", "write_mem"):
        longer = crow if name == "read_mem" else prow
        for off in range(arg):
            ram_value = longer(f"ST{off + 1}")
            ptr = longer("ST0")
            if name == "read_mem":
                ptr = (ptr + off + 1) % P
            else:
                ptr = (ptr + off) % P
            accesses.append((ptr, ram_value))
    elif name == "sponge_absorb_mem":
        mem_ptr = prow("ST0")
        vals = [crow("ST1"), crow("ST2"), crow("ST3"), crow("ST4"),
                prow("HV0"), prow("HV1"), prow("HV2"), prow("HV3"),
                prow("HV4"), prow("HV5")]
        accesses = [((mem_ptr + k) % P, v) for k, v in enumerate(vals)]
    elif name == "merkle_step_mem":
        mem_ptr = prow("ST7")
        accesses = [((mem_ptr + k) % P, prow(f"HV{k}")) for k in range(5)]
    elif name == "b_horner_step":
        accesses = [(prow("ST5"), prow("HV0"))]
    elif name == "x_horner_step":
        ptr = prow("ST5")
        accesses = [((ptr - 2) % P, prow("HV0")), ((ptr - 1) % P, prow("HV1")),
                    (ptr, prow("HV2"))]

    clk_v = prow("CLK")
    factor = X.ONE
    for ramp, ramv in accesses:
        compressed = xfe.add(xfe.add(
            xfe.add(X.bmul(ch("RamClkWeight"), clk_v),
                    X.bmul(ch("RamInstructionTypeWeight"), itype)),
            X.bmul(ch("RamPointerWeight"), ramp)),
            X.bmul(ch("RamValueWeight"), ramv))
        factor = X.mul(factor, xfe.sub(ch("RamIndeterminate"), compressed))
    return factor


def _extend_op_stack(main, aux, ch, h):
    acc = X.ONE
    for i in range(h):
        row = lambda name: int(main[i, M("op_stack", name)])
        if row("IB1ShrinkStack") != 2:
            compressed = xfe.add(xfe.add(
                xfe.add(X.bmul(ch("OpStackClkWeight"), row("CLK")),
                        X.bmul(ch("OpStackIb1Weight"), row("IB1ShrinkStack"))),
                X.bmul(ch("OpStackPointerWeight"), row("StackPointer"))),
                X.bmul(ch("OpStackFirstUnderflowElementWeight"),
                       row("FirstUnderflowElement")))
            acc = X.mul(acc, xfe.sub(ch("OpStackIndeterminate"), compressed))
        _set(aux, i, "op_stack", "RunningProductPermArg", acc)

    acc = X.ZERO
    _set(aux, 0, "op_stack", "ClockJumpDifferenceLookupClientLogDerivative", acc)
    for i in range(1, h):
        cur = lambda name: int(main[i, M("op_stack", name)])
        prev = lambda name: int(main[i - 1, M("op_stack", name)])
        if cur("IB1ShrinkStack") == 2:
            break
        if prev("StackPointer") == cur("StackPointer"):
            diff = (cur("CLK") - prev("CLK")) % P
            acc = X.add(acc, X.inv(xfe.sub(
                ch("ClockJumpDifferenceLookupIndeterminate"), xfe.lift(diff))))
        _set(aux, i, "op_stack",
             "ClockJumpDifferenceLookupClientLogDerivative", acc)
    for j in range(i, h):
        _set(aux, j, "op_stack",
             "ClockJumpDifferenceLookupClientLogDerivative", acc)


def _extend_ram(main, aux, ch, h):
    bez = ch("RamTableBezoutRelationIndeterminate")
    rp = xfe.sub(bez, xfe.lift(int(main[0, M("ram", "RamPointer")])))
    fd = X.ONE
    _set(aux, 0, "ram", "RunningProductOfRAMP", rp)
    _set(aux, 0, "ram", "FormalDerivative", fd)
    for i in range(1, h):
        itype = int(main[i, M("ram", "InstructionType")])
        if itype != 2:
            cur_ptr = int(main[i, M("ram", "RamPointer")])
            prev_ptr = int(main[i - 1, M("ram", "RamPointer")])
            if prev_ptr != cur_ptr:
                fd = xfe.add(X.mul(xfe.sub(bez, xfe.lift(cur_ptr)), fd), rp)
                rp = X.mul(rp, xfe.sub(bez, xfe.lift(cur_ptr)))
        _set(aux, i, "ram", "RunningProductOfRAMP", rp)
        _set(aux, i, "ram", "FormalDerivative", fd)

    for colname, main_col in (("BezoutCoefficient0",
                               "BezoutCoefficientPolynomialCoefficient0"),
                              ("BezoutCoefficient1",
                               "BezoutCoefficientPolynomialCoefficient1")):
        acc = xfe.lift(int(main[0, M("ram", main_col)]))
        _set(aux, 0, "ram", colname, acc)
        stop = h
        for i in range(1, h):
            if int(main[i, M("ram", "InstructionType")]) == 2:
                stop = i
                break
            prev_ptr = int(main[i - 1, M("ram", "RamPointer")])
            cur_ptr = int(main[i, M("ram", "RamPointer")])
            if prev_ptr != cur_ptr:
                acc = xfe.add(X.mul(acc, bez),
                              xfe.lift(int(main[i, M("ram", main_col)])))
            _set(aux, i, "ram", colname, acc)
        for i in range(stop, h):
            _set(aux, i, "ram", colname, acc)

    acc = X.ONE
    stop = h
    for i in range(h):
        if int(main[i, M("ram", "InstructionType")]) == 2:
            stop = i
            break
        compressed = xfe.add(xfe.add(
            xfe.add(X.bmul(ch("RamClkWeight"), int(main[i, M("ram", "CLK")])),
                    X.bmul(ch("RamInstructionTypeWeight"),
                           int(main[i, M("ram", "InstructionType")]))),
            X.bmul(ch("RamPointerWeight"), int(main[i, M("ram", "RamPointer")]))),
            X.bmul(ch("RamValueWeight"), int(main[i, M("ram", "RamValue")])))
        acc = X.mul(acc, xfe.sub(ch("RamIndeterminate"), compressed))
        _set(aux, i, "ram", "RunningProductPermArg", acc)
    for i in range(stop, h):
        _set(aux, i, "ram", "RunningProductPermArg", acc)

    acc = X.ZERO
    _set(aux, 0, "ram", "ClockJumpDifferenceLookupClientLogDerivative", acc)
    stop = h
    for i in range(1, h):
        if int(main[i, M("ram", "InstructionType")]) == 2:
            stop = i
            break
        prev_ptr = int(main[i - 1, M("ram", "RamPointer")])
        cur_ptr = int(main[i, M("ram", "RamPointer")])
        if prev_ptr == cur_ptr:
            diff = (int(main[i, M("ram", "CLK")])
                    - int(main[i - 1, M("ram", "CLK")])) % P
            acc = X.add(acc, X.inv(xfe.sub(
                ch("ClockJumpDifferenceLookupIndeterminate"), xfe.lift(diff))))
        _set(aux, i, "ram", "ClockJumpDifferenceLookupClientLogDerivative", acc)
    for i in range(stop, h):
        _set(aux, i, "ram", "ClockJumpDifferenceLookupClientLogDerivative", acc)


def _extend_jump_stack(main, aux, ch, h):
    acc = X.ONE
    for i in range(h):
        row = lambda name: int(main[i, M("jump_stack", name)])
        compressed = X.ZERO
        for name, w in (("CLK", "JumpStackClkWeight"), ("CI", "JumpStackCiWeight"),
                        ("JSP", "JumpStackJspWeight"), ("JSO", "JumpStackJsoWeight"),
                        ("JSD", "JumpStackJsdWeight")):
            compressed = xfe.add(compressed, X.bmul(ch(w), row(name)))
        acc = X.mul(acc, xfe.sub(ch("JumpStackIndeterminate"), compressed))
        _set(aux, i, "jump_stack", "RunningProductPermArg", acc)

    acc = X.ZERO
    _set(aux, 0, "jump_stack",
         "ClockJumpDifferenceLookupClientLogDerivative", acc)
    for i in range(1, h):
        if (main[i - 1, M("jump_stack", "JSP")]
                == main[i, M("jump_stack", "JSP")]):
            diff = (int(main[i, M("jump_stack", "CLK")])
                    - int(main[i - 1, M("jump_stack", "CLK")])) % P
            acc = X.add(acc, X.inv(xfe.sub(
                ch("ClockJumpDifferenceLookupIndeterminate"), xfe.lift(diff))))
        _set(aux, i, "jump_stack",
             "ClockJumpDifferenceLookupClientLogDerivative", acc)


def _extend_hash(main, aux, ch, h):
    from ..fields.bfe import R_INV

    hash_input = X.ONE
    hash_digest = X.ONE
    sponge = X.ONE
    receive = X.ONE
    cascade_accs = {(i, part): X.ZERO for i in range(4)
                    for part in ("Highest", "MidHigh", "MidLow", "Lowest")}

    SI = _SPEC["sponge_init"][0]

    def rate_registers(i):
        out = []
        for k in range(4):
            v = (int(main[i, M("hash", f"State{k}HighestLkIn")]) * (1 << 48)
                 + int(main[i, M("hash", f"State{k}MidHighLkIn")]) * (1 << 32)
                 + int(main[i, M("hash", f"State{k}MidLowLkIn")]) * (1 << 16)
                 + int(main[i, M("hash", f"State{k}LowestLkIn")])) * R_INV % P
            out.append(v)
        for k in range(4, 10):
            out.append(int(main[i, M("hash", f"State{k}")]))
        return out

    def compressed_row(i):
        acc = X.ZERO
        for k, v in enumerate(rate_registers(i)):
            acc = xfe.add(acc, X.bmul(ch(f"StackWeight{k}"), v))
        return acc

    for i in range(h):
        mode = int(main[i, M("hash", "Mode")])
        rn = int(main[i, M("hash", "RoundNumber")])
        ci = int(main[i, M("hash", "CI")])
        is_si = ci == SI

        if mode == 1 and rn == 0:
            chunk = X.ONE
            for v in rate_registers(i):
                chunk = xfe.add(
                    X.mul(chunk, ch("ProgramAttestationPrepareChunkIndeterminate")),
                    xfe.lift(v))
            receive = xfe.add(
                X.mul(receive, ch("ProgramAttestationSendChunkIndeterminate")),
                chunk)
        if mode == 2 and rn == 0 and is_si:
            sponge = xfe.add(X.mul(sponge, ch("SpongeIndeterminate")),
                             X.bmul(ch("HashCIWeight"), ci))
        if mode == 2 and rn == 0 and not is_si:
            sponge = xfe.add(xfe.add(X.mul(sponge, ch("SpongeIndeterminate")),
                                     X.bmul(ch("HashCIWeight"), ci)),
                             compressed_row(i))
        if mode == 3 and rn == 0:
            hash_input = xfe.add(X.mul(hash_input, ch("HashInputIndeterminate")),
                                 compressed_row(i))
        if mode == 3 and rn == tip5.NUM_ROUNDS:
            digest = X.ZERO
            for k, v in enumerate(rate_registers(i)[:5]):
                digest = xfe.add(digest, X.bmul(ch(f"StackWeight{k}"), v))
            hash_digest = xfe.add(
                X.mul(hash_digest, ch("HashDigestIndeterminate")), digest)
        if mode != 0 and rn != tip5.NUM_ROUNDS and not is_si:
            for k in range(4):
                for part in ("Highest", "MidHigh", "MidLow", "Lowest"):
                    lk_in = int(main[i, M("hash", f"State{k}{part}LkIn")])
                    lk_out = int(main[i, M("hash", f"State{k}{part}LkOut")])
                    compressed = xfe.sub(
                        ch("HashCascadeLookupIndeterminate"),
                        xfe.add(X.bmul(ch("HashCascadeLookInWeight"), lk_in),
                                X.bmul(ch("HashCascadeLookOutWeight"), lk_out)))
                    cascade_accs[(k, part)] = X.add(cascade_accs[(k, part)],
                                                    X.inv(compressed))

        _set(aux, i, "hash", "ReceiveChunkRunningEvaluation", receive)
        _set(aux, i, "hash", "HashInputRunningEvaluation", hash_input)
        _set(aux, i, "hash", "HashDigestRunningEvaluation", hash_digest)
        _set(aux, i, "hash", "SpongeRunningEvaluation", sponge)
        for k in range(4):
            for part in ("Highest", "MidHigh", "MidLow", "Lowest"):
                _set(aux, i, "hash", f"CascadeState{k}{part}ClientLogDerivative",
                     cascade_accs[(k, part)])


def _extend_cascade(main, aux, ch, h):
    hash_ld = X.ZERO
    lookup_ld = X.ZERO
    for i in range(h):
        row = lambda name: int(main[i, M("cascade", name)])
        if row("IsPadding") != 1:
            look_in = (row("LookInHi") << 8) + row("LookInLo")
            look_out = (row("LookOutHi") << 8) + row("LookOutLo")
            compressed_hash = xfe.add(
                X.bmul(ch("HashCascadeLookInWeight"), look_in),
                X.bmul(ch("HashCascadeLookOutWeight"), look_out))
            hash_ld = X.add(hash_ld, X.bmul(
                X.inv(xfe.sub(ch("HashCascadeLookupIndeterminate"),
                              compressed_hash)),
                row("LookupMultiplicity")))
            lo = xfe.add(X.bmul(ch("LookupTableInputWeight"), row("LookInLo")),
                         X.bmul(ch("LookupTableOutputWeight"), row("LookOutLo")))
            hi = xfe.add(X.bmul(ch("LookupTableInputWeight"), row("LookInHi")),
                         X.bmul(ch("LookupTableOutputWeight"), row("LookOutHi")))
            lookup_ld = X.add(lookup_ld,
                              X.inv(xfe.sub(ch("CascadeLookupIndeterminate"), lo)))
            lookup_ld = X.add(lookup_ld,
                              X.inv(xfe.sub(ch("CascadeLookupIndeterminate"), hi)))
        _set(aux, i, "cascade", "HashTableServerLogDerivative", hash_ld)
        _set(aux, i, "cascade", "LookupTableClientLogDerivative", lookup_ld)


def _extend_lookup(main, aux, ch, h):
    cascade_ld = X.ZERO
    running_eval = X.ONE
    stop = h
    for i in range(h):
        row = lambda name: int(main[i, M("lookup", name)])
        if row("IsPadding") == 1:
            stop = i
            break
        compressed = xfe.add(X.bmul(ch("LookupTableInputWeight"), row("LookIn")),
                             X.bmul(ch("LookupTableOutputWeight"), row("LookOut")))
        cascade_ld = X.add(cascade_ld, X.bmul(
            X.inv(xfe.sub(ch("CascadeLookupIndeterminate"), compressed)),
            row("LookupMultiplicity")))
        running_eval = xfe.add(
            X.mul(running_eval, ch("LookupTablePublicIndeterminate")),
            xfe.lift(row("LookOut")))
        _set(aux, i, "lookup", "CascadeTableServerLogDerivative", cascade_ld)
        _set(aux, i, "lookup", "PublicEvaluationArgument", running_eval)
    for i in range(stop, h):
        _set(aux, i, "lookup", "CascadeTableServerLogDerivative", cascade_ld)
        _set(aux, i, "lookup", "PublicEvaluationArgument", running_eval)


def _extend_u32(main, aux, ch, h):
    acc = X.ZERO
    for i in range(h):
        row = lambda name: int(main[i, M("u32", name)])
        if row("CopyFlag") == 1:
            compressed = xfe.add(xfe.add(
                xfe.add(X.bmul(ch("U32CiWeight"), row("CI")),
                        X.bmul(ch("U32LhsWeight"), row("LHS"))),
                X.bmul(ch("U32RhsWeight"), row("RHS"))),
                X.bmul(ch("U32ResultWeight"), row("Result")))
            acc = X.add(acc, X.bmul(
                X.inv(xfe.sub(ch("U32Indeterminate"), compressed)),
                row("LookupMultiplicity")))
        _set(aux, i, "u32", "LookupServerLogDerivative", acc)


# ================================================= derived aux columns

def fill_derived_aux_columns(main: np.ndarray, aux: np.ndarray, challenges):
    """Populate the 41 degree-lowering aux columns (vectorized over rows;
    exact object-int math)."""
    air = master_air()
    for phase in ("init", "cons", "tran", "term"):
        subs = air.aux_subs[phase]
        if not subs:
            continue
        for kind, col, rhs in substitution_pairs(subs):
            assert kind == C.AUX
            steps, out_ids = linearize([C.Expr(None, rhs)])
            # All tran-phase derived columns leave the last row ZERO
            # (substitutions.rs:331-368 aux_dual_row_substitutions slices
            # s![0..num_rows-1] unconditionally), NEXT reads or not.
            dual = phase == "tran"
            _eval_aux_sub_vectorized(steps, out_ids[0], main, aux,
                                     challenges, col, dual)


def _eval_aux_sub_vectorized(steps, out_id, main, aux, challenges, out_col,
                             dual):
    """Vectorized-over-rows evaluation of one aux substitution RHS using
    numpy object arrays of exact ints (XFEs as 3 parallel lanes)."""
    h = main.shape[0]

    def lift_main(col_vals):
        z = np.zeros(h, object)
        return (col_vals.astype(object), z, z)

    def shift_next(triple):
        out = []
        for lane in triple:
            rolled = np.roll(lane, -1)
            rolled[-1] = 0
            out.append(rolled)
        return tuple(out)

    env = {}
    for nid, kind, payload in steps:
        if kind == "bconst":
            env[nid] = (payload, 0, 0)
        elif kind == "xconst":
            env[nid] = tuple(payload)
        elif kind == "challenge":
            env[nid] = tuple(challenges[payload])
        elif kind == "input":
            ik, col = payload
            if ik == C.MAIN:
                env[nid] = lift_main(main[:, col])
            elif ik == C.NEXT_MAIN:
                env[nid] = shift_next(lift_main(main[:, col]))
            elif ik == C.AUX:
                env[nid] = tuple(aux[:, col, c].astype(object)
                                 for c in range(3))
            else:
                env[nid] = shift_next(tuple(aux[:, col, c].astype(object)
                                            for c in range(3)))
        else:
            op, lid, rid = payload
            l, r = env[lid], env[rid]
            if op == "+":
                env[nid] = tuple((l[c] + r[c]) % P for c in range(3))
            else:
                env[nid] = _xmul_lanes(l, r)
    out = env[out_id]
    lanes = []
    for c in range(3):
        lane = out[c]
        if not isinstance(lane, np.ndarray):
            lane = np.full(h, lane, object)
        lanes.append(lane)
    if dual:
        for lane in lanes:
            lane[-1] = 0
    aux[:, out_col, :] = np.stack(
        [lane.astype(np.uint64) for lane in lanes], axis=1)


def _xmul_lanes(a, b):
    """XFE multiply over F_p[x]/(x^3 - x + 1) on 3 object lanes."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    d0 = a0 * b0
    d1 = a0 * b1 + a1 * b0
    d2 = a0 * b2 + a1 * b1 + a2 * b0
    d3 = a1 * b2 + a2 * b1
    d4 = a2 * b2
    return ((d0 - d3) % P, (d1 + d3 - d4) % P, (d2 + d4) % P)


def _eval_aux_sub(steps, out_id, main, aux, challenges, out_col, dual):
    h = main.shape[0]
    rows = range(h - 1) if dual else range(h)
    for i in rows:
        j = i + 1 if dual else i
        env = {}
        for nid, kind, payload in steps:
            if kind == "bconst":
                env[nid] = xfe.lift(payload)
            elif kind == "xconst":
                env[nid] = payload
            elif kind == "challenge":
                env[nid] = tuple(challenges[payload])
            elif kind == "input":
                ik, col = payload
                if ik == C.MAIN:
                    env[nid] = xfe.lift(int(main[i, col]))
                elif ik == C.NEXT_MAIN:
                    env[nid] = xfe.lift(int(main[j, col]))
                elif ik == C.AUX:
                    env[nid] = tuple(int(x) for x in aux[i, col])
                else:
                    env[nid] = tuple(int(x) for x in aux[j, col])
            else:
                op, lid, rid = payload
                env[nid] = (xfe.add(env[lid], env[rid]) if op == "+"
                            else xfe.mul(env[lid], env[rid]))
        aux[i, out_col] = np.array(env[out_id], np.uint64)
    if dual:
        aux[h - 1, out_col] = 0
