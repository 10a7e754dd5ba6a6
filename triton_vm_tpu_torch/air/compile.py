"""AIR-to-device compiler: turn linearized constraint DAGs into batched
level-parallel tapes executed on tensors.

This replaces the reference's build-time Rust codegen
(triton-constraint-builder/src/codegen.rs) with a runtime
compiler whose tapes run as batched torch field ops:

- All ~3.3k multiplications of the transition AIR are grouped by
  (dependency depth, operand types, op) so each group executes as ONE
  batched vector op over all rows and all group members at once —
  arithmetic intensity comes from batching (group_width x num_rows
  lanes), not from scalar codegen.
- Values live in two register banks (base field and extension field),
  int64 tensors (num_slots, num_rows) and (3, num_slots, num_rows).
  Slots are liveness-recycled so the banks stay a few thousand slots wide
  even for the ~7.6k-step transition tape.
- Execution is a sequence of gather -> batched-field-op -> scatter
  steps, one per (level, signature) group; there is no per-node dispatch.

Used by the prover's quotient computation (stark/prover.py); the exact
host evaluator in evaluate.py is its oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from . import circuit as C

class Tape:
    """Compiled form of one (steps, out_ids) constraint list.

    Attributes:
      rb, rx: base/xfe bank sizes (slots).
      base_init, x_init: numpy uint64 arrays (rb,) / (3, rx) holding
        compile-time constants (everything else is 0).
      *_slots / *_cols: parallel int32 arrays describing runtime loads of
        main/next_main columns (base bank), aux/next_aux columns and
        challenges (xfe bank).
      levels: list of {sig: (lhs, rhs, dst) int32 arrays}.
      out_banks, out_slots: per-output bank flag (True=base) and slot.
    """

    def __init__(self):
        self.rb = 0
        self.rx = 0
        self.base_init = None
        self.x_init = None
        self.main_slots = self.main_cols = None
        self.next_main_slots = self.next_main_cols = None
        self.aux_slots = self.aux_cols = None
        self.next_aux_slots = self.next_aux_cols = None
        self.challenge_slots = self.challenge_ids = None
        self.levels = []
        self.out_banks = None
        self.out_slots = None
        self.num_binops = 0

    @property
    def num_levels(self):
        return len(self.levels)


def compile_tape(steps, out_ids) -> Tape:
    """Schedule + register-allocate the linearized DAG into a Tape."""
    kinds = {}
    payloads = {}
    for nid, kind, payload in steps:
        kinds[nid] = kind
        payloads[nid] = payload

    # --- typing (base vs xfe) and ASAP levels ---------------------------
    is_base = {}
    level = {}
    for nid, kind, payload in steps:
        if kind == "bconst":
            is_base[nid], level[nid] = True, 0
        elif kind in ("xconst", "challenge"):
            is_base[nid], level[nid] = False, 0
        elif kind == "input":
            is_base[nid] = payload[0] in (C.MAIN, C.NEXT_MAIN)
            level[nid] = 0
        else:
            _, lid, rid = payload
            is_base[nid] = is_base[lid] and is_base[rid]
            level[nid] = 1 + max(level[lid], level[rid])

    # --- level packing ---------------------------------------------------
    # Re-schedule with per-signature width caps ~= count/levels: ops wait
    # for capacity, trading a few extra levels for near-uniform group
    # widths. Pure schedule change — identical values, bit-identical
    # outputs.
    def _sig_of(payload):
        op, lid, rid = payload
        lb, rb = is_base[lid], is_base[rid]
        if lb and rb:
            return "bb" + op
        if not lb and not rb:
            return "xx" + op
        return "bx" + op

    crit = max(level.values()) if level else 0
    counts: dict[str, int] = {}
    for nid, kind, payload in steps:
        if kind == "binop":
            s = _sig_of(payload)
            counts[s] = counts.get(s, 0) + 1
    budget = max(int(crit * 1.3), 1)
    caps = {s: max(1, -(-c // budget)) for s, c in counts.items()}

    deps_left = {}
    consumers: dict[int, list] = {}
    ready_at: dict[int, list] = {}  # level -> [(sig, nid)]
    for nid, kind, payload in steps:
        if kind != "binop":
            continue
        _, lid, rid = payload
        nd = sum(1 for d in (lid, rid) if kinds[d] == "binop")
        deps_left[nid] = nd
        for d in (lid, rid):
            if kinds[d] == "binop":
                consumers.setdefault(d, []).append(nid)
        if nd == 0:
            ready_at.setdefault(1, []).append((_sig_of(payload), nid))

    remaining = len(deps_left)
    waiting: dict[str, list] = {}
    lvl = 1
    while remaining:
        for sig, nid in ready_at.pop(lvl, []):
            waiting.setdefault(sig, []).append(nid)
        used = {}
        for sig, queue in waiting.items():
            take = min(caps[sig], len(queue))
            for nid in queue[:take]:
                level[nid] = lvl
                remaining -= 1
                for c in consumers.get(nid, []):
                    deps_left[c] -= 1
                    if deps_left[c] == 0:
                        ready_at.setdefault(lvl + 1, []).append(
                            (_sig_of(payloads[c]), c))
            used[sig] = take
        for sig, take in used.items():
            waiting[sig] = waiting[sig][take:]
        lvl += 1

    out_set = set(out_ids)
    # --- liveness: last level at which each node is read ----------------
    last_use = {nid: (1 << 60) if nid in out_set else -1 for nid in kinds}
    for nid, kind, payload in steps:
        if kind == "binop":
            _, lid, rid = payload
            last_use[lid] = max(last_use[lid], level[nid])
            last_use[rid] = max(last_use[rid], level[nid])

    # --- slot allocation -------------------------------------------------
    slot = {}
    next_slot = {True: 0, False: 0}
    free = {True: [], False: []}  # (available_from_level, slot)

    def alloc(nid, lvl):
        bank = is_base[nid]
        pool = free[bank]
        for i, (avail, s) in enumerate(pool):
            if avail <= lvl:
                pool.pop(i)
                slot[nid] = s
                return s
        s = next_slot[bank]
        next_slot[bank] += 1
        slot[nid] = s
        return s

    # leaves first (level 0, never freed if used; consts/loads pinned)
    for nid, kind, payload in steps:
        if kind != "binop":
            alloc(nid, 0)

    tape = Tape()
    freed = set()
    # group binops by level then signature
    by_level: dict[int, dict[str, list]] = {}
    for nid, kind, payload in steps:
        if kind != "binop":
            continue
        op, lid, rid = payload
        lvl = level[nid]
        lb, rb = is_base[lid], is_base[rid]
        if lb and rb:
            sig = "bb" + op
        elif not lb and not rb:
            sig = "xx" + op
        else:
            sig = "bx" + op
            if is_base[lid]:  # normalize: xfe operand on the left
                lid, rid = rid, lid
        d = alloc(nid, lvl)
        by_level.setdefault(lvl, {}).setdefault(sig, []).append(
            (slot[lid], slot[rid], d))
        # free operands whose last use is this level (available next level)
        for opnd in (lid, rid):
            if (last_use[opnd] == lvl and kinds[opnd] == "binop"
                    and opnd not in freed):
                freed.add(opnd)
                free[is_base[opnd]].append((lvl + 1, slot[opnd]))
        if last_use[nid] == -1 and nid not in freed:  # dead code
            freed.add(nid)
            free[is_base[nid]].append((lvl + 1, d))
        tape.num_binops += 1

    for lvl in sorted(by_level):
        tape.levels.append({
            sig: tuple(np.array(col, np.int32)
                       for col in zip(*triples))
            for sig, triples in by_level[lvl].items()})

    tape.rb = max(next_slot[True], 1)
    tape.rx = max(next_slot[False], 1)

    # --- constant init planes + load tables ------------------------------
    tape.base_init = np.zeros(tape.rb, np.uint64)
    tape.x_init = np.zeros((3, tape.rx), np.uint64)
    loads = {k: [] for k in ("main", "next_main", "aux", "next_aux", "ch")}
    for nid, kind, payload in steps:
        if kind == "bconst":
            tape.base_init[slot[nid]] = payload
        elif kind == "xconst":
            tape.x_init[:, slot[nid]] = payload
        elif kind == "challenge":
            loads["ch"].append((slot[nid], payload))
        elif kind == "input":
            ik, col = payload
            key = {C.MAIN: "main", C.NEXT_MAIN: "next_main",
                   C.AUX: "aux", C.NEXT_AUX: "next_aux"}[ik]
            loads[key].append((slot[nid], col))

    def cols2(pairs):
        if not pairs:
            return (np.zeros(0, np.int32),) * 2
        s, c = zip(*pairs)
        return np.array(s, np.int32), np.array(c, np.int32)

    tape.main_slots, tape.main_cols = cols2(loads["main"])
    tape.next_main_slots, tape.next_main_cols = cols2(loads["next_main"])
    tape.aux_slots, tape.aux_cols = cols2(loads["aux"])
    tape.next_aux_slots, tape.next_aux_cols = cols2(loads["next_aux"])
    tape.challenge_slots, tape.challenge_ids = cols2(loads["ch"])

    tape.out_banks = np.array([is_base[i] for i in out_ids])
    tape.out_slots = np.array([slot[i] for i in out_ids], np.int32)
    return tape


# ------------------------------------------------------------- execution

_INDEX_CACHE: dict = {}


def _tape_indices(tape: Tape, device):
    """The tape's slot/column tables as int64 tensors on `device`
    (built once per tape and device)."""
    key = (id(tape), str(device))
    hit = _INDEX_CACHE.get(key)
    if hit is not None and hit[0] is tape:
        return hit[1]
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    levels = [{sig: tuple(t(c) for c in cols) for sig, cols in lvl.items()}
              for lvl in tape.levels]
    base_pos = np.nonzero(tape.out_banks)[0]
    x_pos = np.nonzero(~tape.out_banks)[0]
    idx = {
        "main": (t(tape.main_slots), t(tape.main_cols)),
        "next_main": (t(tape.next_main_slots), t(tape.next_main_cols)),
        "aux": (t(tape.aux_slots), t(tape.aux_cols)),
        "next_aux": (t(tape.next_aux_slots), t(tape.next_aux_cols)),
        "ch": (t(tape.challenge_slots), t(tape.challenge_ids)),
        "levels": levels,
        "out_base": (t(base_pos), t(tape.out_slots[base_pos])),
        "out_x": (t(x_pos), t(tape.out_slots[x_pos])),
    }
    _INDEX_CACHE[key] = (tape, idx)
    return idx


def run_tape_scan(tape: Tape, main, aux, challenges, next_main=None,
                  next_aux=None):
    """Execute a compiled tape over a batch of rows.

    main/next_main: int64 (num_main_cols, B); aux/next_aux: XFE
    (3, num_aux_cols, B); challenges: XFE (3, num_challenges). Returns XFE
    (3, num_outputs, B), base-field outputs lifted into the extension.

    Each level's groups read the banks first and write after, one batched
    field op per (level, signature) group over all rows and all group
    members."""
    import torch

    from ..ops import gf, gfx

    dev = main.device
    B = main.shape[-1]
    ix = _tape_indices(tape, dev)
    Vb = gf.from_u64(tape.base_init, dev)[:, None].repeat(1, B)
    Vx = gf.from_u64(tape.x_init, dev)[:, :, None].repeat(1, 1, B)

    for key, src in (("main", main), ("next_main", next_main)):
        slots, cols = ix[key]
        if slots.numel():
            Vb[slots] = src.index_select(0, cols)
    for key, src in (("aux", aux), ("next_aux", next_aux)):
        slots, cols = ix[key]
        if slots.numel():
            Vx[:, slots] = src.index_select(1, cols)
    slots, ids = ix["ch"]
    if slots.numel():
        Vx[:, slots] = challenges.index_select(1, ids)[:, :, None]

    for groups in ix["levels"]:
        writes = []
        for sig, (li, ri, di) in groups.items():
            if sig[:2] == "bb":
                l, r = Vb.index_select(0, li), Vb.index_select(0, ri)
                res = gf.add(l, r) if sig[2] == "+" else gf.mul(l, r)
                writes.append((Vb, di, res))
                continue
            l = Vx.index_select(1, li)  # normalized: xfe operand left
            if sig[:2] == "bx":
                r = Vb.index_select(0, ri)
                if sig[2] == "+":
                    res = l.clone()
                    res[0] = gf.add(l[0], r)
                else:
                    res = gfx.bfe_mul(l, r)
            else:
                r = Vx.index_select(1, ri)
                res = gfx.add(l, r) if sig[2] == "+" else gfx.mul(l, r)
            writes.append((Vx, di, res))
        for bank, di, res in writes:
            if bank is Vb:
                Vb[di] = res
            else:
                Vx[:, di] = res

    out = torch.zeros((3, len(tape.out_slots), B), dtype=torch.int64,
                      device=dev)
    pos, slots = ix["out_base"]
    out[0, pos] = Vb.index_select(0, slots)
    pos, slots = ix["out_x"]
    out[:, pos] = Vx.index_select(1, slots)
    return out


@functools.lru_cache(maxsize=None)
def phase_tape(phase: str) -> Tape:
    """Compiled tape for one constraint phase of the master AIR."""
    from .evaluate import linearize
    from .master import master_air

    steps, out_ids = linearize(master_air().constraints[phase])
    return compile_tape(steps, out_ids)


# ------------------------------------------------------------- row tapes
#
# A row tape is the same DAG as a sequential program for one row at a
# time, the form K3 (csrc/quotient.cu) runs: one instruction after another
# in `linearize` order, each output folded into its phase's accumulator as
# soon as it is produced, registers recycled at their last read. The live
# set is a few hundred words a row, where the level tape's banks hold
# thousands.

# Operand kinds: the high 16 bits of an operand word, the index the low 16.
BREG, XREG, MAIN, NEXT_MAIN, AUX, NEXT_AUX, CHALLENGE, BCONST, XCONST = \
    range(9)
_INPUT_KIND = {C.MAIN: MAIN, C.NEXT_MAIN: NEXT_MAIN, C.AUX: AUX,
               C.NEXT_AUX: NEXT_AUX}
# Instructions, rows (op, dst, a, b) of int32. The binops write register
# dst of their result's file; an XFE-by-base op takes the XFE operand as
# a. FOLD_B / FOLD_X add weight[dst] * a to the phase's accumulator;
# PHASE_END adds the accumulator times phase dst's zerofier inverse to the
# total and clears the accumulator.
BB_ADD, BB_MUL, BX_ADD, BX_MUL, XX_ADD, XX_MUL, FOLD_B, FOLD_X, PHASE_END = \
    range(9)
_BINOPS = {"bb+": BB_ADD, "bb*": BB_MUL, "bx+": BX_ADD, "bx*": BX_MUL,
           "xx+": XX_ADD, "xx*": XX_MUL}


def operand(kind: int, index: int) -> int:
    assert 0 <= index < 1 << 16
    return kind << 16 | index


class RowTape:
    """A row tape (see above).

    Attributes:
      code: int32 (n, 4) instructions (op, dst, a, b).
      bconsts: uint64 (nbc,) and xconsts: uint64 (nxc, 3), the constants
        that BCONST and XCONST operands index.
      num_bregs, num_xregs: registers of each file the code uses.
      num_weights: the outputs, each with its weight index.
      num_phases: PHASE_END instructions, phases 0 .. num_phases - 1.
    """

    def __init__(self, code, bconsts, xconsts, num_bregs, num_xregs,
                 num_weights, num_phases):
        self.code = code
        self.bconsts = bconsts
        self.xconsts = xconsts
        self.num_bregs = num_bregs
        self.num_xregs = num_xregs
        self.num_weights = num_weights
        self.num_phases = num_phases

    @property
    def reg_words(self) -> int:
        """Words of register file a row needs: a base register is one
        word, an XFE register three."""
        return self.num_bregs + 3 * self.num_xregs

    def operands(self):
        """Every operand word the code reads: a of the binops and folds,
        b of the binops."""
        op = self.code[:, 0]
        return np.concatenate([self.code[op <= FOLD_X, 2],
                               self.code[op <= XX_MUL, 3]])


def compile_row_tape(steps, out_ids) -> RowTape:
    """The linearized DAG (`linearize`'s steps and outputs) as a row tape
    of one phase: output k folded with weight k, then PHASE_END 0."""
    if len(set(out_ids)) != len(out_ids):
        raise ValueError("an output appears twice in out_ids")
    kinds, payloads, is_base = {}, {}, {}
    for nid, kind, payload in steps:
        kinds[nid], payloads[nid] = kind, payload
        if kind == "bconst":
            is_base[nid] = True
        elif kind in ("xconst", "challenge"):
            is_base[nid] = False
        elif kind == "input":
            is_base[nid] = payload[0] in (C.MAIN, C.NEXT_MAIN)
        else:
            _, lid, rid = payload
            is_base[nid] = is_base[lid] and is_base[rid]
    weight_of = {nid: k for k, nid in enumerate(out_ids)}

    # the instruction after which each binop's value is read no more; its
    # fold comes right after it
    binops = [nid for nid, kind, _ in steps if kind == "binop"]
    last = {nid: i for i, nid in enumerate(binops)}
    for i, nid in enumerate(binops):
        for d in payloads[nid][1:]:
            if kinds[d] == "binop":
                last[d] = i

    bconsts, xconsts = {}, {}
    code = []

    def leaf(nid):
        kind, payload = kinds[nid], payloads[nid]
        if kind == "bconst":
            return operand(BCONST, bconsts.setdefault(payload,
                                                      len(bconsts)))
        if kind == "xconst":
            return operand(XCONST, xconsts.setdefault(tuple(payload),
                                                      len(xconsts)))
        if kind == "challenge":
            return operand(CHALLENGE, payload)
        return operand(_INPUT_KIND[payload[0]], payload[1])

    def fold(nid, opnd):
        code.append((FOLD_B if is_base[nid] else FOLD_X, weight_of[nid],
                     opnd, 0))

    # outputs that are inputs or constants: no binop produces them
    for nid in out_ids:
        if kinds[nid] != "binop":
            fold(nid, leaf(nid))

    reg = {}
    free = {True: [], False: []}
    used = {True: 0, False: 0}
    for i, nid in enumerate(binops):
        op, lid, rid = payloads[nid]
        lb, rb = is_base[lid], is_base[rid]
        sig = ("bb" if lb and rb else "xx" if not (lb or rb) else "bx") + op
        if sig[:2] == "bx" and lb:  # normalize: xfe operand on the left
            lid, rid = rid, lid
        opnds = [operand(BREG if is_base[d] else XREG, reg[d])
                 if kinds[d] == "binop" else leaf(d) for d in (lid, rid)]
        # operands read for the last time free their registers first, so
        # the result may take one: the kernel reads before it writes (an
        # operand that is an output was folded when it was produced)
        for d in {lid, rid}:
            if kinds[d] == "binop" and last[d] == i:
                free[is_base[d]].append(reg.pop(d))
        bank = is_base[nid]
        if free[bank]:
            reg[nid] = free[bank].pop()
        else:
            reg[nid] = used[bank]
            used[bank] += 1
        code.append((_BINOPS[sig], reg[nid], *opnds))
        if nid in weight_of:
            fold(nid, operand(BREG if bank else XREG, reg[nid]))
        if last[nid] == i:  # an output that no binop reads
            free[bank].append(reg.pop(nid))
    code.append((PHASE_END, 0, 0, 0))

    xc = np.zeros((len(xconsts), 3), np.uint64)
    for v, j in xconsts.items():
        xc[j] = v
    return RowTape(np.array(code, np.int32).reshape(-1, 4),
                   np.array(list(bconsts), np.uint64), xc, used[True],
                   used[False], len(out_ids), 1)


def join_row_tapes(tapes) -> RowTape:
    """Row tapes run one after another as phases 0, 1, ... of one tape:
    each tape's weights, constants and phase follow the previous ones'.
    The register files are shared."""
    codes, bconsts, xconsts = [], [], []
    nw = nbc = nxc = nph = 0
    for t in tapes:
        code = t.code.copy()
        op, dst = code[:, 0], code[:, 1]
        dst[(op == FOLD_B) | (op == FOLD_X)] += nw
        dst[op == PHASE_END] += nph
        for col, reads in ((2, op <= FOLD_X), (3, op <= XX_MUL)):
            kind = code[:, col] >> 16
            code[reads & (kind == BCONST), col] += nbc
            code[reads & (kind == XCONST), col] += nxc
        codes.append(code)
        bconsts.append(t.bconsts)
        xconsts.append(t.xconsts)
        nw += t.num_weights
        nbc += len(t.bconsts)
        nxc += len(t.xconsts)
        nph += t.num_phases
    return RowTape(np.concatenate(codes), np.concatenate(bconsts),
                   np.concatenate(xconsts).reshape(-1, 3),
                   max(t.num_bregs for t in tapes),
                   max(t.num_xregs for t in tapes), nw, nph)


PHASES = ("init", "cons", "tran", "term")


@functools.lru_cache(maxsize=None)
def quotient_row_tape() -> RowTape:
    """The master AIR's four phases (PHASES) as one row tape: weight k is
    the k-th constraint of all phases in that order."""
    from .evaluate import linearize
    from .master import master_air

    air = master_air()
    return join_row_tapes([compile_row_tape(*linearize(air.constraints[ph]))
                           for ph in PHASES])
