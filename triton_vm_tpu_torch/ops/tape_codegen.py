"""A row tape (air/compile.py::RowTape) compiled to CUDA C++: the source of
K3 (ops/quotient_cuda.py), built from the repo's sources at first use.

The tape is a constant of the AIR, so instead of an interpreter walking it
(a warp-uniform fetch, a dispatch and 2-6 register-file accesses an
instruction) each instruction becomes one line of straight-line code: its
result a local variable, its operand kinds resolved here, constants
immediates, products by -1 negations. ptxas keeps the values in flight
in registers.

Straight-line code that no warp runs twice waits on instruction fetch
(the whole tape as one kernel, 475K SASS instructions, ran 2.2x slower
than the interpreter on an H100; PERF.md), so the tape is cut into
segments of about `SEGMENT_INSTRUCTIONS` instructions at points of low
liveness (`segments`), one kernel each: every row of a launch runs the
same few thousand instructions. A value read in a later segment than its
own passes through the state array (S, LDX, STX: row-fastest words in
device memory), stored right after it is computed and loaded where a
later segment first reads it; values whose lives do not overlap share a
slot (`_slots`). The state also holds the phase accumulator (`ACC`), the
total (`TOTAL`) and the four zerofier inverses (`ZEROFIERS`), which
csrc/quotient.cu's first kernel computes.

`generate(tape)` returns the segment kernels' text and the state size;
`cuda_sources` wraps them around csrc/quotient.cu as translation units
that nvcc compiles in parallel. The kernels name only what
csrc/quotient.cu defines (fadd, fmul, fneg, xadd, xmul, xscale, xneg,
bxadd, in_main, in_next_main, in_aux, in_next_aux, challenge, weight and
the frame's macros QUOTIENT_SEGMENT, QUOTIENT_ROW_SETUP, S, LDX, STX), so
a host compiler runs them too, with those written in plain C++
(tests/test_torch_quotient_codegen.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..air import compile as aircomp

# Instructions a segment holds, about (the cut moves to the point of lowest
# liveness within half a segment of the target).
SEGMENT_INSTRUCTIONS = 100
# st's fixed words: the phase accumulator (an XFE), the total (an XFE) and
# the zerofier inverses of the four phases
ACC, TOTAL, ZEROFIERS = 0, 3, 6
FIXED_WORDS = 10

_VALUE_OPS = {aircomp.BB_ADD: ("fadd", True), aircomp.BB_MUL: ("fmul", True),
              aircomp.BX_ADD: ("bxadd", False),
              aircomp.BX_MUL: ("xscale", False),
              aircomp.XX_ADD: ("xadd", False),
              aircomp.XX_MUL: ("xmul", False)}
_INPUTS = {aircomp.MAIN: "in_main", aircomp.NEXT_MAIN: "in_next_main",
           aircomp.AUX: "in_aux", aircomp.NEXT_AUX: "in_next_aux",
           aircomp.CHALLENGE: "challenge"}


class Segment(NamedTuple):
    """Instructions start .. stop - 1; the values (by the instruction that
    computes them) it loads from st and those it stores there."""
    start: int
    stop: int
    live_in: tuple
    live_out: tuple


class Generated(NamedTuple):
    functions: tuple  # one kernel a segment, as source text
    state_words: int
    segments: tuple
    slots: dict       # value -> its first word in st


def values(tape):
    """Each instruction's operands as values: (reads, width) where reads[i]
    lists, for instruction i, ("v", j) for the value instruction j computed
    or ("leaf", operand word) for an input or constant, and width[j] is 1
    or 3 for each instruction j that computes a value."""
    current, reads, width = {}, [], {}
    for i, (op, dst, a, b) in enumerate(tape.code.tolist()):
        words = [a] if op in (aircomp.FOLD_B, aircomp.FOLD_X) else (
            [a, b] if op in _VALUE_OPS else [])
        row = []
        for w in words:
            kind, idx = w >> 16, w & 0xFFFF
            row.append(("v", current[kind, idx])
                       if kind in (aircomp.BREG, aircomp.XREG)
                       else ("leaf", w))
        reads.append(row)
        if op in _VALUE_OPS:
            base = _VALUE_OPS[op][1]
            current[aircomp.BREG if base else aircomp.XREG, dst] = i
            width[i] = 1 if base else 3
    return reads, width


def live_words(tape, reads=None, width=None):
    """live[i]: words of values computed before instruction i and read at
    or after it (i = 0 .. n)."""
    if reads is None:
        reads, width = values(tape)
    last = {}
    for i, row in enumerate(reads):
        for kind, v in row:
            if kind == "v":
                last[v] = i
    delta = np.zeros(len(reads) + 1, np.int64)
    for v, w in width.items():
        if v in last:
            delta[v + 1] += w
            delta[last[v] + 1] -= w
    return np.cumsum(delta)


def cut_points(live, n: int, target: int) -> list:
    """Segment boundaries 0 = c_0 < c_1 < ... < c_k = n: each next cut at
    the lowest liveness within [prev + target / 2, prev + 3 target / 2]
    (the earliest such point), the last segment whatever remains below
    3 target / 2."""
    cuts = [0]
    while n - cuts[-1] > target + target // 2:
        lo, hi = cuts[-1] + target // 2, cuts[-1] + target + target // 2
        cuts.append(lo + int(np.argmin(live[lo:hi + 1])))
    cuts.append(n)
    return cuts


def segments(tape, target: int = SEGMENT_INSTRUCTIONS):
    """The tape's segments (`Segment`), cut at points of low liveness."""
    reads, width = values(tape)
    cuts = cut_points(live_words(tape, reads, width), len(reads), target)
    seg_of = np.zeros(len(reads), np.int64)
    for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        seg_of[a:b] = k
    ins = [set() for _ in cuts[:-1]]
    outs = [set() for _ in cuts[:-1]]
    for i, row in enumerate(reads):
        for kind, v in row:
            if kind == "v" and seg_of[v] != seg_of[i]:
                ins[seg_of[i]].add(v)
                outs[seg_of[v]].add(v)
    return tuple(Segment(a, b, tuple(sorted(ins[k])), tuple(sorted(outs[k])))
                 for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])))


def _slots(segs, reads, width):
    """A first word in st for every value that crosses a segment boundary,
    values whose lives (from the instruction that computes it to the last
    instruction that loads it) do not overlap sharing a slot: greedy
    interval colouring, base and XFE values in separate pools. Returns
    (slots, state words)."""
    first_use = {}  # (segment, value) -> the instruction that loads it
    for k, s in enumerate(segs):
        want = set(s.live_in)
        for i in range(s.start, s.stop):
            for kind, v in reads[i]:
                if kind == "v" and v in want:
                    first_use.setdefault((k, v), i)
    end = {}
    for (k, v), i in first_use.items():
        end[v] = max(end.get(v, -1), i)
    pools = {1: [], 3: []}   # width -> [(free from instruction, slot)]
    count = {1: 0, 3: 0}
    slots = {}
    for v in sorted(end):
        w = width[v]
        pool = pools[w]
        pool.sort()
        if pool and pool[0][0] <= v:
            _, slot = pool.pop(0)
        else:
            slot, count[w] = count[w], count[w] + 1
        slots[v] = (w, slot)
        pool.append((end[v], slot))
    base = FIXED_WORDS
    out = {}
    for v, (w, slot) in slots.items():
        out[v] = base + (slot if w == 1 else count[1] + 3 * slot)
    return out, base + count[1] + 3 * count[3]


def _imm(x: int) -> str:
    return f"0x{int(x):016X}ull"


_MINUS_ONE = (1 << 64) - (1 << 32)   # p - 1


def _negated(tape, op, reads):
    """Which operand a product by the constant -1 negates (the AIR writes
    every subtraction so; a negation costs a few instructions, a product
    some thirty), or None."""
    if op not in (aircomp.BB_MUL, aircomp.BX_MUL):
        return None
    for k in ((0, 1) if op == aircomp.BB_MUL else (1,)):
        kind, w = reads[k]
        if (kind == "leaf" and w >> 16 == aircomp.BCONST
                and int(tape.bconsts[w & 0xFFFF]) == _MINUS_ONE):
            return 1 - k
    return None


def generate(tape, target: int = SEGMENT_INSTRUCTIONS) -> Generated:
    """The tape as CUDA code: one kernel a segment, each headed by
    csrc/quotient.cu's QUOTIENT_SEGMENT (its signature) and
    QUOTIENT_ROW_SETUP (the row `r` and the state `st`), the state's words
    read and written through S, LDX and STX."""
    reads, width = values(tape)
    segs = segments(tape, target)
    slots, state_words = _slots(segs, reads, width)
    code = tape.code.tolist()
    out = []
    for k, s in enumerate(segs):
        lines = [f"QUOTIENT_SEGMENT(seg_{k}) {{", "  QUOTIENT_ROW_SETUP();"]
        body = code[s.start:s.stop]
        folds = any(op in (aircomp.FOLD_B, aircomp.FOLD_X, aircomp.PHASE_END)
                    for op, *_ in body)
        if folds:
            lines.append(f"  Xfe acc = LDX({ACC});")
        loaded = set()
        live_out = set(s.live_out)

        def name(v):
            return f"{'b' if width[v] == 1 else 'x'}{v}"

        def opnd(item):
            kind, v = item
            if kind == "v":
                if v < s.start and v not in loaded:
                    loaded.add(v)
                    lines.append(
                        f"  const uint64_t {name(v)} = S({slots[v]});"
                        if width[v] == 1 else
                        f"  const Xfe {name(v)} = LDX({slots[v]});")
                return name(v)
            kind, idx = v >> 16, v & 0xFFFF
            if kind == aircomp.BCONST:
                return _imm(tape.bconsts[idx])
            if kind == aircomp.XCONST:
                c = tape.xconsts[idx]
                return f"Xfe{{{{{_imm(c[0])}, {_imm(c[1])}, {_imm(c[2])}}}}}"
            return f"{_INPUTS[kind]}(r, {idx})"

        for i in range(s.start, s.stop):
            op, dst = code[i][0], code[i][1]
            args = [opnd(item) for item in reads[i]]
            if op in _VALUE_OPS:
                fn, base = _VALUE_OPS[op]
                ty = "uint64_t" if base else "Xfe"
                neg = _negated(tape, op, reads[i])
                expr = (f"{fn}({args[0]}, {args[1]})" if neg is None else
                        f"{'fneg' if base else 'xneg'}({args[neg]})")
                lines.append(f"  const {ty} {name(i)} = {expr};")
                if i in live_out:
                    lines.append(f"  S({slots[i]}) = {name(i)};" if base
                                 else f"  STX({slots[i]}, {name(i)});")
            elif op == aircomp.FOLD_B:
                lines.append(f"  acc = xadd(acc, xscale(weight(r, {dst}), "
                             f"{args[0]}));")
            elif op == aircomp.FOLD_X:
                lines.append(f"  acc = xadd(acc, xmul(weight(r, {dst}), "
                             f"{args[0]}));")
            else:
                assert op == aircomp.PHASE_END
                lines.append(
                    f"  STX({TOTAL}, xadd(LDX({TOTAL}), "
                    f"xscale(acc, S({ZEROFIERS + dst}))));")
                lines.append("  acc = Xfe{{0, 0, 0}};")
        if folds:
            lines.append(f"  STX({ACC}, acc);")
        lines.append("}")
        out.append("\n".join(lines))
    return Generated(tuple(out), state_words, segs, slots)


_HEADER = ("// Generated by triton_vm_tpu_torch/ops/tape_codegen.py from the "
           "row tape;\n// do not edit.\n")


def _head(gen) -> str:
    return _HEADER + f"#define QUOTIENT_STATE_WORDS {gen.state_words}\n"


def _table(gen) -> str:
    """The kernel unit's list of the segment kernels, in order, which
    csrc/quotient.cu's launcher runs."""
    k = len(gen.functions)
    decls = "".join(f"QUOTIENT_SEGMENT(seg_{j});\n" for j in range(k))
    return (decls + f"extern const int kQuotientSegments = {k};\n"
            "extern const void* const kQuotientSegmentKernels[] = {\n"
            + "".join(f"    reinterpret_cast<const void*>(seg_{j}),\n"
                      for j in range(k)) + "};\n")


def cuda_sources(tape, target: int = SEGMENT_INSTRUCTIONS,
                 parts: int = 8) -> list:
    """The kernel as 1 + `parts` translation units for separate
    compilation (nvcc -rdc), so that nvcc compiles the segments in
    parallel processes: the first holds csrc/quotient.cu's frame and
    launcher and the segments' table, each other a run of consecutive
    segments with csrc/quotient.cu's helpers only
    (QUOTIENT_SEGMENTS_ONLY)."""
    gen = generate(tape, target)
    head = _head(gen)
    k = len(gen.functions)
    out = [head + '#include "quotient.cu"\n\n' + _table(gen)]
    cuts = [round(j * k / parts) for j in range(parts + 1)]
    for a, b in zip(cuts[:-1], cuts[1:]):
        if a < b:
            out.append(head + "#define QUOTIENT_SEGMENTS_ONLY\n"
                       '#include "quotient.cu"\n\n'
                       + "\n\n".join(gen.functions[a:b]) + "\n")
    return out
