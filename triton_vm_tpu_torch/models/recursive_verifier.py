"""Recursive-verifier workload: STARK verification inside Triton VM.

BASELINE config 5's workload is "verify a proof inside the VM" — the
reference's design goal behind fast verification (README.md:46-76) and
the cost anchor for AIR evaluation in TASM
(specification/src/arithmetization-overview.md:92-99: 33,998 processor
rows, static memory layout). The reference repo itself contains only
the constraint-evaluator codegen (triton-constraint-builder); the full
TASM verifier lives in the external tasm-lib "recufier". This module
generates the equivalent verifier-core program from OUR codegen
(air/tasm.py) and runs it in the repo's own VM against a real proof:

  1. zerofier computation + full static AIR-constraint evaluation at
     the out-of-domain point (the 33,998-row anchor section),
  2. the quotient linear combination + out-of-domain quotient-segment
     consistency check (stark.rs verify: ood_quotient_value ==
     sum alpha^i q_p_i + sum (zeta*alpha)^i q_r_i), asserted in-VM,
  3. per-query checks: Tip5 row hashing (sponge_absorb_mem), Merkle
     root walks (merkle_step over divined sibling paths), and the DEEP
     combination-codeword update, asserted against the revealed value.

The host lays the FS-derived scalars (challenges, weights, OOD point)
into RAM, as tasm-lib's recufier receives them through its static memory
layout; the `fs_replay` section replays the Fiat-Shamir transcript
in-VM and asserts every squeeze against the host verifier's record, so
those scalars are pinned. The arithmetic verification work — AIR
evaluation, quotient consistency, row hashing, Merkle walks, DEEP
updates — all happens inside the VM and `assert`s, so a wrong proof word
makes the program crash.

The counterpart of `triton_vm_tpu.models.recursive_verifier`: the same
memory map, sections and program text, over this package's verifier
(which checks the proof on the Stark's device, a CUDA card unless the
caller asks for the CPU) and VM (tests/test_torch_recursive_verifier.py).

Usage:
    rv = build(claim, proof, stark, num_queries=2)
    report = rv.run()          # executes in the VM; raises on reject
    report["cycles"]           # per-section processor cycle counts
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..air import tasm
from ..crypto import merkle
from ..fields import bfe
from ..fields.bfe import P
from ..stark.prover import NUM_QUOTIENT_SEGMENTS, ZETA, Verifier
from ..vm.machine import VM, NonDeterminism, PublicInput
from ..isa.program import Program

# ------------------------------------------------------------- memory map
CURR_MAIN = 1 << 40
CURR_AUX = CURR_MAIN + 3 * 379 + 16
NEXT_MAIN = CURR_AUX + 3 * 91 + 16
NEXT_AUX = NEXT_MAIN + 3 * 379 + 16
CHALLENGES = NEXT_AUX + 3 * 91 + 16
FREE_PAGE = 1 << 44
OUT_PTR = FREE_PAGE + tasm.OUT_ARRAY_OFFSET * tasm.EXTENSION_DEGREE

QW = 1 << 45                       # 604 quotient weights (XFE)
OODQ_P = QW + 3 * 604 + 16         # OOD quotient segments, current row
OODQ_R = OODQ_P + 3 * NUM_QUOTIENT_SEGMENTS + 16
ALPHA = OODQ_R + 3 * NUM_QUOTIENT_SEGMENTS + 16   # OOD point (XFE)
W_MAIN = 1 << 46                   # combination weights
W_AUX = W_MAIN + 3 * 379 + 16
W_QS = W_AUX + 3 * 91 + 16
W_DEEP = W_QS + 3 * (NUM_QUOTIENT_SEGMENTS + 1) + 16
ROOTS = W_DEEP + 3 * 4 + 16        # main/aux/quot roots, 5 words each

SCR = 1 << 47                      # scratch page
SCR_ZI = SCR                       # 4 zerofier inverses (XFE)
SCR_PT = SCR + 64                  # 4 DEEP points alpha, w*alpha, a^k, (za)^k
SCR_ZA = SCR + 128                 # zeta*alpha
SCR_OOD = SCR + 160                # ood_curr, ood_next, ood_p_val, ood_r_val
SCR_DIG = SCR + 256                # row digest staging (5 words)
SCR_VAL = SCR + 288                # main_aux_elem, quot_p, quot_r (XFE)

QDATA = 1 << 48                    # per-query block (stride below)
Q_STRIDE = 1 << 12


def _q_main(q):  # 379 row words + sponge padding to 390
    return QDATA + q * Q_STRIDE


def _q_aux(q):   # 273 words + padding to 280
    return _q_main(q) + 392


def _q_quot(q):  # 12 words + padding to 20
    return _q_aux(q) + 284


def _q_reveal(q):  # revealed combination value (XFE) + domain point x_i
    return _q_quot(q) + 24


# ---------------------------------------------------------- TASM helpers

def _ld_xfe(addr):
    return [f"push {(addr + 2) % P}", "read_mem 3", "pop 1"]


def _ld_bfe(addr):
    return [f"push {addr % P}", "read_mem 1", "pop 1"]


def _st_xfe(addr):
    return [f"push {addr % P}", "write_mem 3", "pop 1"]


def _push_xfe_zero():
    return ["push 0", "push 0", "push 0"]


def _xfe_square():
    return ["dup 2", "dup 2", "dup 2", "xx_mul"]


def _assert_xfe_eq():
    """Stack: _ y2 y1 y0 x2 x1 x0 -> _ ; asserts x == y."""
    code = [f"push {P - 1}", "xb_mul", "xx_add"]  # y - x
    for _ in range(3):
        code += ["push 0", "eq", "assert"]
    return code


def _zerofier_section(h: int, trace_gen: int):
    """Compute init/cons/tran/term zerofier inverses at alpha (from RAM)
    and store them at SCR_ZI (+0, +3, +6, +9)."""
    neg_one = P - 1
    neg_g_inv = P - bfe.inv(trace_gen)
    code = []
    # init_zi = 1 / (alpha - 1)
    code += _ld_xfe(ALPHA)
    code += ["push 0", "push 0", f"push {neg_one}", "xx_add", "x_invert"]
    code += _st_xfe(SCR_ZI + 0)
    # cons_zi = 1 / (alpha^h - 1); h is a power of two -> log2 squarings
    code += _ld_xfe(ALPHA)
    for _ in range(h.bit_length() - 1):
        code += _xfe_square()
    code += ["push 0", "push 0", f"push {neg_one}", "xx_add", "x_invert"]
    code += _st_xfe(SCR_ZI + 3)
    # except_last = alpha - 1/g ; term_zi = 1/except_last ;
    # tran_zi = except_last * cons_zi
    code += _ld_xfe(ALPHA)
    code += ["push 0", "push 0", f"push {neg_g_inv}", "xx_add"]
    code += ["dup 2", "dup 2", "dup 2", "x_invert"]
    code += _st_xfe(SCR_ZI + 9)                      # term_zi
    code += _ld_xfe(SCR_ZI + 3) + ["xx_mul"]
    code += _st_xfe(SCR_ZI + 6)                      # tran_zi
    return code


def _quotient_fold_section(phase_counts):
    """After the AIR evaluator: fold the 604 evaluated constraints with
    the quotient weights and zerofier inverses, then assert the result
    equals the derandomized OOD quotient-segment combination."""
    code = []
    code += _push_xfe_zero()                          # total acc
    j = 0
    for p, count in enumerate(phase_counts):
        code += _push_xfe_zero()                      # phase acc
        for _ in range(count):
            code += _ld_xfe(OUT_PTR + 3 * j)
            code += _ld_xfe(QW + 3 * j)
            code += ["xx_mul", "xx_add"]
            j += 1
        code += _ld_xfe(SCR_ZI + 3 * p) + ["xx_mul", "xx_add"]
    # Horner: derand_curr = ((q3*a + q2)*a + q1)*a + q0
    def horner(base, pt_addr):
        c = _ld_xfe(base + 3 * (NUM_QUOTIENT_SEGMENTS - 1))
        for i in range(NUM_QUOTIENT_SEGMENTS - 2, -1, -1):
            c += _ld_xfe(pt_addr) + ["xx_mul"]
            c += _ld_xfe(base + 3 * i) + ["xx_add"]
        return c

    # zeta*alpha -> SCR_ZA
    code += _ld_xfe(ALPHA) + [f"push {ZETA}", "xb_mul"] + _st_xfe(SCR_ZA)
    code += horner(OODQ_P, ALPHA)
    code += horner(OODQ_R, SCR_ZA)
    code += ["xx_add"]
    # stack: _ total(3) derand(3) — assert equal
    code += _assert_xfe_eq()
    return code


def _deep_points_section(trace_gen: int):
    """Store the four DEEP denominator points at SCR_PT."""
    code = []
    code += _ld_xfe(ALPHA) + _st_xfe(SCR_PT + 0)
    code += _ld_xfe(ALPHA) + [f"push {trace_gen}", "xb_mul"]
    code += _st_xfe(SCR_PT + 3)
    code += _ld_xfe(ALPHA)
    for _ in range(NUM_QUOTIENT_SEGMENTS.bit_length() - 1):
        code += _xfe_square()
    code += _st_xfe(SCR_PT + 6)
    code += _ld_xfe(ALPHA) + [f"push {ZETA}", "xb_mul"]
    for _ in range(NUM_QUOTIENT_SEGMENTS.bit_length() - 1):
        code += _xfe_square()
    code += _st_xfe(SCR_PT + 9)
    return code


def _ood_values_section():
    """Fold the OOD rows with the combination weights; store the four
    reference values the DEEP updates subtract (SCR_OOD)."""
    code = []
    for slot, (mrow, arow) in enumerate(((CURR_MAIN, CURR_AUX),
                                         (NEXT_MAIN, NEXT_AUX))):
        code += _push_xfe_zero()
        for c in range(379):
            code += _ld_xfe(mrow + 3 * c) + _ld_xfe(W_MAIN + 3 * c)
            code += ["xx_mul", "xx_add"]
        for c in range(91):
            code += _ld_xfe(arow + 3 * c) + _ld_xfe(W_AUX + 3 * c)
            code += ["xx_mul", "xx_add"]
        code += _st_xfe(SCR_OOD + 3 * slot)
    # ood quotient-segment values under the shifted weight windows
    code += _push_xfe_zero()
    for i in range(NUM_QUOTIENT_SEGMENTS):
        code += _ld_xfe(OODQ_P + 3 * i) + _ld_xfe(W_QS + 3 * i)
        code += ["xx_mul", "xx_add"]
    code += _st_xfe(SCR_OOD + 6)
    code += _push_xfe_zero()
    for i in range(NUM_QUOTIENT_SEGMENTS):
        code += _ld_xfe(OODQ_R + 3 * i) + _ld_xfe(W_QS + 3 * (i + 1))
        code += ["xx_mul", "xx_add"]
    code += _st_xfe(SCR_OOD + 9)
    return code


def _row_hash_and_walk(base: int, num_words: int, node_index: int,
                       root_addr: int):
    """Hash a RAM row (hash_varlen: pre-padded to a RATE multiple) and
    walk the Merkle path with divined siblings; assert the root."""
    padded = num_words + 1
    padded += (-padded) % 10
    code = ["sponge_init"]
    code += ["push 0"] * 5 + [f"push {base % P}"]
    code += ["sponge_absorb_mem"] * (padded // 10)
    code += ["pop 1", "pop 5"]
    code += ["sponge_squeeze"]
    # digest = state[0..5] = top 5; park it, drop state[5..10]
    code += _st5(SCR_DIG) + ["pop 5"]
    code += [f"push {node_index}"]
    code += [f"push {(SCR_DIG + 4) % P}", "read_mem 5", "pop 1"]
    code += ["call walk_up"]
    code += [f"push {(root_addr + 4) % P}", "read_mem 5", "pop 1"]
    code += ["assert_vector", "pop 5", "pop 1"]
    return code


def _st5(addr):
    return [f"push {addr % P}", "write_mem 5", "pop 1"]


def _query_section(q: int, x_i: int, merkle_height: int, idx: int,
                   num_segments: int):
    """All in-VM checks for one revealed index."""
    code = []
    n_leaves = 1 << merkle_height
    code += _row_hash_and_walk(_q_main(q), 379, n_leaves + idx, ROOTS)
    code += _row_hash_and_walk(_q_aux(q), 273, n_leaves + idx, ROOTS + 8)
    code += _row_hash_and_walk(_q_quot(q), 3 * num_segments,
                               n_leaves + idx, ROOTS + 16)
    # main_aux_elem = sum w_main[c]*row[c] (BFE rows) + sum w_aux*aux
    code += _push_xfe_zero()
    for c in range(379):
        code += _ld_xfe(W_MAIN + 3 * c)
        code += _ld_bfe(_q_main(q) + c) + ["xb_mul", "xx_add"]
    for c in range(91):
        code += _ld_xfe(_q_aux(q) + 3 * c) + _ld_xfe(W_AUX + 3 * c)
        code += ["xx_mul", "xx_add"]
    code += _st_xfe(SCR_VAL + 0)
    # quot_elem_p / quot_elem_r share the middle segments
    code += _push_xfe_zero()
    for s in range(1, num_segments - 1):
        code += _ld_xfe(_q_quot(q) + 3 * s) + _ld_xfe(W_QS + 3 * s)
        code += ["xx_mul", "xx_add"]
    code += ["dup 2", "dup 2", "dup 2"]
    code += _ld_xfe(_q_quot(q)) + _ld_xfe(W_QS) + ["xx_mul", "xx_add"]
    code += _st_xfe(SCR_VAL + 3)                      # quot_elem_p
    code += _ld_xfe(_q_quot(q) + 3 * (num_segments - 1))
    code += _ld_xfe(W_QS + 3 * (num_segments - 1)) + ["xx_mul", "xx_add"]
    code += _st_xfe(SCR_VAL + 6)                      # quot_elem_r
    # deep = sum_k w_deep[k] * (val_k - ood_k) / (x_i - pt_k)
    val_addrs = (SCR_VAL + 0, SCR_VAL + 0, SCR_VAL + 3, SCR_VAL + 6)
    code += _push_xfe_zero()
    for k in range(4):
        code += _ld_xfe(SCR_PT + 3 * k)
        code += [f"push {P - 1}", "xb_mul",
                 "push 0", "push 0", f"push {x_i % P}", "xx_add",
                 "x_invert"]
        code += _ld_xfe(SCR_OOD + 3 * k)
        code += [f"push {P - 1}", "xb_mul"]
        code += _ld_xfe(val_addrs[k]) + ["xx_add"]
        code += ["xx_mul"]
        code += _ld_xfe(W_DEEP + 3 * k) + ["xx_mul", "xx_add"]
    # assert against the revealed FRI value
    code += _ld_xfe(_q_reveal(q))
    code += _assert_xfe_eq()
    return code


_WALK_UP = ["walk_up:", "dup 5", "push 1", "eq", "skiz", "return",
            "merkle_step", "recurse"]

FS_ABSORB = 1 << 49               # contiguous padded FS absorb stream
FS_EXPECT = 1 << 50               # expected squeeze outputs, 10 per event


def _fs_replay_section(fs_events, ram_put):
    """Replay the verifier's full Fiat-Shamir transcript in-VM:
    sponge_init, then every absorb (claim + each FS-included proof item,
    pre-padded, streamed from RAM via sponge_absorb_mem) and every
    squeeze in occurrence order — each squeeze's 10 outputs asserted
    against the host verifier's recorded stream, which pins every
    challenge, weight, OOD point, and index derivation."""
    code = ["sponge_init"]
    code += ["push 0"] * 5 + [f"push {FS_ABSORB % P}"]
    cursor = FS_ABSORB
    expect = FS_EXPECT
    for kind, words in fs_events:
        if kind == "absorb":
            ram_put(cursor, words)
            code += ["sponge_absorb_mem"] * (len(words) // 10)
            cursor += len(words)
        else:  # squeeze
            ram_put(expect, words)
            code += ["pop 1", "sponge_squeeze"]
            for i in range(10):  # stack top = state[0] = words[0]
                code += [f"push {(expect + i) % P}", "read_mem 1",
                         "pop 1", "eq", "assert"]
            expect += 10
            code += [f"push {cursor % P}"]
    code += ["pop 1", "pop 5"]
    return code


# ------------------------------------------------------------ host harness

@dataclass
class RecursiveVerifier:
    programs: dict
    non_determinism: NonDeterminism
    anchors: dict = field(default_factory=dict)

    def run(self, section: str = "combined") -> dict:
        """Execute a section in the VM; raises VMError on a bad proof.
        Returns {"cycles": n, "padded_height": h}."""
        program = self.programs[section]
        nd = NonDeterminism(ram=dict(self.non_determinism.ram),
                            digests=list(self.non_determinism.digests))
        aet, _ = VM.trace_execution(program, PublicInput([]), nd)
        return {"cycles": aet.height_of_table("processor"),
                "padded_height": aet.padded_height()}


def build(claim, proof, stark, num_queries: int = 1) -> RecursiveVerifier:
    """Verify `proof` on the host (collecting intermediates), then build
    the TASM verifier-core instance for `num_queries` revealed indices."""
    col: dict = {}
    assert Verifier(stark).verify(claim, proof, collector=col)

    layout = tasm.StaticTasmConstraintEvaluationMemoryLayout(
        free_mem_page_ptr=FREE_PAGE, curr_main_row_ptr=CURR_MAIN,
        curr_aux_row_ptr=CURR_AUX, next_main_row_ptr=NEXT_MAIN,
        next_aux_row_ptr=NEXT_AUX, challenges_ptr=CHALLENGES)
    air_code = tasm.static_air_constraint_evaluation_tasm(layout)

    ram: dict = {}

    def put_xfes(base, xfes):
        for i, x in enumerate(xfes):
            for c in range(3):
                ram[(base + 3 * i + c) % P] = int(x[c])

    def put_bfes(base, vals):
        for i, v in enumerate(vals):
            ram[(base + i) % P] = int(v)

    put_xfes(CURR_MAIN, col["ood_main_curr"])
    put_xfes(CURR_AUX, col["ood_aux_curr"])
    put_xfes(NEXT_MAIN, col["ood_main_next"])
    put_xfes(NEXT_AUX, col["ood_aux_next"])
    put_xfes(CHALLENGES, col["challenges"])
    put_xfes(QW, col["quot_weights"])
    put_xfes(OODQ_P, col["ood_quot_p"])
    put_xfes(OODQ_R, col["ood_quot_r"])
    put_xfes(ALPHA, [col["alpha"]])
    w = col["weights"]
    put_xfes(W_MAIN, w["main"])
    put_xfes(W_AUX, w["aux"])
    put_xfes(W_QS, w["quot_segments"])
    put_xfes(W_DEEP, w["deep"])
    put_bfes(ROOTS, col["main_root"])
    put_bfes(ROOTS + 8, col["aux_root"])
    put_bfes(ROOTS + 16, col["quot_root"])

    h = int(col["trace_domain_len"])
    ldt = col["ldt_dom"]
    mh = int(col["merkle_height"])
    num_segments = int(col["quot_rows"].shape[1])  # numpy ints poison
    num_queries = min(num_queries, len(col["revealed_indices"]))  # f-strings

    def padded_row(vals, total):
        vals = [int(v) for v in vals] + [1]
        return vals + [0] * (total - len(vals))

    digests: list = []
    trees = {}
    for name in ("main", "aux", "quot"):
        trees[name] = merkle.partial_tree_nodes(
            ldt.length, col["revealed_indices"], col[f"{name}_digests"],
            col[f"{name}_auth"])
        assert trees[name] is not None

    query_code = []
    for q in range(num_queries):
        idx = int(col["revealed_indices"][q])
        put_bfes(_q_main(q),
                 padded_row(col["main_rows"][q], 390))
        put_bfes(_q_aux(q),
                 padded_row(col["aux_rows"][q].reshape(-1), 280))
        put_bfes(_q_quot(q),
                 padded_row(col["quot_rows"][q].reshape(-1), 20))
        put_xfes(_q_reveal(q), [col["revealed_values"][q]])
        for name in ("main", "aux", "quot"):
            node = idx + ldt.length
            while node > 1:
                digests.append(trees[name][node ^ 1])
                node //= 2
        query_code += _query_section(q, int(ldt.value(idx)), mh, idx,
                                     num_segments)

    def ram_put(base, words):
        for i, v in enumerate(words):
            ram[(base + i) % P] = int(v)

    fs_code = _fs_replay_section(col["fs_events"], ram_put)

    phase_counts = (81, 97, 403, 23)
    zero_code = _zerofier_section(h, col["trace_gen"])
    ood_code = (zero_code + list(air_code) + ["pop 1"]
                + _quotient_fold_section(phase_counts))
    prep_code = _deep_points_section(col["trace_gen"]) \
        + _ood_values_section()

    def make(lines, needs_walk=False):
        src = "\n".join(lines + ["halt"]
                        + (_WALK_UP if needs_walk else []))
        return Program.from_code(src)

    programs = {
        "air_eval": make(list(air_code) + ["pop 1"]),
        "fs_replay": make(fs_code),
        "ood_check": make(ood_code),
        "queries": make(prep_code + query_code, needs_walk=True),
        "combined": make(fs_code + ood_code + prep_code + query_code,
                         needs_walk=True),
    }
    nd = NonDeterminism(ram=ram, digests=digests)
    return RecursiveVerifier(
        programs=programs, non_determinism=nd,
        anchors={"spec_static_air_eval_processor_rows": 33998})
