"""The device-resident witness: aux extension and derived columns on tensors.

The counterpart of `triton_vm_tpu.tables.extend_device`, with its function
names. The reference computes every aux column as a sequential scan over
rows (running evaluations, running products, log-derivative sums, e.g.
table/program.rs:205-264, table/lookup.rs:27-82). Every one of these
updates is associative, so here they are log-depth scans over all rows at
once:

- log derivatives: per-row summands m_i / (indeterminate - compressed_i),
  one batched XFE inversion over every denominator of every table, masked,
  prefix-summed;
- running evaluations: per-row affine maps acc -> a_i*acc + b_i, composed
  as (a2, b2) o (a1, b1) = (a1*a2, b2 + a2*b1); resets and holds are the
  elements (0, c) and (1, 0);
- running products: the same composition with b = 0.

The pipeline runs in three steps on the main table's device:

  A. per-table FACTOR functions (`_TABLE_FAC`): elementwise per-row
     log-derivative denominators, numerators and masks, and affine (a, b)
     pairs, from the (NUM_MAIN, h) main tensor and the (3, 63) challenges;
  B1. one batched inversion, one batched prefix sum and one batched affine
     scan over every table's factors (`_phase_b1_fn`);
  B2. assembly (`_phase_b2`): per-column sums, the exclusive shift of the
     program table's instruction-lookup server, and the second-round scans
     whose factors read first-round outputs (Program.SendChunk reads
     PrepareChunk, Ram.FormalDerivative reads RunningProductOfRAMP).

The 230 derived main and 41 derived aux columns (the degree-lowering
substitutions) run as compiled tapes (air/compile.py) over all rows.
`main_witness_dev` and `aux_witness_dev` give the prover the whole witness
on the device from one upload of the 149 AIR main columns. Their oracle
is the JAX package's host witness, `triton_vm_tpu.tables.master`
(tests/test_torch_witness.py).

Field elements follow ops/gf.py (an int64 holding the u64 bit pattern) and
ops/gfx.py (an XFE is a leading axis of 3); challenges are (3, 1) columns
that broadcast against (3, h) rows.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..air import columns
from ..air.challenges import COUNT as NUM_CHALLENGES
from ..air.challenges import ID as CH_ID
from ..crypto import tip5
from ..fields.bfe import P, R_INV
from ..ops import gf, gfx
from ..utils import profiler

M = columns.main_index
A = columns.aux_index

NUM_MAIN = 379
NUM_AUX = 91


# ------------------------------------------------------------------- scans

def _shifted(v, d, fill):
    """v[..., i - d] at position i along the last axis; the first d
    positions hold `fill` (broadcast against v[..., :d])."""
    out = torch.empty_like(v)
    out[..., :d] = fill
    out[..., d:] = v[..., :-d]
    return out


def _xfe_fill(v, value):
    """The XFE (value, 0, 0) shaped to broadcast against v (3, ...)."""
    fill = torch.zeros((3,) + (1,) * (v.dim() - 1), dtype=v.dtype,
                       device=v.device)
    fill[0] = value
    return fill


def prefix_sum(v):
    """Inclusive prefix sum of an XFE (3, ..., h) along the last axis: a
    Hillis-Steele ladder of ceil(log2 h) shift-and-add steps."""
    h, d = v.shape[-1], 1
    while d < h:
        v = gfx.add(v, _shifted(v, d, 0))
        d *= 2
    return v


def affine_scan(a, b):
    """Prefix composition of the maps acc -> a_i*acc + b_i (inclusive,
    along the last axis of XFE (3, ..., h) tensors). Returns (A, B) with
    value_i = A_i*acc0 + B_i. Shifted-in positions hold the identity map
    (1, 0)."""
    h, d = a.shape[-1], 1
    one = _xfe_fill(a, 1)
    while d < h:
        pa = _shifted(a, d, one)
        pb = _shifted(b, d, 0)
        # (a, b) o (pa, pb): x -> a*(pa*x + pb) + b
        a, b = gfx.mul(a, pa), gfx.add(gfx.mul(a, pb), b)
        d *= 2
    return a, b


# ------------------------------------------------------------ row helpers

class _Ctx:
    """Accessors over the (NUM_MAIN, h) main tensor and the (3, 63)
    challenge tensor, plus the constants every factor function uses."""

    def __init__(self, main, challenges):
        self.main, self.challenges = main, challenges
        self.h = main.shape[1]
        self.device = main.device
        self.rows = torch.arange(self.h, device=self.device)
        self.one = gfx.lift(torch.ones(self.h, dtype=gf.I64,
                                       device=self.device))
        self.zero = gfx.zeros((self.h,), self.device)

    def col(self, table, name):
        """Main column as a base-field row (h,)."""
        return self.main[M(table, name)]

    def ch(self, name):
        """Challenge as an XFE column (3, 1)."""
        i = CH_ID[name]
        return self.challenges[:, i:i + 1]

    def const(self, value: int):
        """Base-field constant as a 0-d tensor."""
        return gf.full((), value, self.device)


def _prev_gf(v):
    """v shifted down one row along the last axis; row 0 becomes 0 (False
    for a mask)."""
    return _shifted(v, 1, 0)


# The shift is the same for a base row, an XFE row and a mask.
_prev_gfx = _prev_mask = _prev_gf


def _next_gf(v):
    """v shifted up one row; the last row becomes 0."""
    out = torch.zeros_like(v)
    out[..., :-1] = v[..., 1:]
    return out


def _eqc(v, c: int):
    """Base-field row == the Python constant c."""
    return v == gf.to_i64(c)


def _eqc_lt256(v):
    """Unsigned v < 256 (values at or above 2^63 are negative as int64)."""
    return (v >= 0) & (v < 256)


def _lift(v):
    return gfx.lift(v)


def _bc(scalar, h):
    """Broadcast an XFE column (3, 1) to (3, h)."""
    return scalar.expand(3, h)


def _wsum(pairs):
    """sum_i weight_i * value_i for (XFE column, base row) pairs."""
    acc = None
    for w, v in pairs:
        term = gfx.bfe_mul(w, v)
        acc = term if acc is None else gfx.add(acc, term)
    return acc


def _masked_product(terms, actives, one):
    """prod_s (term_s where active_s, else 1), as a sequential fold."""
    factor = None
    for t, m in zip(terms, actives):
        ft = torch.where(m, t, one)
        factor = ft if factor is None else gfx.mul(factor, ft)
    return factor


def _ch_pows(scalar, n):
    """[scalar^0 .. scalar^n] as XFE columns (3, 1)."""
    pows = [_xfe_fill(scalar, 1)]
    for _ in range(n):
        pows.append(gfx.mul(pows[-1], scalar))
    return pows


# ----------------------------------------------------- instruction metadata

@functools.lru_cache(maxsize=1)
def _opcode_table_arrays():
    """numpy lookup tables indexed by opcode (0..255): valid, arg_kind
    (0 = none/bfe/call, 1 = num_words, 2 = stack_elem), op-stack influence
    kind (0 fixed, 1 +arg, 2 -arg), fixed influence."""
    from ..isa.instruction import _SPEC

    valid = np.zeros(256, bool)
    arg_kind = np.zeros(256, np.int64)
    infl_kind = np.zeros(256, np.int64)
    infl_fixed = np.zeros(256, np.int64)
    for name, (op, kind, infl, _is_u32) in _SPEC.items():
        valid[op] = True
        arg_kind[op] = {None: 0, "bfe": 0, "call": 0,
                        "num_words": 1, "stack_elem": 2}[kind]
        if infl is None:
            infl_kind[op] = 2 if name in ("pop", "write_mem", "write_io") \
                else 1
        else:
            infl_fixed[op] = infl
    return valid, arg_kind, infl_kind, infl_fixed


def _opcode_tables(device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in _opcode_table_arrays())


def _op(name):
    from ..isa.instruction import _SPEC
    return _SPEC[name][0]


def _decode_rows(ci, nia):
    """The JAX package's `_instruction_from_processor_row`
    (triton_vm_tpu/tables/master.py) over all rows: (valid, arg, op).
    `arg` is NIA's low 32 bits as a signed int32 (sign-extended into the
    int64); it only matters under `valid`."""
    valid_t, arg_kind_t, _, _ = _opcode_tables(ci.device)
    in_range = _eqc_lt256(ci)
    op = torch.where(in_range, ci, 0)
    valid = valid_t[op] & in_range
    kind = arg_kind_t[op]
    arg_nonzero = nia != 0
    arg_gt5 = (nia < 0) | (nia > 5)      # unsigned nia > 5
    arg_gt15 = (nia < 0) | (nia > 15)
    valid &= ~((kind == 1) & (~arg_nonzero | arg_gt5))
    valid &= ~((kind == 2) & arg_gt15)
    arg_i32 = (nia << 32) >> 32
    return valid, arg_i32, op


# ---------------------------------------------------------- factor collector

class _Collector:
    """Every scan's per-row inputs, gathered while the factor functions run.

    ld rows: value_i = sum_{j<=i} [mask_j] num_j / den_j, later summed per
    column (a column may own several rows). aff rows: inclusive affine
    composition with acc0 = ONE; the column's value is A + B."""

    def __init__(self, h):
        self.h = h
        self.ld_ids = []    # column ids, one per ld row
        self.ld_dens = []
        self.ld_nums = []
        self.ld_masks = []
        self.aff_ids = []   # column ids, one per affine row
        self.aff_a = []
        self.aff_b = []

    def ld(self, col_id, indeterminate, compressed, mult, mask):
        self.ld_ids.append(col_id)
        self.ld_dens.append(gfx.sub(_bc(indeterminate, self.h), compressed))
        self.ld_nums.append(mult)
        self.ld_masks.append(mask)

    def aff(self, col_id, a, b):
        self.aff_ids.append(col_id)
        self.aff_a.append(a)
        self.aff_b.append(b)

    def prod(self, col_id, factor):
        self.aff(col_id, factor, torch.zeros_like(factor))


# ========================================================= per-table factors

def _fac_program(ctx, C):
    """table/program.rs:205-264."""
    h, ch = ctx.h, ctx.ch
    addr = ctx.col("program", "Address")
    instr = ctx.col("program", "Instruction")
    nxt_instr = _next_gf(instr)  # last row masked out below
    mult = ctx.col("program", "LookupMultiplicity")
    hash_pad = ctx.col("program", "IsHashInputPadding")
    idx_in_chunk = ctx.col("program", "IndexInChunk")

    # instruction-lookup log derivative; the served value at row i
    # excludes row i's own summand -> exclusive shift in phase B2
    compressed = _wsum([(ch("ProgramAddressWeight"), addr),
                        (ch("ProgramInstructionWeight"), instr),
                        (ch("ProgramNextInstructionWeight"), nxt_instr)])
    active = _eqc(hash_pad, 0) & (ctx.rows != h - 1)
    C.ld(A("program", "InstructionLookupServerLogDerivative"),
         ch("InstructionLookupIndeterminate"), compressed, mult, active)

    # prepare-chunk running evaluation with reset at IndexInChunk == 0
    alpha_p = ch("ProgramAttestationPrepareChunkIndeterminate")
    reset = _eqc(idx_in_chunk, 0)
    a = torch.where(reset, ctx.zero, _bc(alpha_p, h))
    b_reset = gfx.add(_bc(alpha_p, h), _lift(instr))
    b = torch.where(reset, b_reset, _lift(instr))
    C.aff(A("program", "PrepareChunkRunningEvaluation"), a, b)
    # send-chunk consumes the prepare-chunk scan -> phase B2


def _fac_cascade(ctx, C):
    """table/cascade.rs extension."""
    ch = ctx.ch
    active = ~_eqc(ctx.col("cascade", "IsPadding"), 1)
    lo_in = ctx.col("cascade", "LookInLo")
    hi_in = ctx.col("cascade", "LookInHi")
    lo_out = ctx.col("cascade", "LookOutLo")
    hi_out = ctx.col("cascade", "LookOutHi")
    mult = ctx.col("cascade", "LookupMultiplicity")

    look_in = gf.add(gf.mul_const(hi_in, 1 << 8), lo_in)
    look_out = gf.add(gf.mul_const(hi_out, 1 << 8), lo_out)
    compressed_hash = _wsum([(ch("HashCascadeLookInWeight"), look_in),
                             (ch("HashCascadeLookOutWeight"), look_out)])
    C.ld(A("cascade", "HashTableServerLogDerivative"),
         ch("HashCascadeLookupIndeterminate"), compressed_hash, mult, active)

    # two lookup summands per row (lo and hi limbs) -> same column
    ones = torch.ones_like(mult)
    lo = _wsum([(ch("LookupTableInputWeight"), lo_in),
                (ch("LookupTableOutputWeight"), lo_out)])
    hi = _wsum([(ch("LookupTableInputWeight"), hi_in),
                (ch("LookupTableOutputWeight"), hi_out)])
    cid = A("cascade", "LookupTableClientLogDerivative")
    C.ld(cid, ch("CascadeLookupIndeterminate"), lo, ones, active)
    C.ld(cid, ch("CascadeLookupIndeterminate"), hi, ones, active)


def _fac_lookup(ctx, C):
    """table/lookup.rs:27-82."""
    h, ch = ctx.h, ctx.ch
    active = ~_eqc(ctx.col("lookup", "IsPadding"), 1)
    look_in = ctx.col("lookup", "LookIn")
    look_out = ctx.col("lookup", "LookOut")
    mult = ctx.col("lookup", "LookupMultiplicity")

    compressed = _wsum([(ch("LookupTableInputWeight"), look_in),
                        (ch("LookupTableOutputWeight"), look_out)])
    C.ld(A("lookup", "CascadeTableServerLogDerivative"),
         ch("CascadeLookupIndeterminate"), compressed, mult, active)

    alpha = ch("LookupTablePublicIndeterminate")
    a = torch.where(active, _bc(alpha, h), ctx.one)
    b = torch.where(active, _lift(look_out), ctx.zero)
    C.aff(A("lookup", "PublicEvaluationArgument"), a, b)


class _ProcPrelude:
    """Decoded quantities shared by the processor table's four factor
    functions."""

    def __init__(self, ctx):
        pcol = lambda n: ctx.col("processor", n)  # noqa: E731
        self.pcol = pcol
        self.ci = pcol("CI")
        self.nia = pcol("NIA")
        self.clk = pcol("CLK")
        self.is_padding = _eqc(pcol("IsPadding"), 1)
        self.st = [pcol(f"ST{k}") for k in range(16)]
        self.hv = [pcol(f"HV{k}") for k in range(6)]
        self.prev_st = [_prev_gf(s) for s in self.st]
        self.prev_hv = [_prev_gf(v) for v in self.hv]
        self.prev_clk = _prev_gf(self.clk)
        row_valid, row_arg, _ = _decode_rows(self.ci, self.nia)
        self.prev_valid = _prev_mask(row_valid)
        self.prev_arg = _prev_gf(row_arg)

    # a method, not a lambda attribute closing over self: that reference
    # cycle kept every tensor here alive until the cycle collector ran
    def prev_ci_is(self, opcode):
        return _prev_mask(_eqc(self.ci, opcode))


def _fac_processor_io(ctx, C):
    """processor.rs: io eval args + instruction lookup + jump stack."""
    h, ch = ctx.h, ctx.ch
    p = _ProcPrelude(ctx)
    ci, nia, clk = p.ci, p.nia, p.clk
    st, prev_st = p.st, p.prev_st
    prev_valid, prev_arg, prev_ci_is = \
        p.prev_valid, p.prev_arg, p.prev_ci_is
    is_padding = p.is_padding
    pcol = p.pcol

    # --- input / output eval args (dest-indexed; prev instr read/write_io)
    for which, opcode, beta_name in (
            ("in", _op("read_io"), "StandardInputIndeterminate"),
            ("out", _op("write_io"), "StandardOutputIndeterminate")):
        pows = _ch_pows(ch(beta_name), 5)
        a = ctx.one
        b = ctx.zero
        st_rows = st if which == "in" else prev_st
        op_mask = prev_ci_is(opcode) & prev_valid
        for n in range(1, 6):
            mask = op_mask & (prev_arg == n)
            if which == "in":
                b_n = _wsum([(pows[k], st_rows[k]) for k in range(n)])
            else:
                b_n = _wsum([(pows[n - 1 - k], st_rows[k])
                             for k in range(n)])
            a = torch.where(mask, _bc(pows[n], h), a)
            b = torch.where(mask, b_n, b)
        colname = ("InputTableEvalArg" if which == "in"
                   else "OutputTableEvalArg")
        C.aff(A("processor", colname), a, b)

    # --- instruction lookup client log derivative (inclusive)
    compressed = _wsum([
        (ch("ProgramAddressWeight"), pcol("IP")),
        (ch("ProgramInstructionWeight"), ci),
        (ch("ProgramNextInstructionWeight"), nia)])
    C.ld(A("processor", "InstructionLookupClientLogDerivative"),
         ch("InstructionLookupIndeterminate"), compressed,
         torch.ones_like(ci), ~is_padding)

    # --- jump stack perm arg (inclusive running product)
    compressed = _wsum([
        (ch("JumpStackClkWeight"), clk),
        (ch("JumpStackCiWeight"), ci),
        (ch("JumpStackJspWeight"), pcol("JSP")),
        (ch("JumpStackJsoWeight"), pcol("JSO")),
        (ch("JumpStackJsdWeight"), pcol("JSD"))])
    C.prod(A("processor", "JumpStackTablePermArg"),
           gfx.sub(_bc(ch("JumpStackIndeterminate"), h), compressed))

    # --- clock jump difference lookup server log derivative (inclusive)
    mult = pcol("ClockJumpDifferenceLookupMultiplicity")
    C.ld(A("processor", "ClockJumpDifferenceLookupServerLogDerivative"),
         ch("ClockJumpDifferenceLookupIndeterminate"), _lift(clk), mult,
         mult != 0)


def _fac_processor_stack(ctx, C):
    """processor.rs: op-stack + RAM running-product factors."""
    h, ch = ctx.h, ctx.ch
    p = _ProcPrelude(ctx)
    ci, clk = p.ci, p.clk
    st, prev_st, prev_hv = p.st, p.prev_st, p.prev_hv
    prev_clk = p.prev_clk
    prev_valid, prev_arg, prev_ci_is = \
        p.prev_valid, p.prev_arg, p.prev_ci_is
    is_padding = p.is_padding
    pcol = p.pcol

    # --- op stack table perm arg (dest-indexed running product)
    _, _, infl_kind_t, infl_fixed_t = _opcode_tables(ctx.device)
    opi = torch.where(_eqc_lt256(ci), ci, 0)
    prev_opi = _prev_gf(opi)
    kind = infl_kind_t[prev_opi]
    influence = torch.where(
        kind == 0, infl_fixed_t[prev_opi],
        torch.where(kind == 1, prev_arg, -prev_arg))
    influence = torch.where(prev_valid, influence, 0)
    factor_active = ~is_padding & prev_valid
    delta = influence.abs()
    use_prev = influence > 0

    prev_ib1 = _prev_gf(pcol("IB1"))
    osp = pcol("OpStackPointer")
    prev_osp = _prev_gf(osp)

    # slot-invariant part of every term, hoisted out of the slot loop
    os_base = gfx.sub(
        _bc(ch("OpStackIndeterminate"), h),
        _wsum([(ch("OpStackClkWeight"), prev_clk),
               (ch("OpStackIb1Weight"), prev_ib1)]))
    pointer0 = torch.where(use_prev, prev_osp, osp)
    terms, actives = [], []
    for off in range(10):  # |influence| <= 10 (sponge_{absorb,squeeze})
        underflow = torch.where(use_prev, prev_st[15 - off], st[15 - off])
        pointer = gf.add(pointer0, ctx.const(off))
        terms.append(gfx.sub(os_base, _wsum([
            (ch("OpStackPointerWeight"), pointer),
            (ch("OpStackFirstUnderflowElementWeight"), underflow)])))
        actives.append(factor_active & (off < delta))
    C.prod(A("processor", "OpStackTablePermArg"),
           _masked_product(terms, actives, ctx.one))

    # --- ram table perm arg (dest-indexed running product, <= 10 slots)
    C.prod(A("processor", "RamTablePermArg"), _ram_factors(
        ctx, prev_ci_is, prev_arg, prev_valid, is_padding,
        prev_clk, st, prev_st, prev_hv))


def _fac_processor_hash(ctx, C):
    """processor.rs: hash-input/digest/sponge eval-arg factors."""
    h, ch = ctx.h, ctx.ch
    p = _ProcPrelude(ctx)
    ci = p.ci
    st, hv, prev_st, prev_hv = p.st, p.hv, p.prev_st, p.prev_hv
    prev_ci_is = p.prev_ci_is
    one, zero = ctx.one, ctx.zero

    # --- hash input eval arg (row-indexed affine scan)
    is_hash = _eqc(ci, _op("hash"))
    is_merkle = _eqc(ci, _op("merkle_step")) | \
        _eqc(ci, _op("merkle_step_mem"))
    left = (st[5] & 1) == 0
    sw = [ch(f"StackWeight{k}") for k in range(16)]
    hash_comp = _wsum([(sw[k], st[k]) for k in range(10)])
    merkle_l = _wsum([(sw[k], st[k]) for k in range(5)]
                     + [(sw[5 + k], hv[k]) for k in range(5)])
    merkle_r = _wsum([(sw[k], hv[k]) for k in range(5)]
                     + [(sw[5 + k], st[k]) for k in range(5)])
    comp = torch.where(is_hash, hash_comp,
                       torch.where(left, merkle_l, merkle_r))
    mask = is_hash | is_merkle
    a = torch.where(mask, _bc(ch("HashInputIndeterminate"), h), one)
    b = torch.where(mask, comp, zero)
    C.aff(A("processor", "HashInputEvalArg"), a, b)

    # --- hash digest eval arg (dest-indexed affine scan)
    prev_hashy = _prev_mask(mask)
    digest_comp = _wsum([(sw[k], st[k]) for k in range(5)])
    a = torch.where(prev_hashy, _bc(ch("HashDigestIndeterminate"), h), one)
    b = torch.where(prev_hashy, digest_comp, zero)
    C.aff(A("processor", "HashDigestEvalArg"), a, b)

    # --- sponge eval arg (dest-indexed affine scan, 4 instruction cases)
    SI, SA, SAM, SS = (_op("sponge_init"), _op("sponge_absorb"),
                       _op("sponge_absorb_mem"), _op("sponge_squeeze"))
    ci_w = ch("HashCIWeight")

    def const_term(val):
        return _bc(gfx.bfe_mul(ci_w, ctx.const(val)), h)

    absorb_comp = gfx.add(const_term(SA), _wsum(
        [(sw[k], prev_st[k]) for k in range(10)]))
    sam_elements = [st[k] for k in (1, 2, 3, 4)] + prev_hv
    sam_comp = gfx.add(const_term(SA), _wsum(
        [(sw[k], e) for k, e in enumerate(sam_elements)]))
    squeeze_comp = gfx.add(const_term(SS), _wsum(
        [(sw[k], st[k]) for k in range(10)]))
    init_comp = const_term(SI)

    b = zero
    mask_any = None
    for opcode, comp in ((SI, init_comp), (SA, absorb_comp),
                         (SAM, sam_comp), (SS, squeeze_comp)):
        m = prev_ci_is(opcode)
        b = torch.where(m, comp, b)
        mask_any = m if mask_any is None else (mask_any | m)
    a = torch.where(mask_any, _bc(ch("SpongeIndeterminate"), h), one)
    C.aff(A("processor", "SpongeEvalArg"), a, b)


def _fac_processor_u32(ctx, C):
    """processor.rs: u32 lookup client factors (<= 2 summands/row)."""
    p = _ProcPrelude(ctx)
    _u32_summands(ctx, C, p.ci, p.st, p.prev_ci_is, p.prev_st)


def _ram_factors(ctx, prev_ci_is, prev_arg, prev_valid, is_padding,
                 prev_clk, st, prev_st, prev_hv):
    """factor_for_ram_table_running_product over all rows
    (processor.rs:646-741): up to 10 (pointer, value) accesses per row."""
    h, ch = ctx.h, ctx.ch

    is_read = prev_ci_is(_op("read_mem")) & prev_valid
    is_write = prev_ci_is(_op("write_mem")) & prev_valid
    is_sam = prev_ci_is(_op("sponge_absorb_mem"))
    is_msm = prev_ci_is(_op("merkle_step_mem"))
    is_bh = prev_ci_is(_op("b_horner_step"))
    is_xh = prev_ci_is(_op("x_horner_step"))
    base_active = ~is_padding & (ctx.rows > 0)

    zero = torch.zeros_like(prev_clk)
    itype = torch.where(is_write, zero, torch.ones_like(prev_clk))

    # per-row access count
    n_acc = torch.zeros_like(prev_arg)
    n_acc = torch.where(is_read | is_write, prev_arg, n_acc)
    n_acc = torch.where(is_sam, 10, n_acc)
    n_acc = torch.where(is_msm, 5, n_acc)
    n_acc = torch.where(is_bh, 1, n_acc)
    n_acc = torch.where(is_xh, 3, n_acc)

    sam_vals = [st[1], st[2], st[3], st[4]] + prev_hv[:6]
    # slot-invariant part of every term, hoisted out of the slot loop
    base = gfx.sub(
        _bc(ch("RamIndeterminate"), h),
        _wsum([(ch("RamClkWeight"), prev_clk),
               (ch("RamInstructionTypeWeight"), itype)]))
    terms, actives = [], []
    for s in range(10):
        ptr = zero
        val = zero
        ptr = torch.where(is_read, gf.add(st[0], ctx.const(s + 1)), ptr)
        if s < 5:
            val = torch.where(is_read, st[s + 1], val)
        ptr = torch.where(is_write, gf.add(prev_st[0], ctx.const(s)), ptr)
        if s < 5:
            val = torch.where(is_write, prev_st[s + 1], val)
        ptr = torch.where(is_sam, gf.add(prev_st[0], ctx.const(s)), ptr)
        val = torch.where(is_sam, sam_vals[s], val)
        if s < 5:
            ptr = torch.where(is_msm, gf.add(prev_st[7], ctx.const(s)), ptr)
            val = torch.where(is_msm, prev_hv[s], val)
        if s < 1:
            ptr = torch.where(is_bh, prev_st[5], ptr)
            val = torch.where(is_bh, prev_hv[0], val)
        if s < 3:
            ptr = torch.where(
                is_xh, gf.add(prev_st[5], ctx.const((P - 2 + s) % P)), ptr)
            val = torch.where(is_xh, prev_hv[s], val)

        terms.append(gfx.sub(base, _wsum([
            (ch("RamPointerWeight"), ptr),
            (ch("RamValueWeight"), val)])))
        actives.append(base_active & (s < n_acc))
    return _masked_product(terms, actives, ctx.one)


def _u32_summands(ctx, C, ci, st, prev_ci_is, prev_st):
    """u32-coprocessor log-derivative summands over all rows
    (processor.rs u32 section): two rows into one column."""
    ch = ctx.ch
    SPLIT, LT, AND, XOR = _op("split"), _op("lt"), _op("and"), _op("xor")
    LOG2, POW, DIVMOD, POPCNT = (_op("log_2_floor"), _op("pow"),
                                 _op("div_mod"), _op("pop_count"))
    MS, MSM = _op("merkle_step"), _op("merkle_step_mem")

    w_lhs, w_rhs = ch("U32LhsWeight"), ch("U32RhsWeight")
    w_ci, w_res = ch("U32CiWeight"), ch("U32ResultWeight")
    alpha = ch("U32Indeterminate")

    inv2 = pow(2, P - 2, P)
    and_result = gf.mul_const(
        gf.sub(gf.add(prev_st[0], prev_st[1]), st[0]), inv2)

    prev_ci = _prev_gf(ci)

    is_split = prev_ci_is(SPLIT)
    is_ltandpow = prev_ci_is(LT) | prev_ci_is(AND) | prev_ci_is(POW)
    is_xor = prev_ci_is(XOR)
    is_log2pop = prev_ci_is(LOG2) | prev_ci_is(POPCNT)
    is_divmod = prev_ci_is(DIVMOD)
    is_merkle = prev_ci_is(MS) | prev_ci_is(MSM)
    not_first = ctx.rows > 0

    def comp(lhs=None, rhs=None, ci_val=None, res=None):
        parts = [gfx.bfe_mul(w, v) for w, v in
                 ((w_lhs, lhs), (w_rhs, rhs), (w_ci, ci_val), (w_res, res))
                 if v is not None]
        acc = parts[0]
        for p in parts[1:]:
            acc = gfx.add(acc, p)
        return acc

    def const(v):
        return gf.full((ctx.h,), v, ctx.device)

    # row 1: every u32-ish instruction contributes one summand
    comp1 = ctx.zero
    cases = [
        (is_split, comp(lhs=st[0], rhs=st[1], ci_val=const(SPLIT))),
        (is_ltandpow, comp(lhs=prev_st[0], rhs=prev_st[1],
                           ci_val=prev_ci, res=st[0])),
        (is_xor, comp(lhs=prev_st[0], rhs=prev_st[1],
                      ci_val=const(AND), res=and_result)),
        (is_log2pop, comp(lhs=prev_st[0], ci_val=prev_ci, res=st[0])),
        (is_divmod, comp(lhs=st[0], rhs=prev_st[1],
                         ci_val=const(LT), res=const(1))),
        (is_merkle, comp(lhs=prev_st[5], rhs=st[5], ci_val=const(SPLIT))),
    ]
    active1 = None
    for m, c in cases:
        mm = m & not_first
        comp1 = torch.where(mm, c, comp1)
        active1 = mm if active1 is None else (active1 | mm)
    cid = A("processor", "U32LookupClientLogDerivative")
    ones = const(1)
    C.ld(cid, alpha, comp1, ones, active1)

    # row 2: div_mod's second (range-check) summand
    active2 = is_divmod & not_first
    comp2 = comp(lhs=prev_st[0], rhs=st[1], ci_val=const(SPLIT))
    C.ld(cid, alpha, comp2, ones, active2)


def _fac_op_stack(ctx, C):
    """table/op_stack.rs extension."""
    h, ch = ctx.h, ctx.ch
    col = lambda n: ctx.col("op_stack", n)  # noqa: E731
    clk, ib1 = col("CLK"), col("IB1ShrinkStack")
    ptr, under = col("StackPointer"), col("FirstUnderflowElement")
    not_padding = ~_eqc(ib1, 2)

    compressed = _wsum([
        (ch("OpStackClkWeight"), clk),
        (ch("OpStackIb1Weight"), ib1),
        (ch("OpStackPointerWeight"), ptr),
        (ch("OpStackFirstUnderflowElementWeight"), under)])
    term = gfx.sub(_bc(ch("OpStackIndeterminate"), h), compressed)
    C.prod(A("op_stack", "RunningProductPermArg"),
           torch.where(not_padding, term, ctx.one))

    same_ptr = (ptr == _prev_gf(ptr)) & (ctx.rows > 0)
    diff = gf.sub(clk, _prev_gf(clk))
    C.ld(A("op_stack", "ClockJumpDifferenceLookupClientLogDerivative"),
         ch("ClockJumpDifferenceLookupIndeterminate"), _lift(diff),
         torch.ones_like(clk), not_padding & same_ptr)


def _fac_ram(ctx, C):
    """table/ram.rs extension (incl. the Bézout running columns,
    ram.rs:212-255)."""
    h, ch = ctx.h, ctx.ch
    col = lambda n: ctx.col("ram", n)  # noqa: E731
    clk, itype = col("CLK"), col("InstructionType")
    ptr, val = col("RamPointer"), col("RamValue")
    bez = ch("RamTableBezoutRelationIndeterminate")
    not_padding = ~_eqc(itype, 2)
    not_first = ctx.rows > 0
    ptr_changed = (ptr != _prev_gf(ptr)) & not_first
    change = not_padding & ptr_changed
    one, zero = ctx.one, ctx.zero
    beta_minus_ptr = gfx.sub(_bc(bez, h), _lift(ptr))

    # running product of (beta - ptr): row 0 always contributes
    first = ~not_first
    C.prod(A("ram", "RunningProductOfRAMP"),
           torch.where(change | first, beta_minus_ptr, one))
    # FormalDerivative consumes the RunningProductOfRAMP scan -> B2

    # Bézout coefficient running evaluations
    for colname, main_col in (
            ("BezoutCoefficient0",
             "BezoutCoefficientPolynomialCoefficient0"),
            ("BezoutCoefficient1",
             "BezoutCoefficientPolynomialCoefficient1")):
        coeff = col(main_col)
        a = torch.where(change, _bc(bez, h), one)
        a = torch.where(first, zero, a)  # kill acc0 influence
        b = torch.where(change | first, _lift(coeff), zero)
        C.aff(A("ram", colname), a, b)

    # running product perm arg
    compressed = _wsum([
        (ch("RamClkWeight"), clk),
        (ch("RamInstructionTypeWeight"), itype),
        (ch("RamPointerWeight"), ptr),
        (ch("RamValueWeight"), val)])
    term = gfx.sub(_bc(ch("RamIndeterminate"), h), compressed)
    C.prod(A("ram", "RunningProductPermArg"),
           torch.where(not_padding, term, one))

    # clock jump difference log derivative
    same = not_padding & ~ptr_changed & not_first
    diff = gf.sub(clk, _prev_gf(clk))
    C.ld(A("ram", "ClockJumpDifferenceLookupClientLogDerivative"),
         ch("ClockJumpDifferenceLookupIndeterminate"), _lift(diff),
         torch.ones_like(clk), same)


def _fac_jump_stack(ctx, C):
    """table/jump_stack.rs extension."""
    h, ch = ctx.h, ctx.ch
    col = lambda n: ctx.col("jump_stack", n)  # noqa: E731
    clk = col("CLK")
    compressed = _wsum([
        (ch("JumpStackClkWeight"), clk),
        (ch("JumpStackCiWeight"), col("CI")),
        (ch("JumpStackJspWeight"), col("JSP")),
        (ch("JumpStackJsoWeight"), col("JSO")),
        (ch("JumpStackJsdWeight"), col("JSD"))])
    C.prod(A("jump_stack", "RunningProductPermArg"),
           gfx.sub(_bc(ch("JumpStackIndeterminate"), h), compressed))

    jsp = col("JSP")
    same = (jsp == _prev_gf(jsp)) & (ctx.rows > 0)
    diff = gf.sub(clk, _prev_gf(clk))
    C.ld(A("jump_stack", "ClockJumpDifferenceLookupClientLogDerivative"),
         ch("ClockJumpDifferenceLookupIndeterminate"), _lift(diff),
         torch.ones_like(clk), same)


def _fac_hash(ctx, C):
    """table/hash.rs extension: 4 running evaluations + 16 cascade log
    derivatives."""
    h, ch = ctx.h, ctx.ch
    col = lambda n: ctx.col("hash", n)  # noqa: E731
    mode, rn, ci = col("Mode"), col("RoundNumber"), col("CI")
    is_si = _eqc(ci, _op("sponge_init"))

    # rate registers: first 4 states recombined from 16-bit limbs
    # (x Montgomery R^-1), states 4..9 direct
    limb_consts = [R_INV, (1 << 16) * R_INV % P, (1 << 32) * R_INV % P,
                   (1 << 48) * R_INV % P]
    parts = ("Lowest", "MidLow", "MidHigh", "Highest")
    rate = []
    for k in range(4):
        acc = None
        for c, part in zip(limb_consts, parts):
            term = gf.mul_const(col(f"State{k}{part}LkIn"), c)
            acc = term if acc is None else gf.add(acc, term)
        rate.append(acc)
    for k in range(4, 10):
        rate.append(col(f"State{k}"))

    sw = [ch(f"StackWeight{k}") for k in range(16)]
    compressed_row = _wsum([(sw[k], rate[k]) for k in range(10)])
    one, zero = ctx.one, ctx.zero
    rn0 = _eqc(rn, 0)

    # receive-chunk running evaluation (mode 1, round 0)
    prep_pows = _ch_pows(
        ch("ProgramAttestationPrepareChunkIndeterminate"), 10)
    chunk = gfx.add(_bc(prep_pows[10], h), _wsum(
        [(prep_pows[9 - k], rate[k]) for k in range(10)]))
    m_recv = _eqc(mode, 1) & rn0
    a = torch.where(
        m_recv, _bc(ch("ProgramAttestationSendChunkIndeterminate"), h), one)
    b = torch.where(m_recv, chunk, zero)
    C.aff(A("hash", "ReceiveChunkRunningEvaluation"), a, b)

    # sponge running evaluation (mode 2, round 0)
    ci_term = gfx.bfe_mul(ch("HashCIWeight"), ci)
    m_any = _eqc(mode, 2) & rn0
    m_si = m_any & is_si
    m_sponge = m_any & ~is_si
    b = torch.where(m_si, ci_term, zero)
    b = torch.where(m_sponge, gfx.add(ci_term, compressed_row), b)
    a = torch.where(m_any, _bc(ch("SpongeIndeterminate"), h), one)
    C.aff(A("hash", "SpongeRunningEvaluation"), a, b)

    # hash-input running evaluation (mode 3, round 0)
    m_hin = _eqc(mode, 3) & rn0
    a = torch.where(m_hin, _bc(ch("HashInputIndeterminate"), h), one)
    b = torch.where(m_hin, compressed_row, zero)
    C.aff(A("hash", "HashInputRunningEvaluation"), a, b)

    # hash-digest running evaluation (mode 3, last round)
    digest_comp = _wsum([(sw[k], rate[k]) for k in range(5)])
    m_dig = _eqc(mode, 3) & _eqc(rn, tip5.NUM_ROUNDS)
    a = torch.where(m_dig, _bc(ch("HashDigestIndeterminate"), h), one)
    b = torch.where(m_dig, digest_comp, zero)
    C.aff(A("hash", "HashDigestRunningEvaluation"), a, b)

    # 16 cascade log derivatives
    active = ~_eqc(mode, 0) & ~_eqc(rn, tip5.NUM_ROUNDS) & ~is_si
    ones = torch.ones_like(mode)
    for k in range(4):
        for part in parts:
            lk_in = col(f"State{k}{part}LkIn")
            lk_out = col(f"State{k}{part}LkOut")
            comp = _wsum([(ch("HashCascadeLookInWeight"), lk_in),
                          (ch("HashCascadeLookOutWeight"), lk_out)])
            C.ld(A("hash", f"CascadeState{k}{part}ClientLogDerivative"),
                 ch("HashCascadeLookupIndeterminate"), comp, ones, active)


def _fac_u32(ctx, C):
    """table/u32.rs extension."""
    ch = ctx.ch
    active = _eqc(ctx.col("u32", "CopyFlag"), 1)
    compressed = _wsum([
        (ch("U32CiWeight"), ctx.col("u32", "CI")),
        (ch("U32LhsWeight"), ctx.col("u32", "LHS")),
        (ch("U32RhsWeight"), ctx.col("u32", "RHS")),
        (ch("U32ResultWeight"), ctx.col("u32", "Result"))])
    C.ld(A("u32", "LookupServerLogDerivative"),
         ch("U32Indeterminate"), compressed,
         ctx.col("u32", "LookupMultiplicity"), active)


# Each table maps to its factor functions; the processor table's are split
# four ways by argument family.
_TABLE_FAC = {
    "program": [_fac_program],
    "processor": [_fac_processor_io, _fac_processor_stack,
                  _fac_processor_hash, _fac_processor_u32],
    "op_stack": [_fac_op_stack],
    "ram": [_fac_ram],
    "jump_stack": [_fac_jump_stack],
    "hash": [_fac_hash],
    "cascade": [_fac_cascade],
    "lookup": [_fac_lookup],
    "u32": [_fac_u32],
}


# ===================================================== scans and assembly

def _phase_b1_fn(C):
    """Batched inversion + batched scans over every table's factors."""
    dens = torch.stack(C.ld_dens, dim=1)            # XFE (3, R, h)
    nums = torch.stack(C.ld_nums)                   # (R, h)
    masks = torch.stack(C.ld_masks)                 # (R, h)
    # masked rows may have a zero denominator: gfx.inv maps it to 0
    summands = gfx.bfe_mul(gfx.inv(dens), nums)
    summands = torch.where(masks, summands, 0)
    ld_sums = prefix_sum(summands)

    A_, B_ = affine_scan(torch.stack(C.aff_a, dim=1),
                         torch.stack(C.aff_b, dim=1))
    return {"ld": ld_sums, "aff": gfx.add(A_, B_)}


def _phase_b2(ctx, scans, ld_ids, aff_ids):
    """Assembly: per-column sums, the exclusive shift, the second-round
    scans. Returns the 49 AIR aux columns as int64 (49, 3, h)."""
    h, ch = ctx.h, ctx.ch
    vals = {}
    for i, cid in enumerate(ld_ids):
        row = scans["ld"][:, i]
        vals[cid] = gfx.add(vals[cid], row) if cid in vals else row
    # the program instruction-lookup server excludes its own row
    excl = A("program", "InstructionLookupServerLogDerivative")
    vals[excl] = _prev_gfx(vals[excl])
    for i, cid in enumerate(aff_ids):
        vals[cid] = scans["aff"][:, i]
    one, zero = ctx.one, ctx.zero

    # --- round 2a: Program.SendChunk consumes PrepareChunk
    prep = vals[A("program", "PrepareChunkRunningEvaluation")]
    table_pad = ctx.col("program", "IsTablePadding")
    idx_in_chunk = ctx.col("program", "IndexInChunk")
    send_mask = _eqc(table_pad, 0) & _eqc(idx_in_chunk, tip5.RATE - 1)
    a_s = torch.where(
        send_mask, _bc(ch("ProgramAttestationSendChunkIndeterminate"), h),
        one)
    b_s = torch.where(send_mask, prep, zero)

    # --- round 2b: Ram.FormalDerivative consumes RunningProductOfRAMP
    rp = vals[A("ram", "RunningProductOfRAMP")]
    itype = ctx.col("ram", "InstructionType")
    ptr = ctx.col("ram", "RamPointer")
    bez = ch("RamTableBezoutRelationIndeterminate")
    change = ~_eqc(itype, 2) & (ptr != _prev_gf(ptr)) & (ctx.rows > 0)
    beta_minus_ptr = gfx.sub(_bc(bez, h), _lift(ptr))
    # row 0: fd = 1 (identity map on acc0 = 1)
    a_f = torch.where(change, beta_minus_ptr, one)
    b_f = torch.where(change, _prev_gfx(rp), zero)

    A2, B2 = affine_scan(torch.stack([a_s, a_f], dim=1),
                         torch.stack([b_s, b_f], dim=1))
    r2 = gfx.add(A2, B2)
    vals[A("program", "SendChunkRunningEvaluation")] = r2[:, 0]
    vals[A("ram", "FormalDerivative")] = r2[:, 1]

    assert sorted(vals) == list(range(columns.NUM_AUX_AIR_COLUMNS))
    return torch.stack([vals[i] for i in range(columns.NUM_AUX_AIR_COLUMNS)])


def _run_pipeline(main, challenges):
    """The 49 AIR aux columns, int64 (49, 3, h), on main's device."""
    ctx = _Ctx(main, challenges)
    C = _Collector(ctx.h)
    with profiler.device_span("aux factors", "witness", ctx.device):
        for table in columns.TABLE_IDS:
            for fac in _TABLE_FAC[table]:
                fac(ctx, C)
    with profiler.device_span("aux scans", "witness", ctx.device):
        scans = _phase_b1_fn(C)
        return _phase_b2(ctx, scans, C.ld_ids, C.aff_ids)


def _challenges_dev(challenges, device):
    """The 63 challenges (a Challenges or a list of XFE tuples) as an XFE
    tensor (3, 63)."""
    arr = np.array([challenges[i] for i in range(NUM_CHALLENGES)], np.uint64)
    return gfx.from_u64(arr, device)


def extend_all_device(main: np.ndarray, challenges, device) -> np.ndarray:
    """Counterpart of the JAX package's `tables.master.extend_host` on
    `device`: all 9 tables, 49 aux columns. Returns the host
    (h, NUM_AUX, 3) array with the AIR columns filled."""
    h = main.shape[0]
    air = _run_pipeline(gf.from_u64(np.ascontiguousarray(main.T), device),
                        _challenges_dev(challenges, device))
    aux = np.zeros((h, NUM_AUX, 3), np.uint64)
    aux[:, :columns.NUM_AUX_AIR_COLUMNS] = gf.to_u64(air).transpose(2, 0, 1)
    return aux


# ========================================================== derived columns
# Tape evaluation of the degree-lowering substitutions: all 230 main / 41
# aux derived columns in one tape each.
#
# Substitution RHSes may read earlier derived columns (within a phase, and
# later phases may read earlier phases' columns). Rather than sequencing
# 271 dependent fills, the chains are INLINED: every read of a derived
# column is replaced by that column's (already-rewritten) RHS node, giving
# one row-local DAG whose outputs are all derived columns at once. A
# NEXT-row read of a derived column inlines the RHS with its inputs shifted
# current->next (well-defined because single-row phases are row-local and
# tran-phase variables are never read at NEXT; the reference's generated
# fill would panic otherwise, substitutions.rs:266-301). Transition-phase
# outputs zero their last row, like the reference's s![0..num_rows-1]
# dual-row fill.

@functools.lru_cache(maxsize=None)
def _derived_fill_tape(main_only: bool):
    """(tape, [(kind, col)], [zero_last_row]) for the inlined DAG."""
    from ..air import circuit as C
    from ..air.compile import compile_tape
    from ..air.evaluate import linearize, substitution_pairs
    from ..air.master import master_air

    air = master_air()
    subs_by_phase = air.main_subs if main_only else air.aux_subs
    fresh = itertools.count(1)
    derived: dict[tuple, C.Node] = {}  # (MAIN|AUX, col) -> rewritten RHS
    # Node ids are only unique within one phase's circuit (each phase
    # builds its own, air/master.py), so the combined DAG is rebuilt with
    # fresh globally-unique ids. Memo keys use OBJECT identity (nodes are
    # hash-consed within a circuit), never node.id.
    memo: dict[tuple, C.Node] = {}

    def clone(node, shift):
        key = (id(node), shift)
        if key in memo:
            return memo[key]
        if node.kind == "input":
            ik, col = node.value
            base_ik = {C.NEXT_MAIN: C.MAIN, C.NEXT_AUX: C.AUX}.get(ik, ik)
            if (base_ik, col) in derived:
                want_shift = shift or ik in (C.NEXT_MAIN, C.NEXT_AUX)
                assert not (shift and ik in (C.NEXT_MAIN, C.NEXT_AUX)), \
                    "derived column read two rows ahead"
                res = clone(derived[(base_ik, col)], want_shift)
            else:
                if shift:
                    assert ik in (C.MAIN, C.AUX), \
                        "cannot shift an already-next-row input"
                    ik = C.NEXT_MAIN if ik == C.MAIN else C.NEXT_AUX
                res = C.Node(next(fresh), "input", (ik, col))
        elif node.kind != "binop":
            res = C.Node(next(fresh), node.kind, node.value)
        else:
            lhs = clone(node.lhs, shift)
            rhs = clone(node.rhs, shift)
            res = C.Node(next(fresh), "binop", op=node.op, lhs=lhs, rhs=rhs)
        memo[key] = res
        return res

    exprs, cols, zero_last = [], [], []
    for phase in ("init", "cons", "tran", "term"):
        for kind, col, rhs in substitution_pairs(subs_by_phase[phase]):
            node = clone(rhs, False)
            derived[(kind, col)] = node
            exprs.append(C.Expr(None, node))
            cols.append((kind, col))
            zero_last.append(phase == "tran")

    steps, out_ids = linearize(exprs)
    return compile_tape(steps, out_ids), tuple(cols), tuple(zero_last)


# Rows of one pass of a derived-column tape: its value banks and group
# temporaries are O(slots x rows) of device memory (the aux tape has 247
# base and 390 extension slots), so tall tables run in chunks.
_FILL_CHUNK_ROWS = 1 << 17


def _derived_fill_fn(main_only: bool, main_cols, aux_cols, challenges):
    """Run the derived-column tape over all rows, in chunks of
    _FILL_CHUNK_ROWS rows, each with its next rows (the row after the
    chunk's last, cyclically) gathered. main_cols: int64 (nm, h);
    aux_cols: XFE (3, na, h) or None; challenges: XFE (3, 63) or None.
    Returns (XFE (3, n_derived, h), column ids); base outputs are lifted."""
    from ..air.compile import run_tape_scan

    tape, cols, zero_last = _derived_fill_tape(main_only)
    dev = main_cols.device
    h = main_cols.shape[-1]
    out = torch.empty((3, len(cols), h), dtype=torch.int64, device=dev)
    for s in range(0, h, _FILL_CHUNK_ROWS):
        e = min(s + _FILL_CHUNK_ROWS, h)
        idx = torch.arange(s, e, device=dev)
        nidx = (idx + 1) % h
        out[:, :, s:e] = run_tape_scan(
            tape, main_cols.index_select(1, idx),
            None if aux_cols is None else aux_cols.index_select(2, idx),
            challenges, next_main=main_cols.index_select(1, nidx),
            next_aux=(None if aux_cols is None
                      else aux_cols.index_select(2, nidx)))
    out[:, torch.as_tensor(zero_last, device=dev), -1] = 0
    return out, [col for _, col in cols]


# ================================================= device-resident witness

def main_witness_dev(main_np: np.ndarray, device):
    """numpy (h, 379) main table with its 149 AIR columns filled -> int64
    (379, h) on `device`, the 230 derived columns computed there. One
    upload; equal to the JAX package's `fill_derived_main_columns`
    (tests/test_torch_witness.py)."""
    h = main_np.shape[0]
    n_air = columns.NUM_MAIN_AIR_COLUMNS
    with profiler.device_span("main derived columns", "witness",
                              torch.device(device)):
        air = gf.from_u64(np.ascontiguousarray(main_np[:, :n_air].T), device)
        tape = _derived_fill_tape(True)[0]
        assert tape.main_cols.size == 0 or tape.main_cols.max() < n_air
        out, cols = _derived_fill_fn(True, air, None, None)
        main = torch.zeros((NUM_MAIN, h), dtype=gf.I64, device=air.device)
        main[:n_air] = air
        main[cols] = out[0]
        return main


def aux_witness_dev(main_dev, challenges, batch_randomizer):
    """int64 main (379, h) -> the aux witness as int64 (NUM_AUX, 3, h) on
    the same device: the 49 scan columns, the 41 derived columns and the
    batch-randomizer column (an XFE tensor (3, h) on that device). Equal
    to the JAX package's `extend_host` + `fill_derived_aux_columns` + the
    randomizer write."""
    dev = main_dev.device
    h = main_dev.shape[1]
    n_air = columns.NUM_AUX_AIR_COLUMNS
    ch = _challenges_dev(challenges, dev)
    air = _run_pipeline(main_dev, ch)                       # (49, 3, h)
    with profiler.device_span("aux derived columns", "witness", dev):
        tape = _derived_fill_tape(False)[0]
        assert tape.aux_cols.size == 0 or tape.aux_cols.max() < n_air
        out, cols = _derived_fill_fn(False, main_dev, air.permute(1, 0, 2),
                                     ch)
        aux = torch.zeros((NUM_AUX, 3, h), dtype=gf.I64, device=dev)
        aux[:n_air] = air
        aux[cols] = out.permute(1, 0, 2)
        aux[NUM_AUX - 1] = batch_randomizer
        return aux
