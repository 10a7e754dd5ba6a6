"""The Triton VM interpreter (host-side, sequential by nature).

Mirrors triton-vm/src/vm.rs: `VMState` layout (vm.rs:50-104),
`step` dispatch (vm.rs:362-428), helper-variable derivation (vm.rs:270-349),
coprocessor call emission (vm.rs:109-124), and `to_processor_row`
(vm.rs:1113-1170). All field elements are Python ints in [0, p).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..crypto import tip5
from ..fields.bfe import P
from ..isa.instruction import Instruction
from ..isa.program import Program
from ..utils import profiler as _profiler

DIGEST_LEN = 5
NUM_HELPER_VARS = 6


from .. import errors as E


class VMError(Exception):
    """VM failure wrapper: `source` is the typed InstructionError
    (reference vm.rs `VMError { source, vm_state }`, error taxonomy at
    triton-isa instruction.rs:867-945)."""

    def __init__(self, source, state: Optional["VMState"] = None):
        from .. import errors as E

        super().__init__(str(source))
        self.source = source if isinstance(source, E.InstructionError) \
            else None
        self.state = state


@dataclass
class PublicInput:
    individual_tokens: list[int] = field(default_factory=list)

    @classmethod
    def new(cls, tokens):
        return cls([t % P for t in tokens])


@dataclass
class NonDeterminism:
    individual_tokens: list[int] = field(default_factory=list)
    digests: list[tuple] = field(default_factory=list)
    ram: dict = field(default_factory=dict)

    def with_digests(self, digests):
        self.digests = [tuple(d) for d in digests]
        return self

    def with_ram(self, ram):
        self.ram = {int(k) % P: int(v) % P for k, v in ram.items()}
        return self


# ------------------------------------------------------- coprocessor calls

@dataclass
class SpongeStateReset:
    pass


@dataclass
class Tip5Trace:
    instruction: str  # 'hash' or 'sponge_absorb' or 'sponge_squeeze'
    trace: list  # 6 states of 16 elements


@dataclass
class U32Call:
    instruction: str  # canonical instruction charged in the U32 table
    lhs: int
    rhs: int


@dataclass
class OpStackCall:
    clk: int
    op_stack_pointer: int
    is_write: bool  # grows stack
    first_underflow_element: int


@dataclass
class RamCall:
    clk: int
    ram_pointer: int
    ram_value: int
    is_write: bool


def op_stack_calls_from_underflow_io(clk, pointer_after, sequence):
    """OpStackTableEntry::from_underflow_io_sequence
    (triton-vm/src/table/op_stack.rs:61-87)."""
    seq = list(sequence)
    # canonicalize: remove adjacent dual pairs (Read(x),Write(x)) etc.
    changed = True
    while changed:
        changed = False
        for i in range(len(seq) - 1):
            (w1, v1), (w2, v2) = seq[i], seq[i + 1]
            if w1 != w2 and v1 == v2:
                del seq[i:i + 2]
                changed = True
                break
    if not seq:
        return []
    assert all(w == seq[0][0] for w, _ in seq), "non-uniform underflow IO"
    is_writing = seq[0][0]
    pointer = (pointer_after - len(seq)) if is_writing else (pointer_after + len(seq))
    out = []
    for is_write, payload in seq:
        if not is_write:
            pointer -= 1
        out.append(OpStackCall(clk, pointer % P, is_write, payload))
        if is_write:
            pointer += 1
    return out


class OpStack:
    """Stack (top at the end) with underflow-IO recording
    (triton-isa/src/op_stack.rs:38-220)."""

    def __init__(self, program_digest):
        # bottom-first vec; reversed digest occupies the deepest slots
        # ST11..ST15 (op_stack.rs:new)
        self.stack = list(reversed(program_digest)) + [0] * 11
        self.underflow_io = []  # list of (is_write, payload)

    def __len__(self):
        return len(self.stack)

    def __getitem__(self, i):
        return self.stack[len(self.stack) - 1 - i]

    def __setitem__(self, i, v):
        self.stack[len(self.stack) - 1 - i] = v % P

    def first_underflow_element(self):
        idx = len(self.stack) - 1 - 16
        return self.stack[idx] if idx >= 0 else 0

    def _record(self, is_write):
        self.underflow_io.append((is_write, self.first_underflow_element()))

    def push(self, v):
        self.stack.append(v % P)
        self._record(True)

    def pop(self):
        self._record(False)
        if not self.stack:
            raise VMError(E.OpStackTooShallow("op stack too shallow"))
        return self.stack.pop()

    def insert(self, index, element):
        self.stack.insert(len(self.stack) - index, element % P)
        self._record(True)

    def remove(self, index):
        self._record(False)
        return self.stack.pop(len(self.stack) - 1 - index)

    def start_recording(self):
        self.underflow_io.clear()

    def stop_recording(self):
        seq, self.underflow_io = self.underflow_io, []
        return seq

    def would_be_too_shallow(self, delta):
        return len(self.stack) + delta < 16

    def pointer(self):
        return len(self.stack)

    def pop_u32(self):
        v = self.pop()
        if v >= 1 << 32:
            raise VMError(E.FailedU32Conversion(f"failed u32 conversion: {v}"))
        return v

    def get_u32(self, i):
        v = self[i]
        if v >= 1 << 32:
            raise VMError(E.FailedU32Conversion(f"failed u32 conversion: {v}"))
        return v

    def peek_xfe(self, idx):
        return (self[idx], self[idx + 1], self[idx + 2])

    def pop_xfe(self):
        c0, c1, c2 = self.pop(), self.pop(), self.pop()
        return (c0, c1, c2)

    def push_xfe(self, x):
        self.push(x[2])
        self.push(x[1])
        self.push(x[0])


def _tip5_fixed_length_state(rate_input):
    return list(rate_input) + [1] * 6


class VMState:
    def __init__(self, program: Program, public_input=None, non_determinism=None):
        # `impl Into<PublicInput>` ergonomics (vm.rs / lib.rs:228): raw
        # token sequences coerce to PublicInput / NonDeterminism.
        if public_input is None:
            public_input = PublicInput()
        elif not isinstance(public_input, PublicInput):
            public_input = PublicInput(list(public_input))
        if non_determinism is None:
            non_determinism = NonDeterminism()
        elif not isinstance(non_determinism, NonDeterminism):
            non_determinism = NonDeterminism(list(non_determinism))
        self.program = program
        self.public_input = deque(t % P for t in public_input.individual_tokens)
        self.public_output: list[int] = []
        self.secret_individual_tokens = deque(
            t % P for t in non_determinism.individual_tokens)
        self.secret_digests = deque(tuple(d) for d in non_determinism.digests)
        self.ram = {int(k) % P: int(v) % P for k, v in non_determinism.ram.items()}
        self.ram_calls: list[RamCall] = []
        self.op_stack = OpStack(program.hash())
        self.jump_stack: list[tuple[int, int]] = []
        self.cycle_count = 0
        self.instruction_pointer = 0
        self.sponge: Optional[list[int]] = None
        self.halting = False

    # ------------------------------------------------------------ plumbing

    def current_instruction(self) -> Instruction:
        ins = self.program.instruction_at(self.instruction_pointer)
        if ins is None:
            raise VMError(E.InstructionPointerOverflow("instruction pointer overflow"), self)
        return ins

    def next_instruction(self) -> Instruction:
        cur = self.current_instruction()
        ins = self.program.instruction_at(self.instruction_pointer + cur.size())
        if ins is None:
            raise VMError(E.InstructionPointerOverflow("instruction pointer overflow"), self)
        return ins

    def next_instruction_or_argument(self) -> int:
        try:
            cur = self.current_instruction()
        except VMError:
            return 0
        if cur.arg_kind is not None:
            return (cur.arg if cur.arg_kind in ("bfe", "call")
                    else cur.arg) % P
        try:
            return self.next_instruction().opcode
        except VMError:
            return 1  # hash-input padding separator (vm.rs:1180)

    def _ram_read(self, addr):
        addr %= P
        value = self.ram.get(addr, 0)
        self.ram_calls.append(RamCall(self.cycle_count, addr, value, False))
        return value

    def _ram_write(self, addr, value):
        addr %= P
        self.ram_calls.append(RamCall(self.cycle_count, addr, value % P, True))
        self.ram[addr] = value % P

    # ------------------------------------------------------ helper variables

    def derive_helper_variables(self):
        hvs = [0] * NUM_HELPER_VARS
        try:
            ins = self.current_instruction()
        except VMError:
            return hvs
        st = self.op_stack
        name = ins.name

        def inverse_or_zero(x):
            return pow(x, P - 2, P) if x % P else 0

        def ram_peek(addr):
            return self.ram.get(addr % P, 0)

        if name in ("pop", "divine", "pick", "place", "dup", "swap",
                    "read_mem", "write_mem", "read_io", "write_io"):
            a = ins.arg
            hvs[0], hvs[1], hvs[2], hvs[3] = a % 2, (a >> 1) % 2, (a >> 2) % 2, (a >> 3) % 2
        elif name == "skiz":
            hvs[0] = inverse_or_zero(st[0])
            nia = self.next_instruction_or_argument()
            hvs[1] = nia % 2
            hvs[2] = (nia >> 1) % 4
            hvs[3] = (nia >> 3) % 4
            hvs[4] = (nia >> 5) % 4
            hvs[5] = nia >> 7
        elif name == "recurse_or_return":
            hvs[0] = inverse_or_zero((st[6] - st[5]) % P)
        elif name == "sponge_absorb_mem":
            for i in range(6):
                hvs[i] = ram_peek(st[0] + 4 + i)
        elif name == "merkle_step":
            digest = self.secret_digests[0] if self.secret_digests else (0,) * 5
            hvs[:5] = list(digest)
            hvs[5] = st[5] % 2
        elif name == "merkle_step_mem":
            ptr = st[7]
            for i in range(5):
                hvs[i] = ram_peek(ptr + i)
            hvs[5] = st[5] % 2
        elif name == "split":
            top = st[0]
            lo = top & 0xFFFFFFFF
            hi = top >> 32
            if lo != 0:
                hvs[0] = inverse_or_zero((hi - 0xFFFFFFFF) % P)
        elif name == "eq":
            hvs[0] = inverse_or_zero((st[1] - st[0]) % P)
        elif name == "b_horner_step":
            hvs[0] = ram_peek(st[5])
        elif name == "x_horner_step":
            hvs[2] = ram_peek(st[5])
            hvs[1] = ram_peek(st[5] - 1)
            hvs[0] = ram_peek(st[5] - 2)
        return hvs

    # -------------------------------------------------------------- stepping

    def step(self):
        """Execute one instruction; returns the coprocessor calls."""
        if self.halting:
            raise VMError(E.MachineHalted("machine halted"), self)
        ins = self.current_instruction()
        if self.op_stack.would_be_too_shallow(ins.op_stack_size_influence()):
            raise VMError(E.OpStackTooShallow("op stack too shallow"), self)

        self.op_stack.start_recording()
        calls = getattr(self, "_op_" + ins.name)(ins)
        seq = self.op_stack.stop_recording()
        calls = list(calls) + op_stack_calls_from_underflow_io(
            self.cycle_count, self.op_stack.pointer(), seq)
        self.cycle_count += 1
        return calls

    def run(self):
        while not self.halting:
            self.step()
        return self.public_output

    def _take_ram_calls(self):
        calls, self.ram_calls = self.ram_calls, []
        return calls

    # ------------------------------------------------- instruction handlers

    def _op_pop(self, ins):
        for _ in range(ins.arg):
            self.op_stack.pop()
        self.instruction_pointer += 2
        return []

    def _op_push(self, ins):
        self.op_stack.push(ins.arg)
        self.instruction_pointer += 2
        return []

    def _op_divine(self, ins):
        if len(self.secret_individual_tokens) < ins.arg:
            raise VMError(E.EmptySecretInput("empty secret input"), self)
        for _ in range(ins.arg):
            self.op_stack.push(self.secret_individual_tokens.popleft())
        self.instruction_pointer += 2
        return []

    def _op_pick(self, ins):
        elem = self.op_stack.remove(ins.arg)
        self.op_stack.push(elem)
        self.instruction_pointer += 2
        return []

    def _op_place(self, ins):
        elem = self.op_stack.pop()
        self.op_stack.insert(ins.arg, elem)
        self.instruction_pointer += 2
        return []

    def _op_dup(self, ins):
        self.op_stack.push(self.op_stack[ins.arg])
        self.instruction_pointer += 2
        return []

    def _op_swap(self, ins):
        st = self.op_stack
        st[0], st[ins.arg] = st[ins.arg], st[0]
        self.instruction_pointer += 2
        return []

    def _op_halt(self, ins):
        self.halting = True
        self.instruction_pointer += 1
        return []

    def _op_nop(self, ins):
        self.instruction_pointer += 1
        return []

    def _op_skiz(self, ins):
        top = self.op_stack.pop()
        if top == 0:
            self.instruction_pointer += 1 + self.next_instruction().size()
        else:
            self.instruction_pointer += 1
        return []

    def _op_call(self, ins):
        origin = self.instruction_pointer + 2
        self.jump_stack.append((origin, ins.arg))
        self.instruction_pointer = ins.arg
        return []

    def _op_return(self, ins):
        if not self.jump_stack:
            raise VMError(E.JumpStackIsEmpty("jump stack is empty"), self)
        origin, _ = self.jump_stack.pop()
        self.instruction_pointer = origin
        return []

    def _op_recurse(self, ins):
        if not self.jump_stack:
            raise VMError(E.JumpStackIsEmpty("jump stack is empty"), self)
        _, dest = self.jump_stack[-1]
        self.instruction_pointer = dest
        return []

    def _op_recurse_or_return(self, ins):
        if not self.jump_stack:
            raise VMError(E.JumpStackIsEmpty("jump stack is empty"), self)
        st = self.op_stack
        if st[5] == st[6]:
            origin, _ = self.jump_stack.pop()
            self.instruction_pointer = origin
        else:
            _, dest = self.jump_stack[-1]
            self.instruction_pointer = dest
        return []

    def _op_assert(self, ins):
        if self.op_stack[0] != 1:
            ctx = self.program.assertion_contexts.get(self.instruction_pointer)
            failure = E.AssertionFailure(
                expected=1, actual=self.op_stack[0],
                id=ctx.error_id if ctx else None)
            raise VMError(E.AssertionFailed(failure), self)
        self.op_stack.pop()
        self.instruction_pointer += 1
        return []

    def _op_read_mem(self, ins):
        ptr = self.op_stack.pop()
        for _ in range(ins.arg):
            self.op_stack.push(self._ram_read(ptr))
            ptr = (ptr - 1) % P
        self.op_stack.push(ptr)
        self.instruction_pointer += 2
        return self._take_ram_calls()

    def _op_write_mem(self, ins):
        ptr = self.op_stack.pop()
        for _ in range(ins.arg):
            value = self.op_stack.pop()
            self._ram_write(ptr, value)
            ptr = (ptr + 1) % P
        self.op_stack.push(ptr)
        self.instruction_pointer += 2
        return self._take_ram_calls()

    def _op_hash(self, ins):
        to_hash = [self.op_stack.pop() for _ in range(10)]
        trace = tip5.permutation_trace(_tip5_fixed_length_state(to_hash))
        digest = trace[-1][:DIGEST_LEN]
        for v in reversed(digest):
            self.op_stack.push(v)
        self.instruction_pointer += 1
        return [Tip5Trace("hash", trace)]

    def _op_assert_vector(self, ins):
        for i in range(DIGEST_LEN):
            if self.op_stack[i] != self.op_stack[i + DIGEST_LEN]:
                ctx = self.program.assertion_contexts.get(self.instruction_pointer)
                failure = E.AssertionFailure(
                    expected=self.op_stack[i],
                    actual=self.op_stack[i + DIGEST_LEN],
                    id=ctx.error_id if ctx else None)
                raise VMError(E.VectorAssertionFailed(i, failure), self)
        for _ in range(DIGEST_LEN):
            self.op_stack.pop()
        self.instruction_pointer += 1
        return []

    def _op_sponge_init(self, ins):
        self.sponge = [0] * 16
        self.instruction_pointer += 1
        return [SpongeStateReset()]

    def _op_sponge_absorb(self, ins):
        if self.sponge is None:
            raise VMError(E.SpongeNotInitialized("sponge not initialized"), self)
        chunk = [self.op_stack.pop() for _ in range(10)]
        self.sponge[:10] = chunk
        trace = tip5.permutation_trace(self.sponge)
        self.sponge = list(trace[-1])
        self.instruction_pointer += 1
        return [Tip5Trace("sponge_absorb", trace)]

    def _op_sponge_absorb_mem(self, ins):
        if self.sponge is None:
            raise VMError(E.SpongeNotInitialized("sponge not initialized"), self)
        ptr = self.op_stack.pop()
        for i in range(10):
            elem = self._ram_read(ptr)
            ptr = (ptr + 1) % P
            self.sponge[i] = elem
            if i < 10 - NUM_HELPER_VARS:
                self.op_stack[i] = elem
        self.op_stack.push(ptr)
        trace = tip5.permutation_trace(self.sponge)
        self.sponge = list(trace[-1])
        self.instruction_pointer += 1
        return self._take_ram_calls() + [Tip5Trace("sponge_absorb", trace)]

    def _op_sponge_squeeze(self, ins):
        if self.sponge is None:
            raise VMError(E.SpongeNotInitialized("sponge not initialized"), self)
        for i in reversed(range(10)):
            self.op_stack.push(self.sponge[i])
        trace = tip5.permutation_trace(self.sponge)
        self.sponge = list(trace[-1])
        self.instruction_pointer += 1
        return [Tip5Trace("sponge_squeeze", trace)]

    def _op_add(self, ins):
        lhs = self.op_stack.pop()
        rhs = self.op_stack.pop()
        self.op_stack.push((lhs + rhs) % P)
        self.instruction_pointer += 1
        return []

    def _op_addi(self, ins):
        self.op_stack[0] = (self.op_stack[0] + ins.arg) % P
        self.instruction_pointer += 2
        return []

    def _op_mul(self, ins):
        lhs = self.op_stack.pop()
        rhs = self.op_stack.pop()
        self.op_stack.push(lhs * rhs % P)
        self.instruction_pointer += 1
        return []

    def _op_invert(self, ins):
        top = self.op_stack[0]
        if top == 0:
            raise VMError(E.InverseOfZero("inverse of zero"), self)
        self.op_stack.pop()
        self.op_stack.push(pow(top, P - 2, P))
        self.instruction_pointer += 1
        return []

    def _op_eq(self, ins):
        lhs = self.op_stack.pop()
        rhs = self.op_stack.pop()
        self.op_stack.push(1 if lhs == rhs else 0)
        self.instruction_pointer += 1
        return []

    def _op_split(self, ins):
        top = self.op_stack.pop()
        lo = top & 0xFFFFFFFF
        hi = top >> 32
        self.op_stack.push(hi)
        self.op_stack.push(lo)
        self.instruction_pointer += 1
        return [U32Call("split", lo, hi)]

    def _op_lt(self, ins):
        self.op_stack.get_u32(0)
        self.op_stack.get_u32(1)
        lhs = self.op_stack.pop_u32()
        rhs = self.op_stack.pop_u32()
        self.op_stack.push(1 if lhs < rhs else 0)
        self.instruction_pointer += 1
        return [U32Call("lt", lhs, rhs)]

    def _op_and(self, ins):
        self.op_stack.get_u32(0)
        self.op_stack.get_u32(1)
        lhs = self.op_stack.pop_u32()
        rhs = self.op_stack.pop_u32()
        self.op_stack.push(lhs & rhs)
        self.instruction_pointer += 1
        return [U32Call("and", lhs, rhs)]

    def _op_xor(self, ins):
        self.op_stack.get_u32(0)
        self.op_stack.get_u32(1)
        lhs = self.op_stack.pop_u32()
        rhs = self.op_stack.pop_u32()
        self.op_stack.push(lhs ^ rhs)
        self.instruction_pointer += 1
        # a ^ b = a + b - 2*(a & b): charged as `and` (vm.rs:854-861)
        return [U32Call("and", lhs, rhs)]

    def _op_log_2_floor(self, ins):
        self.op_stack.get_u32(0)
        if self.op_stack[0] == 0:
            raise VMError(E.LogarithmOfZero("logarithm of zero"), self)
        top = self.op_stack.pop_u32()
        self.op_stack.push(top.bit_length() - 1)
        self.instruction_pointer += 1
        return [U32Call("log_2_floor", top, 0)]

    def _op_pow(self, ins):
        self.op_stack.get_u32(1)
        base = self.op_stack.pop()
        exponent = self.op_stack.pop_u32()
        self.op_stack.push(pow(base, exponent, P))
        self.instruction_pointer += 1
        return [U32Call("pow", base, exponent)]

    def _op_div_mod(self, ins):
        self.op_stack.get_u32(0)
        self.op_stack.get_u32(1)
        if self.op_stack[1] == 0:
            raise VMError(E.DivisionByZero("division by zero"), self)
        numerator = self.op_stack.pop_u32()
        denominator = self.op_stack.pop_u32()
        quotient, remainder = divmod(numerator, denominator)
        self.op_stack.push(quotient)
        self.op_stack.push(remainder)
        self.instruction_pointer += 1
        return [U32Call("lt", remainder, denominator),
                U32Call("split", numerator, quotient)]

    def _op_pop_count(self, ins):
        self.op_stack.get_u32(0)
        top = self.op_stack.pop_u32()
        self.op_stack.push(bin(top).count("1"))
        self.instruction_pointer += 1
        return [U32Call("pop_count", top, 0)]

    def _op_xx_add(self, ins):
        from ..fields import xfe
        lhs = self.op_stack.pop_xfe()
        rhs = self.op_stack.pop_xfe()
        self.op_stack.push_xfe(xfe.add(lhs, rhs))
        self.instruction_pointer += 1
        return []

    def _op_xx_mul(self, ins):
        from ..fields import xfe
        lhs = self.op_stack.pop_xfe()
        rhs = self.op_stack.pop_xfe()
        self.op_stack.push_xfe(xfe.mul(lhs, rhs))
        self.instruction_pointer += 1
        return []

    def _op_x_invert(self, ins):
        from ..fields import xfe
        top = self.op_stack.peek_xfe(0)
        if top == xfe.ZERO:
            raise VMError(E.InverseOfZero("inverse of zero"), self)
        inverse = xfe.inv(top)
        self.op_stack.pop_xfe()
        self.op_stack.push_xfe(inverse)
        self.instruction_pointer += 1
        return []

    def _op_xb_mul(self, ins):
        from ..fields import xfe
        lhs = self.op_stack.pop()
        rhs = self.op_stack.pop_xfe()
        self.op_stack.push_xfe(xfe.bfe_mul(rhs, lhs))
        self.instruction_pointer += 1
        return []

    def _op_write_io(self, ins):
        for _ in range(ins.arg):
            self.public_output.append(self.op_stack.pop())
        self.instruction_pointer += 2
        return []

    def _op_read_io(self, ins):
        if len(self.public_input) < ins.arg:
            raise VMError(E.EmptyPublicInput("empty public input"), self)
        for _ in range(ins.arg):
            self.op_stack.push(self.public_input.popleft())
        self.instruction_pointer += 2
        return []

    def _op_merkle_step(self, ins):
        self.op_stack.get_u32(5)
        if not self.secret_digests:
            raise VMError(E.EmptySecretDigestInput("empty secret digest input"), self)
        sibling = self.secret_digests.popleft()
        return self._merkle_step(sibling)

    def _op_merkle_step_mem(self, ins):
        self.op_stack.get_u32(5)
        ptr = self.op_stack[7]
        sibling = []
        for i in range(DIGEST_LEN):
            sibling.append(self._ram_read(ptr))
            ptr = (ptr + 1) % P
        self.op_stack[7] = ptr
        calls = self._merkle_step(tuple(sibling))
        return calls + self._take_ram_calls()

    def _merkle_step(self, sibling):
        node_index = self.op_stack.get_u32(5)
        parent_index = node_index // 2
        acc = [self.op_stack.pop() for _ in range(DIGEST_LEN)]
        if node_index % 2 == 0:
            left, right = acc, list(sibling)
        else:
            left, right = list(sibling), acc
        trace = tip5.permutation_trace(
            _tip5_fixed_length_state(left + right))
        digest = trace[-1][:DIGEST_LEN]
        for v in reversed(digest):
            self.op_stack.push(v)
        self.op_stack[5] = parent_index
        self.instruction_pointer += 1
        return [Tip5Trace("hash", trace),
                U32Call("split", node_index, parent_index)]

    def _op_b_horner_step(self, ins):
        from ..fields import xfe
        ptr = self.op_stack[5]
        coefficient = self._ram_read(ptr)
        self.op_stack[5] = (ptr - 1) % P
        indeterminate = self.op_stack.peek_xfe(0)
        acc = self.op_stack.peek_xfe(7)
        acc = xfe.add(xfe.mul(acc, indeterminate), xfe.lift(coefficient))
        self.op_stack[7], self.op_stack[8], self.op_stack[9] = acc
        self.instruction_pointer += 1
        return self._take_ram_calls()

    def _op_x_horner_step(self, ins):
        from ..fields import xfe
        ptr = self.op_stack[5]
        coeffs = [0, 0, 0]
        for i in (2, 1, 0):
            coeffs[i] = self._ram_read(ptr)
            ptr = (ptr - 1) % P
        self.op_stack[5] = ptr
        indeterminate = self.op_stack.peek_xfe(0)
        acc = self.op_stack.peek_xfe(7)
        acc = xfe.add(xfe.mul(acc, indeterminate), tuple(coeffs))
        self.op_stack[7], self.op_stack[8], self.op_stack[9] = acc
        self.instruction_pointer += 1
        return self._take_ram_calls()

    # ------------------------------------------------------- processor row

    def to_processor_row(self):
        """39 main columns in ProcessorMainColumn order (vm.rs:1113-1170)."""
        try:
            ins = self.current_instruction()
        except VMError:
            ins = Instruction("nop")
        st = self.op_stack
        jsp = len(self.jump_stack)
        jso, jsd = self.jump_stack[-1] if self.jump_stack else (0, 0)
        hvs = self.derive_helper_variables()
        row = [
            self.cycle_count,            # CLK
            0,                           # IsPadding
            self.instruction_pointer,    # IP
            ins.opcode,                  # CI
            self.next_instruction_or_argument(),  # NIA
            ins.ib(0), ins.ib(1), ins.ib(2), ins.ib(3),
            ins.ib(4), ins.ib(5), ins.ib(6),
            jsp, jso, jsd,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
            st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
            st.pointer(),                # OpStackPointer
            hvs[0], hvs[1], hvs[2], hvs[3], hvs[4], hvs[5],
            0,                           # ClockJumpDifferenceLookupMultiplicity
        ]
        return row


class VM:
    @staticmethod
    def run(program, public_input=None, non_determinism=None):
        state = VMState(program, public_input, non_determinism)
        return state.run()

    @staticmethod
    def trace_execution(program, public_input=None, non_determinism=None):
        from .aet import AlgebraicExecutionTrace

        with _profiler.span("VM state", "VM"):
            state = VMState(program, public_input, non_determinism)
        # C++ witness core (native/vm_core.cpp); bit-identical AET,
        # tests/test_native_vm.py. Falls through to the Python
        # interpreter when unavailable — and on any VM error, so the
        # typed error taxonomy has a single implementation.
        from . import native

        result = native.trace_execution_native(
            state.program, PublicInput(list(state.public_input)),
            NonDeterminism(list(state.secret_individual_tokens),
                           list(state.secret_digests),
                           dict(state.ram)))
        if result is not None:
            return result
        with _profiler.span("interpreter run", "VM"):
            aet = AlgebraicExecutionTrace(program)
            while not state.halting:
                aet.record_state(state)
                for call in state.step():
                    aet.record_co_processor_call(call)
        return aet, state.public_output

    @staticmethod
    def profile(program, public_input=None, non_determinism=None):
        """Run `program` and profile which callable blocks contribute
        which table heights (vm.rs:208-242). Returns
        (public_output, ExecutionTraceProfile)."""
        from .aet import AlgebraicExecutionTrace
        from .execution_trace_profiler import ExecutionTraceProfiler

        state = VMState(program, public_input, non_determinism)
        aet = AlgebraicExecutionTrace(program)
        profiler = ExecutionTraceProfiler()
        prev_jump_stack_len = len(state.jump_stack)
        while not state.halting:
            aet.record_state(state)
            ins = state.current_instruction()
            if ins.name == "call":
                label = program.address_to_label.get(
                    ins.arg, f"address {ins.arg}")
                profiler.enter_span(label, aet)
            for call in state.step():
                aet.record_co_processor_call(call)
            if len(state.jump_stack) < prev_jump_stack_len:
                profiler.exit_span(aet)
            prev_jump_stack_len = len(state.jump_stack)
        return state.public_output, profiler.finish(aet)
