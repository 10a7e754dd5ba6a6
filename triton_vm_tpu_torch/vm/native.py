"""ctypes bindings for the native VM witness core (native/vm_core.cpp).

The C++ core is the framework's equivalent of the reference's Rust
VM (vm.rs:362-428) for witness generation — inherently sequential host
work where per-cycle Python dispatch (~15us) dominates at 2^20+ padded
heights. Semantics are a 1:1 port of machine.py/aet.py (the Python
interpreter remains the oracle; tests/test_native_vm.py asserts AET
equality). On ANY native error the wrapper re-executes on the Python
interpreter so the typed error taxonomy lives in exactly one place.

The shared library is built on demand with g++ -O2 and cached next to
the source keyed by a source hash; if no compiler is available the
Python interpreter is used transparently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..utils import profiler

_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "vm_core.cpp")

# instruction name -> dispatch enum (must match `enum Op` in vm_core.cpp)
_OP_IDS = {name: i for i, name in enumerate([
    "pop", "push", "divine", "pick", "place", "dup", "swap", "halt",
    "nop", "skiz", "call", "return", "recurse", "recurse_or_return",
    "assert", "read_mem", "write_mem", "hash", "assert_vector",
    "sponge_init", "sponge_absorb", "sponge_absorb_mem", "sponge_squeeze",
    "add", "addi", "mul", "invert", "eq", "split", "lt", "and", "xor",
    "log_2_floor", "pow", "div_mod", "pop_count", "xx_add", "xx_mul",
    "x_invert", "xb_mul", "read_io", "write_io", "merkle_step",
    "merkle_step_mem", "b_horner_step", "x_horner_step",
])}
_U32_NAMES = ("split", "lt", "and", "log_2_floor", "pow", "pop_count")


def _build_library() -> str | None:
    """Compile (or reuse a cached) shared library; None on failure."""
    src = open(_SRC, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache_dir = os.path.join(_NATIVE_DIR, "_build")
    so_path = os.path.join(cache_dir, f"vm_core_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(cache_dir, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    os.replace(tmp, so_path)
    return so_path


def _load():
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        so = _build_library()
        if so is None:
            _LIB_FAILED = True
            return None
        lib = ctypes.CDLL(so)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.tvm_init_constants.argtypes = [u64p, u64p, u16p,
                                           ctypes.c_uint64, ctypes.c_uint64,
                                           i32p]
        lib.tvm_trace_execution.restype = ctypes.c_void_p
        lib.tvm_trace_execution.argtypes = [
            i32p, u64p, u64p, i32p, ctypes.c_size_t,
            u64p, u64p, ctypes.c_size_t, u64p, ctypes.c_size_t,
            u64p, ctypes.c_size_t, u64p, ctypes.c_size_t,
            u64p, ctypes.c_size_t]
        lib.tvm_error.argtypes = [ctypes.c_void_p]
        for name in ("num_processor_rows", "num_op_stack_rows",
                     "num_ram_rows", "num_program_hash_rows",
                     "num_hash_rows", "num_sponge_rows", "num_u32_entries",
                     "num_cascade_entries", "num_output"):
            fn = getattr(lib, "tvm_" + name)
            fn.restype = ctypes.c_size_t
            fn.argtypes = [ctypes.c_void_p]
        for name in ("copy_processor_rows", "copy_op_stack_rows",
                     "copy_ram_rows", "copy_program_hash_rows",
                     "copy_hash_rows", "copy_sponge_rows", "copy_output",
                     "copy_u32_entries", "copy_cascade_entries",
                     "copy_lookup_multiplicities"):
            fn = getattr(lib, "tvm_" + name)
            fn.argtypes = [ctypes.c_void_p, u64p]
        lib.tvm_copy_instruction_multiplicities.argtypes = [
            ctypes.c_void_p, u32p]
        lib.tvm_free.argtypes = [ctypes.c_void_p]
        lib.tvm_tip5_permute.argtypes = [u64p]
        lib.tvm_tip5_pad_absorb.argtypes = [u64p, u64p, ctypes.c_uint64]
        _init_constants(lib)
        _LIB = lib
        return lib


def tip5_permute_native(state):
    """In-place C Tip5 permutation of a 16-element list; None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.array(state, np.uint64)
    lib.tvm_tip5_permute(buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint64)))
    return [int(x) for x in buf]


def tip5_pad_absorb_native(state, words):
    """C pad-and-absorb-all into a 16-element state list; None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.array(state, np.uint64)
    w = np.ascontiguousarray(np.asarray(words, np.uint64))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tvm_tip5_pad_absorb(buf.ctypes.data_as(u64p),
                            w.ctypes.data_as(u64p), len(w))
    return [int(x) for x in buf]


def _hash_col_layout() -> np.ndarray:
    from ..air import columns

    H = {name: i for i, name in enumerate(columns.MAIN_COLUMNS["hash"])}
    out = []
    parts = ("Lowest", "MidLow", "MidHigh", "Highest")
    for i in range(4):
        for part in parts:
            out.append(H[f"State{i}{part}LkIn"])
    for i in range(4):
        for part in parts:
            out.append(H[f"State{i}{part}LkOut"])
    for j in range(4, 16):
        out.append(H[f"State{j}"])
    for i in range(4):
        out.append(H[f"State{i}Inv"])
    for i in range(16):
        out.append(H[f"Constant{i}"])
    out += [H["RoundNumber"], H["CI"], H["Mode"]]
    return np.array(out, np.int32)


def _init_constants(lib):
    from ..crypto import tip5
    from ..fields.bfe import R, R_INV

    rc = np.array(tip5.ROUND_CONSTANTS, np.uint64)
    mds = np.array(tip5.MDS_MATRIX_FIRST_COLUMN, np.uint64)
    lut = np.array(tip5.LOOKUP_TABLE, np.uint16)
    cols = _hash_col_layout()
    lib.tvm_init_constants(
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        mds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        R, R_INV,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))


def available() -> bool:
    return _load() is not None


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _decode_program(program):
    """Per-bword-address (op_id, opcode, arg, size) arrays."""
    from ..fields.bfe import P

    n = program.len_bwords()
    ops = np.full(n, -1, np.int32)
    opcodes = np.zeros(n, np.uint64)
    args = np.zeros(n, np.uint64)
    sizes = np.ones(n, np.int32)
    addr = 0
    for ins in program.instructions:
        ops[addr] = _OP_IDS[ins.name]
        opcodes[addr] = ins.opcode
        sizes[addr] = ins.size()
        if ins.size() == 2:
            args[addr] = (ins.arg or 0) % P
        addr += ins.size()
    assert addr == n
    return ops, opcodes, args, sizes


def trace_execution_native(program, public_input, non_determinism):
    """Native witness generation; returns (aet, public_output) or None if
    the native core is unavailable or the run errored (caller falls back
    to the Python interpreter)."""
    from ..crypto import tip5
    from ..fields.bfe import P
    from .aet import LOOKUP_TABLE_HEIGHT, AlgebraicExecutionTrace

    lib = _load()
    if lib is None:
        return None

    with profiler.span("native inputs", "VM"):
        ops, opcodes, args, sizes = _decode_program(program)
        digest = np.array(program.hash(), np.uint64)
        pub = np.array([t % P for t in public_input.individual_tokens],
                       np.uint64)
        sec = np.array([t % P for t in non_determinism.individual_tokens],
                       np.uint64)
        digs = np.array([list(d) for d in non_determinism.digests],
                        np.uint64).reshape(-1, 5)
        ram_kv = np.array([[int(k) % P, int(v) % P]
                           for k, v in non_determinism.ram.items()],
                          np.uint64).reshape(-1, 2)
        padded = program.to_bwords() + [1]
        while len(padded) % tip5.RATE:
            padded.append(0)
        padded = np.array(padded, np.uint64)
    with profiler.span("native run", "VM"):
        h = lib.tvm_trace_execution(
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u64p(opcodes), _u64p(args),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ops),
            _u64p(digest),
            _u64p(pub), len(pub), _u64p(sec), len(sec),
            _u64p(digs), digs.shape[0], _u64p(ram_kv), ram_kv.shape[0],
            _u64p(padded), len(padded))
    with profiler.span("AET assembly", "VM"):
        try:
            if lib.tvm_error(h) != 0:
                return None  # Python interpreter re-raises the typed error

            def pull(num_fn, copy_fn, width):
                n = getattr(lib, "tvm_num_" + num_fn)(h)
                out = np.empty((n, width), np.uint64)
                if n:
                    getattr(lib, "tvm_copy_" + copy_fn)(h, _u64p(out))
                return out

            proc = pull("processor_rows", "processor_rows", 39)
            op_stack = pull("op_stack_rows", "op_stack_rows", 4)
            ram = pull("ram_rows", "ram_rows", 4)
            prog_hash = pull("program_hash_rows", "program_hash_rows", 67)
            hash_rows = pull("hash_rows", "hash_rows", 67)
            sponge_rows = pull("sponge_rows", "sponge_rows", 67)
            u32 = pull("u32_entries", "u32_entries", 4)
            cascade = pull("cascade_entries", "cascade_entries", 2)
            out_tokens = np.zeros(lib.tvm_num_output(h), np.uint64)
            if len(out_tokens):
                lib.tvm_copy_output(h, _u64p(out_tokens))
            lookup = np.zeros(256, np.uint64)
            lib.tvm_copy_lookup_multiplicities(h, _u64p(lookup))
            imult = np.zeros(len(ops), np.uint32)
            lib.tvm_copy_instruction_multiplicities(
                h, imult.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        finally:
            lib.tvm_free(h)

        aet = AlgebraicExecutionTrace.__new__(AlgebraicExecutionTrace)
        aet.program = program
        aet.instruction_multiplicities = imult.tolist()
        aet.processor_rows = proc
        aet.op_stack_rows = list(map(tuple, op_stack.tolist()))
        aet.ram_rows = list(map(tuple, ram.tolist()))
        aet.program_hash_rows = prog_hash
        aet.hash_rows = hash_rows
        aet.sponge_rows = sponge_rows
        aet.u32_entries = {
            (_U32_NAMES[int(r[0])], int(r[1]), int(r[2])): int(r[3])
            for r in u32}
        aet.cascade_multiplicities = {int(r[0]): int(r[1]) for r in cascade}
        aet.lookup_multiplicities = lookup.tolist()
        assert LOOKUP_TABLE_HEIGHT == 256
        return aet, [int(t) for t in out_tokens]
