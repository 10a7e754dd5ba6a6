"""K3, the combined AIR quotient over rows: CUDA for tensors on the card,
plain torch on the CPU.

`quotients_on_rows` runs the hand-written kernels of csrc/quotient.cu for
CUDA tensors: the row tape (air/compile.py::quotient_row_tape) of all four
constraint phases at every row, each output weighted, each phase scaled by
its zerofier inverse, the phases summed. The tape is compiled into the
kernels' source (ops/tape_codegen.py), not interpreted: one kernel a
segment of it, so a chunk of rows takes about 100 launches, each counted.
Tensors on the CPU take the plain version, `quotients_on_rows_plain`,
which runs the same row tape one field op per instruction over a chunk of
rows at a time, as the kernel does. There is no fallback: a CUDA tensor
the kernel cannot take raises.

The kernel is built at first use: the generated source is written to
`triton_vm_tpu_torch/_build/quotient_<key>_<j>.cu`, the key a hash of the
tape's bytes, the generator's source and the CUDA sources it includes
(csrc/quotient.cu, csrc/goldilocks.cuh), as 1 + PARTS translation units
that nvcc compiles in parallel processes with relocatable device code and
links into a shared library there (ops/tip5_cuda.py::build_parts), bound
with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..air import compile as aircomp
from ..fields.bfe import P
from . import gf, gfx, tape_codegen, tip5_cuda

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = _CSRC / "quotient.cu"
KERNEL = "quotient_rows_kernel"

# Kernel launches since the last reset, one per launch, in all and by the
# card it launched on (a prover sharded over a mesh launches on every
# shard's card).
launches = {"quotient_rows": 0}
launches_by_device: dict = {}

_LOCK = threading.Lock()
_LIB = None
_TAPES: dict = {}


def reset_launch_counts():
    launches["quotient_rows"] = 0
    launches_by_device.clear()


def _count(device):
    launches["quotient_rows"] += 1
    per = launches_by_device.setdefault(str(device), {"quotient_rows": 0})
    per["quotient_rows"] += 1


class Points(NamedTuple):
    """The points x_i = offset * generator^(start + i), i < n, at which K3
    evaluates the quotient (a domain, a JIT coset, a mesh shard's rows)."""
    generator: int
    offset: int
    n: int
    start: int = 0

    def first(self) -> int:
        return self.offset * pow(self.generator, self.start, P) % P

    def tensor(self, device):
        """The points as an int64 (n,) tensor (`gf.powers`)."""
        return gf.powers(self.generator, self.n, self.first(), device)


# The translation units K3's segments are spread over, compiled in
# parallel processes.
PARTS = 8
# Rows a launch sequence holds state for ((state words, chunk) int64): all
# of a call's rows up to CHUNK_ROWS (about 0.3 GiB of state) on a card.
# Smaller chunks cost launches (a 2^14-row chunk takes its 100 kernels
# about 1.4 ms), so only callers that share a card pass fewer
# (parallel/mesh.py: shards on one card split it).
CHUNK_ROWS = 1 << 17


def sources(tape=None, target=None, parts=PARTS) -> list:
    """Write the generated translation units of `tape` (the quotient row
    tape by default) into the build directory, if they are not there yet,
    and return their paths, _build/quotient_<key>_<j>.cu (j = 0 the
    kernel's unit). The key hashes the tape's bytes, the segment size,
    the generator's source and the CUDA sources the units include."""
    tape = tape or aircomp.quotient_row_tape()
    target = target or tape_codegen.SEGMENT_INSTRUCTIONS
    h = hashlib.sha256()
    for part in (tape.code, tape.bconsts, tape.xconsts):
        h.update(np.ascontiguousarray(part).tobytes())
    h.update(f"{tape.num_bregs} {tape.num_xregs} {target} {parts}".encode())
    for f in (Path(tape_codegen.__file__), _SRC, _CSRC / "goldilocks.cuh"):
        h.update(f.read_bytes())
    key = h.hexdigest()[:16]
    paths = []
    texts = None
    for j in range(parts + 1):
        path = tip5_cuda.BUILD_DIR / f"quotient_{key}_{j}.cu"
        if not path.exists():
            if texts is None:
                texts = tape_codegen.cuda_sources(tape, target, parts)
            if j >= len(texts):
                break
            tip5_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(texts[j])
            os.replace(tmp, path)
        paths.append(path)
    return paths


def build(srcs=None) -> Path:
    """The library of the generated units `srcs` (`sources()` by default),
    compiled at first use with csrc/ on the include path."""
    return tip5_cuda.build_parts(srcs or sources(), include_dirs=(_CSRC,))


def ptxas_report(so: Path | None = None) -> dict:
    """ptxas's registers, spills, stack and shared memory of K3's first
    kernel (as tip5_cuda.ptxas_report reads them), with its segment
    kernels' stack, spill stores and loads summed and their registers at
    most (`segments`), and the build's seconds when this process built
    it."""
    so = Path(so or build())
    rep = tip5_cuda.ptxas_report(so, (KERNEL,))
    segs = {k: v for k, v in tip5_cuda.ptxas_report(so, None).items()
            if "seg_" in k}
    rec = rep.setdefault(KERNEL, {})
    rec["segments"] = {
        "count": len(segs),
        "registers": max((v.get("registers", 0) for v in segs.values()),
                         default=0),
        **{f: sum(v.get(f, 0) for v in segs.values())
           for f in ("stack", "spill_stores", "spill_loads")}}
    if so in tip5_cuda.BUILD_SECONDS:
        rec["build_s"] = round(tip5_cuda.BUILD_SECONDS[so], 1)
    return rep


def bind(so) -> ctypes.CDLL:
    """The library at `so` with its launcher's argument types set."""
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.quotient_rows_launch.argtypes = [
        vp, i64, vp, i64, vp, i64, i64, vp, i64, i64, i64, vp, vp, i64, i64,
        i64, i32, ctypes.c_uint64, vp, vp, i64, vp]
    lib.quotient_rows_launch.restype = i32
    for fn in (lib.quotient_launches_per_chunk, lib.quotient_state_words):
        fn.argtypes, fn.restype = [], i32
    lib.quotient_error_string.argtypes = [i32]
    lib.quotient_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build())
    return _LIB


def load() -> float:
    """Build and load K3 now; returns the seconds it took."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


def _reads(tape):
    """The largest index each input kind of the tape reads (computed once
    per tape)."""
    key = id(tape)
    hit = _TAPES.get(key)
    if hit is not None and hit[0] is tape:
        return hit[1]
    reads = {}
    for opnd in tape.operands().tolist():
        reads[opnd >> 16] = max(reads.get(opnd >> 16, -1), opnd & 0xFFFF)
    _TAPES[key] = (tape, reads)
    return reads


# ------------------------------------------------------------ plain versions

def zerofier_inverses(xs, trace_len: int, gen_inv: int):
    """Each phase's zerofier inverse at the points xs (N,): (4, N) for
    init 1/(x - 1), cons 1/(x^h - 1), tran (x - g^-1)/(x^h - 1), term
    1/(x - g^-1)."""
    one = gf.full((), 1, xs.device)
    cons = gf.inv(gf.sub(gf.pow_const(xs, trace_len), one))
    x_minus = gf.sub(xs, gf.full((), gen_inv, xs.device))
    return torch.stack([gf.inv(gf.sub(xs, one)), cons,
                        gf.mul(x_minus, cons), gf.inv(x_minus)])


def run_row_tape_plain(tape, main, aux, ch, ws, scales, shift: int,
                       start: int = 0):
    """Execute a row tape over rows start .. start + N - 1 in eager
    torch, one field op per instruction over all of them: the sum over
    phases p of scales[p] times phase p's weighted outputs.

    main int64 (NM, M) and aux XFE (3, NA, M) hold the rows (row i's next
    row is row (i + shift) % M); ch XFE (3, nch) the challenges; ws XFE
    (3, num_weights) the weights; scales int64 (num_phases, N). Returns
    XFE (3, N)."""
    N, M = scales.shape[-1], main.shape[1]
    dev = main.device
    rows = slice(start, start + N)
    nidx = (torch.arange(start, start + N, device=dev) + shift) % M
    bconsts = gf.from_u64(tape.bconsts, dev)
    xconsts = gfx.from_u64(tape.xconsts, dev)               # (3, nxc)
    rb, rx = [None] * tape.num_bregs, [None] * tape.num_xregs

    def ldb(o):
        kind, idx = o >> 16, o & 0xFFFF
        if kind == aircomp.BREG:
            return rb[idx]
        if kind == aircomp.MAIN:
            return main[idx, rows]
        if kind == aircomp.NEXT_MAIN:
            return main[idx, nidx]
        assert kind == aircomp.BCONST
        return bconsts[idx].expand(N)

    def ldx(o):
        kind, idx = o >> 16, o & 0xFFFF
        if kind == aircomp.XREG:
            return rx[idx]
        if kind == aircomp.AUX:
            return aux[:, idx, rows]
        if kind == aircomp.NEXT_AUX:
            return aux[:, idx, nidx]
        if kind == aircomp.CHALLENGE:
            return ch[:, idx, None].expand(3, N)
        assert kind == aircomp.XCONST
        return xconsts[:, idx, None].expand(3, N)

    acc = gfx.zeros((N,), dev)
    total = gfx.zeros((N,), dev)
    for op, dst, a, b in tape.code.tolist():
        if op == aircomp.BB_ADD:
            rb[dst] = gf.add(ldb(a), ldb(b))
        elif op == aircomp.BB_MUL:
            rb[dst] = gf.mul(ldb(a), ldb(b))
        elif op == aircomp.BX_ADD:
            x = ldx(a)
            rx[dst] = torch.stack([gf.add(x[0], ldb(b)), x[1], x[2]])
        elif op == aircomp.BX_MUL:
            rx[dst] = gfx.bfe_mul(ldx(a), ldb(b))
        elif op == aircomp.XX_ADD:
            rx[dst] = gfx.add(ldx(a), ldx(b))
        elif op == aircomp.XX_MUL:
            rx[dst] = gfx.mul(ldx(a), ldx(b))
        elif op == aircomp.FOLD_B:
            acc = gfx.add(acc, gfx.bfe_mul(ws[:, dst, None], ldb(a)))
        elif op == aircomp.FOLD_X:
            acc = gfx.add(acc, gfx.mul(ws[:, dst, None], ldx(a)))
        else:
            assert op == aircomp.PHASE_END
            total = gfx.add(total, gfx.bfe_mul(acc, scales[dst]))
            acc = gfx.zeros((N,), dev)
    return total


def quotients_on_rows_plain(tape, main, aux, points, shift: int,
                            trace_len: int, gen_inv: int, ch, ws,
                            chunk: int | None = None):
    """K3's plain version: `run_row_tape_plain` with the zerofier inverses
    at the points as the phases' scales, `chunk` rows (CHUNK_ROWS by
    default) at a time, so that its registers stay bounded at any height.
    Arguments as `quotients_on_rows`."""
    dev = main.device
    N = points.n
    chunk = chunk or CHUNK_ROWS
    out = torch.empty((3, N), dtype=torch.int64, device=dev)
    for s in range(0, N, chunk):
        n = min(chunk, N - s)
        xs = points._replace(n=n, start=points.start + s).tensor(dev)
        out[:, s:s + n] = run_row_tape_plain(
            tape, main, aux, ch, ws,
            zerofier_inverses(xs, trace_len, gen_inv), shift, start=s)
    return out


# ------------------------------------------------------------ K3

def _check(name, t, ndim, device):
    if t.device != device:
        raise ValueError(f"quotient_rows: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.int64:
        raise TypeError(f"quotient_rows: {name} must be int64, got "
                        f"{t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"quotient_rows: {name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if any(s < 0 for s in t.stride()):
        raise ValueError(f"quotient_rows: {name} has a negative stride")


def quotients_on_rows(tape, main, aux, points, shift: int, trace_len: int,
                      gen_inv: int, ch, ws, chunk: int | None = None):
    """The combined quotient at the N = points.n points x_i = offset *
    generator^(start + i) (`Points`), by K3: per chunk of `chunk` rows
    (CHUNK_ROWS, as it stands when called, by default) its first kernel,
    one kernel a segment of the tape and its last; CPU tensors take the
    plain version, in chunks of the same rows.

    main int64 (NM, M) and aux XFE (3, NA, M), any non-negative strides
    (a strided or permuted view of an LDE is read in place): rows 0 .. N-1
    are evaluated, row i's next row is row (i + shift) % M (M = N for a
    whole domain or coset, N + shift for a mesh shard with its halo).
    The kernel forms the points from the two 2^12-word tables of
    `gf.power_tables` (N <= 2^24). trace_len, the trace domain's length (a
    power of two), and gen_inv, its generator's inverse, set the
    zerofiers; ch XFE (3, nch) and ws XFE (3, tape.num_weights)
    contiguous. The tape is the quotient row tape, the one the kernel is
    built from; its state is held for `chunk` rows at a time. Returns XFE
    (3, N) on main's device."""
    chunk = chunk or CHUNK_ROWS
    if main.device.type == "cpu":
        return quotients_on_rows_plain(tape, main, aux, points, shift,
                                       trace_len, gen_inv, ch, ws, chunk)
    dev = main.device
    if dev.type != "cuda":
        raise ValueError(f"quotient_rows: expected a CUDA tensor, got {dev}")
    if tape is not aircomp.quotient_row_tape():
        raise ValueError("quotient_rows: the kernel is built from the "
                         "quotient row tape only")
    for name, t, ndim in (("main", main, 2), ("aux", aux, 3), ("ch", ch, 2),
                          ("ws", ws, 2)):
        _check(name, t, ndim, dev)
    for name, t in (("ch", ch), ("ws", ws)):
        if not t.is_contiguous():
            raise ValueError(f"quotient_rows: {name} must be contiguous")
    N, M = points.n, main.shape[1]
    if aux.shape[0] != 3 or aux.shape[2] != M or N > M:
        raise ValueError(f"quotient_rows: main {tuple(main.shape)}, aux "
                         f"{tuple(aux.shape)} and {N} points do not match")
    if N > gf.MAX_POWER_WORDS:
        raise ValueError(f"quotient_rows: {N} points exceed the tables' "
                         f"{gf.MAX_POWER_WORDS}")
    if ch.shape[0] != 3 or tuple(ws.shape) != (3, tape.num_weights):
        raise ValueError(f"quotient_rows: ch {tuple(ch.shape)} or ws "
                         f"{tuple(ws.shape)} is not (3, .) with "
                         f"{tape.num_weights} weights")
    if trace_len & (trace_len - 1) or trace_len < 1:
        raise ValueError(f"quotient_rows: trace length {trace_len} is not "
                         "a power of two")
    out = torch.empty((3, N), dtype=torch.int64, device=dev)
    if N == 0:
        return out
    reads = _reads(tape)
    for kind, n, name in ((aircomp.MAIN, main.shape[0], "main columns"),
                          (aircomp.NEXT_MAIN, main.shape[0], "main columns"),
                          (aircomp.AUX, aux.shape[1], "aux columns"),
                          (aircomp.NEXT_AUX, aux.shape[1], "aux columns"),
                          (aircomp.CHALLENGE, ch.shape[1], "challenges")):
        if reads.get(kind, -1) >= n:
            raise ValueError(f"quotient_rows: the tape reads {name} up to "
                             f"{reads[kind]}, {n} given")
    with torch.cuda.device(dev):
        _enqueue(_lib(), main, aux, points, shift, trace_len, gen_inv, ch,
                 ws, out, torch.cuda.current_stream().cuda_stream, chunk)
    return out


def launches_per_call(n: int, chunk: int = CHUNK_ROWS, lib=None) -> int:
    """K3's kernel launches for n rows in chunks of `chunk`: per chunk the
    first kernel, one a segment and the last."""
    lib = lib or _lib()
    return -(-n // min(n, chunk)) * lib.quotient_launches_per_chunk()


def _enqueue(lib, main, aux, points, shift, trace_len, gen_inv, ch, ws,
             out, stream, chunk=CHUNK_ROWS):
    """Launch K3 through `lib` on `stream` (tools/quotient_probe.py passes
    other builds), its state for `chunk` rows allocated here."""
    dev = main.device
    x_lo, x_hi = gf.power_tables(points.generator, points.first(), dev)
    chunk = min(points.n, chunk)
    state = torch.empty((lib.quotient_state_words(), chunk),
                        dtype=torch.int64, device=dev)
    rc = lib.quotient_rows_launch(
        ch.data_ptr(), ch.shape[1], ws.data_ptr(), ws.shape[1],
        main.data_ptr(), *main.stride(), aux.data_ptr(), *aux.stride(),
        x_lo.data_ptr(), x_hi.data_ptr(), points.n, main.shape[1], shift,
        trace_len.bit_length() - 1, gen_inv, out.data_ptr(),
        state.data_ptr(), chunk, stream)
    if rc != 0:
        msg = lib.quotient_error_string(rc).decode()
        raise RuntimeError(f"quotient_rows launch failed: {msg} ({rc})")
    for _ in range(launches_per_call(points.n, chunk, lib)):
        _count(dev)


# ------------------------------------------------------------ work

# 32-bit multiplies of one Goldilocks product: the four partial products
# of a 64 x 64 -> 128-bit product, each 32 x 32 -> 64 bits counted as 2 (as
# chip_smoke.py counts Tip5's products)
INT32_OPS_PER_PRODUCT = 8
_PRODUCTS = {aircomp.BB_MUL: 1, aircomp.BX_MUL: 3, aircomp.XX_MUL: 9,
             aircomp.FOLD_B: 3, aircomp.FOLD_X: 9, aircomp.PHASE_END: 3}


def work(tape, n: int, trace_len: int) -> tuple[int, int]:
    """(bytes, int32 multiplies) that K3's function needs over n rows: the
    main and aux columns the tape reads (each read once) and the (3, n)
    output (the points come from two 2^12-word tables); the tape's
    Goldilocks products, plus each point's (one), the zerofiers' x^h
    (log2 h squarings and one product) and three inverses at 3 products
    each, as a batch inversion amortises them."""
    table = {aircomp.MAIN: "main", aircomp.NEXT_MAIN: "main",
             aircomp.AUX: "aux", aircomp.NEXT_AUX: "aux"}
    cols = {"main": set(), "aux": set()}
    for opnd in tape.operands().tolist():
        if opnd >> 16 in table:
            cols[table[opnd >> 16]].add(opnd & 0xFFFF)
    words = len(cols["main"]) + 3 * len(cols["aux"]) + 3
    products = sum(_PRODUCTS.get(op, 0) for op in tape.code[:, 0].tolist())
    products += trace_len.bit_length() + 10
    return 8 * words * n, INT32_OPS_PER_PRODUCT * products * n
