"""K3, the combined AIR quotient over rows: CUDA for tensors on the card,
plain torch on the CPU.

`quotients_on_rows` launches the hand-written kernel of csrc/quotient.cu
for CUDA tensors: the row tape (air/compile.py::quotient_row_tape) of all
four constraint phases at every row in one launch, each output weighted,
each phase scaled by its zerofier inverse, the phases summed. Tensors on
the CPU take the plain version, `quotients_on_rows_plain`, which runs the
same row tape one field op per instruction over all rows. There is no
fallback: a CUDA tensor the kernel cannot take raises. The prover on the
CPU keeps the level tape (stark/prover.py::_quotient_chunk_fn).

The kernel is built at first use with `nvcc` into a shared library under
`triton_vm_tpu_torch/_build/` (keyed by the source's hash, as
ops/tip5_cuda.py builds the Tip5 kernels) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..air import compile as aircomp
from . import gf, gfx, tip5_cuda

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "quotient.cu"
KERNEL = "quotient_rows_kernel"
# csrc/quotient.cu's kMaxRegWords: the kernel's per-thread register file,
# in words a row
MAX_REG_WORDS = 384

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


def build() -> Path:
    return tip5_cuda.build(_SRC)


def ptxas_report() -> dict:
    """ptxas's registers, spills, stack and shared memory of K3, as
    tip5_cuda.ptxas_report reads them."""
    return tip5_cuda.ptxas_report(build(), (KERNEL,))


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.quotient_rows_launch.argtypes = [
                vp, i64, vp, vp, vp, i64, vp, i64, vp, i64, i64, vp, i64,
                i64, i64, vp, i64, i64, i64, i32, ctypes.c_uint64, i32, i32,
                vp, vp]
            lib.quotient_rows_launch.restype = i32
            lib.quotient_error_string.argtypes = [i32]
            lib.quotient_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def load() -> float:
    """Build and load K3 now; returns the seconds it took."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


def _tape_tensors(tape, device):
    """The tape's code and constants on `device` (uploaded once per tape
    and device) and the largest index each input kind reads."""
    key = (id(tape), str(device))
    hit = _TAPES.get(key)
    if hit is not None and hit[0] is tape:
        return hit[1]
    reads = {}
    for opnd in tape.operands().tolist():
        reads[opnd >> 16] = max(reads.get(opnd >> 16, -1), opnd & 0xFFFF)
    t = dict(
        code=torch.as_tensor(np.ascontiguousarray(tape.code, np.int32),
                             device=device),
        # one word more, so an empty table is still an allocation
        bconsts=gf.from_u64(np.concatenate(
            [tape.bconsts, np.zeros(1, np.uint64)]), device),
        xconsts=gf.from_u64(np.concatenate(
            [tape.xconsts.reshape(-1), np.zeros(1, np.uint64)]), device),
        reads=reads)
    _TAPES[key] = (tape, t)
    return t


# ------------------------------------------------------------ plain versions

def zerofier_inverses(xs, trace_len: int, gen_inv: int):
    """Each phase's zerofier inverse at the points xs (N,), as
    stark/prover.py::_quotient_chunk_fn computes them: (4, N) for init
    1/(x - 1), cons 1/(x^h - 1), tran (x - g^-1)/(x^h - 1), term
    1/(x - g^-1)."""
    one = gf.full((), 1, xs.device)
    cons = gf.inv(gf.sub(gf.pow_const(xs, trace_len), one))
    x_minus = gf.sub(xs, gf.full((), gen_inv, xs.device))
    return torch.stack([gf.inv(gf.sub(xs, one)), cons,
                        gf.mul(x_minus, cons), gf.inv(x_minus)])


def run_row_tape_plain(tape, main, aux, ch, ws, scales, shift: int):
    """Execute a row tape over rows 0 .. N - 1 in eager torch, one field
    op per instruction over all rows: the sum over phases p of scales[p]
    times phase p's weighted outputs.

    main int64 (NM, M) and aux XFE (3, NA, M) hold the rows (row i's next
    row is row (i + shift) % M); ch XFE (3, nch) the challenges; ws XFE
    (3, num_weights) the weights; scales int64 (num_phases, N). Returns
    XFE (3, N)."""
    N, M = scales.shape[-1], main.shape[1]
    dev = main.device
    nidx = (torch.arange(N, device=dev) + shift) % M
    bconsts = gf.from_u64(tape.bconsts, dev)
    xconsts = gfx.from_u64(tape.xconsts, dev)               # (3, nxc)
    rb, rx = [None] * tape.num_bregs, [None] * tape.num_xregs

    def ldb(o):
        kind, idx = o >> 16, o & 0xFFFF
        if kind == aircomp.BREG:
            return rb[idx]
        if kind == aircomp.MAIN:
            return main[idx, :N]
        if kind == aircomp.NEXT_MAIN:
            return main[idx, nidx]
        assert kind == aircomp.BCONST
        return bconsts[idx].expand(N)

    def ldx(o):
        kind, idx = o >> 16, o & 0xFFFF
        if kind == aircomp.XREG:
            return rx[idx]
        if kind == aircomp.AUX:
            return aux[:, idx, :N]
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


def quotients_on_rows_plain(tape, main, aux, xs, shift: int,
                            trace_len: int, gen_inv: int, ch, ws):
    """K3's plain version: `run_row_tape_plain` with the zerofier inverses
    at xs as the phases' scales. Arguments as `quotients_on_rows`."""
    return run_row_tape_plain(tape, main, aux, ch, ws,
                              zerofier_inverses(xs, trace_len, gen_inv),
                              shift)


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


def quotients_on_rows(tape, main, aux, xs, shift: int, trace_len: int,
                      gen_inv: int, ch, ws):
    """The combined quotient at the N points xs, one launch of K3.

    main int64 (NM, M) and aux XFE (3, NA, M), any non-negative strides
    (a strided or permuted view of an LDE is read in place): rows 0 .. N-1
    are evaluated, row i's next row is row (i + shift) % M (M = N for a
    whole domain or coset, N + shift for a mesh shard with its halo). xs
    int64 (N,) contiguous; trace_len, the trace domain's length (a power
    of two), and gen_inv, its generator's inverse, set the zerofiers; ch
    XFE (3, nch) and ws XFE (3, tape.num_weights) contiguous. Returns XFE
    (3, N) on main's device."""
    if main.device.type == "cpu":
        return quotients_on_rows_plain(tape, main, aux, xs, shift,
                                       trace_len, gen_inv, ch, ws)
    dev = main.device
    if dev.type != "cuda":
        raise ValueError(f"quotient_rows: expected a CUDA tensor, got {dev}")
    for name, t, ndim in (("main", main, 2), ("aux", aux, 3), ("xs", xs, 1),
                          ("ch", ch, 2), ("ws", ws, 2)):
        _check(name, t, ndim, dev)
    for name, t in (("xs", xs), ("ch", ch), ("ws", ws)):
        if not t.is_contiguous():
            raise ValueError(f"quotient_rows: {name} must be contiguous")
    (N,), M = xs.shape, main.shape[1]
    if aux.shape[0] != 3 or aux.shape[2] != M or N > M:
        raise ValueError(f"quotient_rows: main {tuple(main.shape)}, aux "
                         f"{tuple(aux.shape)} and {N} points do not match")
    if ch.shape[0] != 3 or tuple(ws.shape) != (3, tape.num_weights):
        raise ValueError(f"quotient_rows: ch {tuple(ch.shape)} or ws "
                         f"{tuple(ws.shape)} is not (3, .) with "
                         f"{tape.num_weights} weights")
    if trace_len & (trace_len - 1) or trace_len < 1:
        raise ValueError(f"quotient_rows: trace length {trace_len} is not "
                         "a power of two")
    if tape.num_phases > 4:
        raise ValueError("quotient_rows: the kernel scales 4 phases")
    if tape.reg_words > MAX_REG_WORDS:
        raise ValueError(f"quotient_rows: the tape needs {tape.reg_words} "
                         f"register words a row, the kernel holds "
                         f"{MAX_REG_WORDS}")
    out = torch.empty((3, N), dtype=torch.int64, device=dev)
    if N == 0:
        return out
    t = _tape_tensors(tape, dev)
    for kind, n, name in ((aircomp.MAIN, main.shape[0], "main columns"),
                          (aircomp.NEXT_MAIN, main.shape[0], "main columns"),
                          (aircomp.AUX, aux.shape[1], "aux columns"),
                          (aircomp.NEXT_AUX, aux.shape[1], "aux columns"),
                          (aircomp.CHALLENGE, ch.shape[1], "challenges")):
        if t["reads"].get(kind, -1) >= n:
            raise ValueError(f"quotient_rows: the tape reads {name} up to "
                             f"{t['reads'][kind]}, {n} given")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().quotient_rows_launch(
            t["code"].data_ptr(), t["code"].shape[0], t["bconsts"].data_ptr(),
            t["xconsts"].data_ptr(), ch.data_ptr(), ch.shape[1],
            ws.data_ptr(), ws.shape[1], main.data_ptr(), *main.stride(),
            aux.data_ptr(), *aux.stride(), xs.data_ptr(), N, M, shift,
            trace_len.bit_length() - 1, gen_inv, tape.num_bregs,
            tape.reg_words, out.data_ptr(), stream)
        if rc != 0:
            msg = _lib().quotient_error_string(rc).decode()
            raise RuntimeError(f"quotient_rows launch failed: {msg} ({rc})")
        _count(dev)
    return out


# ------------------------------------------------------------ work

# 32-bit multiplies of one Goldilocks product: the four partial products
# of a 64 x 64 -> 128-bit product, each 32 x 32 -> 64 bits counted as 2 (as
# chip_smoke.py counts Tip5's products)
INT32_OPS_PER_PRODUCT = 8
_PRODUCTS = {aircomp.BB_MUL: 1, aircomp.BX_MUL: 3, aircomp.XX_MUL: 9,
             aircomp.FOLD_B: 3, aircomp.FOLD_X: 9, aircomp.PHASE_END: 3}


def work(tape, n: int, trace_len: int) -> tuple[int, int]:
    """(bytes, int32 multiplies) that K3's function needs over n rows: the
    main and aux columns the tape reads (each read once), xs, and the
    (3, n) output; the tape's Goldilocks products, plus the zerofiers'
    x^h (log2 h squarings and one product) and three inverses at 3
    products each, as a batch inversion amortises them."""
    table = {aircomp.MAIN: "main", aircomp.NEXT_MAIN: "main",
             aircomp.AUX: "aux", aircomp.NEXT_AUX: "aux"}
    cols = {"main": set(), "aux": set()}
    for opnd in tape.operands().tolist():
        if opnd >> 16 in table:
            cols[table[opnd >> 16]].add(opnd & 0xFFFF)
    words = len(cols["main"]) + 3 * len(cols["aux"]) + 1 + 3
    products = sum(_PRODUCTS.get(op, 0) for op in tape.code[:, 0].tolist())
    products += trace_len.bit_length() + 9
    return 8 * words * n, INT32_OPS_PER_PRODUCT * products * n
