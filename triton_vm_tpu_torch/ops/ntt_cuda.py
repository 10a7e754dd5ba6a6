"""K4, the batched Goldilocks NTT: the hand-written kernel of csrc/ntt.cu.

`ntt_rows` launches it on a CUDA tensor and raises on any other: the one
dispatch point, ops/ntt.py::_rows, sends tensors on the CPU to the plain
version there (`_rows_plain`: the scales as `gf.mul`, then the radix-2
network `_transform_plain`). There is no fallback: a CUDA tensor the
kernel cannot take raises.

A transform of length n runs as one or two passes (`plan`): up to 2^12
words one pass, each row whole in shared memory; above, the four-step
split n = n1 n2 (pass 1 the strided columns, pass 2 in place with the
twiddle w^(i1 k2)), up to 2^24. The host builds every table the passes
read (`tables`), cached per (n, root, device). tests/test_torch_ntt_kernel.py
re-enacts the passes in torch over these tables and holds them against
the JAX package's transforms.

The kernel is built at first use with `nvcc` into a shared library under
`triton_vm_tpu_torch/_build/` (keyed by the hash of the source and the
header it includes, csrc/goldilocks.cuh) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..fields.bfe import P
from . import gf, tip5_cuda
from .npfield import powers_u64

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "ntt.cu"
KERNEL = "ntt_pass_kernel"
# csrc/ntt.cu's kMaxLogLen, kMaxLogTileWords and kTwBits: the longest
# transform one pass runs, the words a CTA holds, and the split of the
# pass-2 twiddle's exponent
MAX_PASS_LOG = 12
MAX_LOG_TILE_WORDS = 14
TW_BITS = 12
MAX_LOG_LENGTH = 2 * MAX_PASS_LOG
# words a CTA holds: a one-pass transform (the rows, at least one) and a
# strided pass (sub-sequences adjacent in memory, 4 to 32 of them)
ROW_TILE_WORDS = 1 << 11
STRIDED_TILE_WORDS = 1 << 13

# Kernel launches since the last reset, one per pass launched (a transform
# above 2^12 words launches two), in all and by the card it launched on.
launches = {"ntt_pass": 0}
launches_by_device: dict = {}

_LOCK = threading.Lock()
_LIB = None
_TABLES: dict = {}


def reset_launch_counts():
    launches["ntt_pass"] = 0
    launches_by_device.clear()


def _count(device):
    launches["ntt_pass"] += 1
    per = launches_by_device.setdefault(str(device), {"ntt_pass": 0})
    per["ntt_pass"] += 1


def build() -> Path:
    return tip5_cuda.build(_SRC)


def ptxas_report() -> dict:
    """ptxas's registers, spills, stack and shared memory of K4, as
    tip5_cuda.ptxas_report reads them."""
    return tip5_cuda.ptxas_report(build(), (KERNEL,))


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.ntt_pass_launch.argtypes = [
                vp, i64, i64, vp, i64, i64, i32, i64, i64, i64, i64, vp, vp,
                vp, vp, vp, i32, i32, vp]
            lib.ntt_pass_launch.restype = i32
            lib.ntt_error_string.argtypes = [i32]
            lib.ntt_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def load() -> float:
    """Build and load K4 now; returns the seconds it took."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


# ------------------------------------------------------------ the plan

class Pass(NamedTuple):
    """One launch: 2^log_seqs sub-sequences a row, each transformed with
    length 2^log_len; element j of sub-sequence s is read at in-row
    position s * in_seq + j * in_elem and written at s * out_seq + j *
    out_elem. `first` reads the input (its scale, its zero-padding), else
    the output in place; `twiddle` multiplies element j of sub-sequence s
    by w^(j s) on the load; `last` applies the output scale on the store;
    2^log_tile sub-sequences a CTA."""
    log_len: int
    log_seqs: int
    in_seq: int
    in_elem: int
    out_seq: int
    out_elem: int
    first: bool
    twiddle: bool
    last: bool
    log_tile: int


def plan(length: int) -> tuple[Pass, ...]:
    """K4's passes for a transform of `length` (a power of two up to
    2^24): one pass up to 2^12; above, n = n1 n2 with n2 = 2^ceil(log2 n /
    2): pass 1 the n1 columns of length n2 (stride n1), each written as a
    contiguous run, pass 2 the n2 columns of length n1 (stride n2) in
    place."""
    log_n = length.bit_length() - 1
    if length < 1 or 1 << log_n != length or log_n > MAX_LOG_LENGTH:
        raise ValueError(f"ntt: length {length} is not a power of two up "
                         f"to 2^{MAX_LOG_LENGTH}")
    if log_n <= MAX_PASS_LOG:
        log_tile = max(0, ROW_TILE_WORDS.bit_length() - 1 - log_n)
        return (Pass(log_n, 0, 0, 1, 0, 1, True, False, True, log_tile),)
    log_n2 = (log_n + 1) // 2
    log_n1 = log_n - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2

    def strided_tile(log_len):
        return min(5, max(2, STRIDED_TILE_WORDS.bit_length() - 1 - log_len))

    return (Pass(log_n2, log_n1, 1, n1, n2, 1, True, False, False,
                 strided_tile(log_n2)),
            Pass(log_n1, log_n2, 1, n2, 1, n2, False, True, True,
                 strided_tile(log_n1)))


@functools.lru_cache(maxsize=64)
def tables(length: int, root: int):
    """numpy u64 tables of a transform of `length` with `root`: the pass-2
    twiddle's (lo, hi), w^e = lo[e mod 2^12] hi[e >> 12] (None for a
    one-pass transform), and each pass's inner twiddles w_L^j, j < L/2,
    w_L = root^(length / L)."""
    passes = plan(length)
    inner = tuple(powers_u64(pow(root, length >> p.log_len, P), 1,
                             max(1, (1 << p.log_len) // 2)) for p in passes)
    if len(passes) == 1:
        return None, inner
    lo = powers_u64(root, 1, 1 << TW_BITS)
    hi = powers_u64(pow(root, 1 << TW_BITS, P), 1,
                    max(1, length >> TW_BITS))
    return (lo, hi), inner


def _device_tables(length: int, root: int, device):
    key = (length, root, str(device))
    t = _TABLES.get(key)
    if t is None:
        tw, inner = tables(length, root)
        t = _TABLES[key] = (
            None if tw is None else tuple(gf.from_u64(a, device) for a in tw),
            tuple(gf.from_u64(a, device) for a in inner))
    return t


# ------------------------------------------------------------ K4

def _check_vector(name, v, n, device):
    if v is None:
        return
    if v.device != device or v.dtype != torch.int64:
        raise TypeError(f"ntt: {name} must be int64 on {device}, got "
                        f"{v.dtype} on {v.device}")
    if tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"ntt: {name} must be contiguous ({n},), got "
                         f"{tuple(v.shape)}")


def ntt_rows(x, root: int, length: int, pre=None, post=None, out=None):
    """K4 over the rows of x: out[r, k] = post[k] * sum_i pre[i] x[r, i]
    root^(i k), x zero-padded from n_in to `length` words.

    x: int64 (rows, n_in) on a CUDA device, each row contiguous (any
    non-negative row stride); root a primitive length-th root of unity
    (length a power of two, n_in <= length <= 2^24); pre int64 (n_in,)
    and post int64 (length,), contiguous, or None; out int64 (rows,
    length), rows contiguous, not overlapping x (allocated if None).
    Returns out."""
    if x.dtype != torch.int64 or x.dim() != 2:
        raise TypeError(f"ntt: expected int64 (rows, n), got {x.dtype} "
                        f"{tuple(x.shape)}")
    rows, n_in = x.shape
    if n_in > 1 and x.stride(1) != 1 or x.stride(0) < 0:
        raise ValueError(f"ntt: rows must be contiguous, got strides "
                         f"{x.stride()}")
    plan(length)
    if not 1 <= n_in <= length:
        raise ValueError(f"ntt: {n_in} words do not pad to {length}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ntt: expected a CUDA tensor, got {dev}")
    _check_vector("pre", pre, n_in, dev)
    _check_vector("post", post, length, dev)
    if out is None:
        out = torch.empty((rows, length), dtype=torch.int64, device=dev)
    elif (out.device != dev or out.dtype != torch.int64
          or tuple(out.shape) != (rows, length)
          or length > 1 and out.stride(1) != 1 or out.stride(0) < 0):
        raise ValueError(f"ntt: out must be int64 ({rows}, {length}) on "
                         f"{dev} with contiguous rows")
    if rows == 0:
        return out
    lo, hi = x.data_ptr(), x.data_ptr() + 8 * (
        (rows - 1) * x.stride(0) + n_in)
    olo, ohi = out.data_ptr(), out.data_ptr() + 8 * (
        (rows - 1) * out.stride(0) + length)
    if lo < ohi and olo < hi:
        raise ValueError("ntt: out overlaps x")
    with torch.cuda.device(dev):
        _enqueue(_lib(), x, root, length, pre, post, out,
                 torch.cuda.current_stream().cuda_stream)
    return out


def _enqueue(lib, x, root, length, pre, post, out, stream):
    """Launch every pass of `plan(length)` through `lib` on `stream`."""
    rows, n_in = x.shape
    tw, inner = _device_tables(length, root, x.device)
    for k, p in enumerate(plan(length)):
        src, src_row, src_n = ((x, x.stride(0), n_in) if p.first
                               else (out, out.stride(0), length))
        rc = lib.ntt_pass_launch(
            src.data_ptr(), src_row, src_n, out.data_ptr(), out.stride(0),
            rows, p.log_seqs, p.in_seq, p.in_elem, p.out_seq, p.out_elem,
            pre.data_ptr() if p.first and pre is not None else None,
            post.data_ptr() if p.last and post is not None else None,
            tw[0].data_ptr() if p.twiddle else None,
            tw[1].data_ptr() if p.twiddle else None,
            inner[k].data_ptr(), p.log_len, p.log_tile, stream)
        if rc != 0:
            msg = lib.ntt_error_string(rc).decode()
            raise RuntimeError(f"ntt pass launch failed: {msg} ({rc})")
        _count(x.device)


# ------------------------------------------------------------ work

# 32-bit multiplies of one Goldilocks product (ops/quotient_cuda.py)
INT32_OPS_PER_PRODUCT = 8


def work(rows: int, n_in: int, length: int,
         scaled_words: int = 0) -> tuple[int, int]:
    """(bytes, int32 multiplies) that a transform's function needs: each
    row's n_in input words read once and `length` output words written
    once; length/2 log2 length butterfly products a row plus one for each
    of the row's `scaled_words` (n_in for a coset scale, length for the
    iNTT's), 8 int32 multiplies a product."""
    products = length // 2 * (length.bit_length() - 1) + scaled_words
    return 8 * rows * (n_in + length), \
        INT32_OPS_PER_PRODUCT * rows * products
