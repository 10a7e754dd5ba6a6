"""K4, the batched Goldilocks NTT: the hand-written kernel of csrc/ntt.cu.

`ntt_rows` launches it on a CUDA tensor and raises on any other: the one
dispatch point, ops/ntt.py::_rows, sends tensors on the CPU to the plain
version there (`_rows_plain`: the scales as `gf.mul`, then the radix-2
network `_transform_plain`). There is no fallback: a CUDA tensor the
kernel cannot take raises.

A transform of length n runs as one or two passes (`plan`): up to 2^12
words one pass, each row whole in a CTA; above, the four-step split n =
n1 n2 (pass 1 the strided columns, pass 2 in place with the twiddle
w^(i1 k2)), up to 2^24. A pass of length L runs as up to three levels of
radix up to 16 (`levels`), butterflies in registers. The host builds
every table the passes read (`tables`: the levels' twiddles, the
in-register roots, pass 2's two-table twiddle), cached per (n, root,
device); a scale `(base, factor)`, word p times factor * base^p, is read
from the two 2^12-word tables of `gf.power_tables`.
tests/test_torch_ntt_kernel.py re-enacts the passes in torch over these
tables and holds them against the JAX package's transforms.

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
# csrc/ntt.cu's kMaxLogLen, kE and kMaxThreads: the longest transform one
# pass runs, the words a thread holds and the threads a CTA
MAX_PASS_LOG = 12
WORDS_PER_THREAD = 16
MAX_THREADS = 512
MAX_LOG_LENGTH = 2 * MAX_PASS_LOG
# words a CTA holds (32 KiB, 256 threads): a one-pass transform (the rows,
# at least one) and a strided pass (sub-sequences adjacent in memory, at
# least two of them; 64 KiB tiles ran 10% slower on an H100 at 379 x 2^21)
ROW_TILE_WORDS = 1 << 12
STRIDED_TILE_WORDS = 1 << 12

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


def build(src: Path = _SRC) -> Path:
    return tip5_cuda.build(src)


def ptxas_report(src: Path = _SRC) -> dict:
    """ptxas's registers, spills, stack and shared memory of K4, as
    tip5_cuda.ptxas_report reads them."""
    return tip5_cuda.ptxas_report(build(src), (KERNEL,))


def bind(so) -> ctypes.CDLL:
    """The library at `so` with its launcher's argument types set
    (tools/ntt_probe.py binds older builds of csrc/ntt.cu itself)."""
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    u64 = ctypes.c_uint64
    lib.ntt_pass_launch.argtypes = [
        vp, i64, i64, vp, i64, i64, i32, i64, i64, i64, i64, vp, vp, vp, vp,
        u64, u64, vp, vp, vp, i32, vp, vp, i32, i32, vp]
    lib.ntt_pass_launch.restype = i32
    lib.ntt_error_string.argtypes = [i32]
    lib.ntt_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build())
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
    2^log_tile sub-sequences a CTA; `levels` the radix bits of each level
    (`levels`)."""
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
    levels: tuple


def levels(log_len: int) -> tuple:
    """The radix bits of a pass's levels: one level up to 16 words, else a
    radix-16 first level, then a last level of up to 16 (up to 2^8), else
    a middle level of up to 16 between two of radix 16."""
    if log_len <= 4:
        return (log_len,)
    if log_len <= 8:
        return (4, log_len - 4)
    return (4, log_len - 8, 4)


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
    log_words = WORDS_PER_THREAD.bit_length() - 1
    if log_n <= MAX_PASS_LOG:
        log_tile = max(log_words, ROW_TILE_WORDS.bit_length() - 1) - log_n
        return (Pass(log_n, 0, 0, 1, 0, 1, True, False, True, log_tile,
                     levels(log_n)),)
    log_n2 = (log_n + 1) // 2
    log_n1 = log_n - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2

    def strided_tile(log_len):
        return max(1, STRIDED_TILE_WORDS.bit_length() - 1 - log_len)

    return (Pass(log_n2, log_n1, 1, n1, n2, 1, True, False, False,
                 strided_tile(log_n2), levels(log_n2)),
            Pass(log_n1, log_n2, 1, n2, 1, n2, False, True, True,
                 strided_tile(log_n1), levels(log_n1)))


def threads(p: Pass) -> int:
    """A pass's threads a CTA: its tile, 16 words a thread."""
    return (1 << (p.log_len + p.log_tile)) // WORDS_PER_THREAD


def level_twiddles(w_len: int, p: Pass) -> np.ndarray:
    """The pass's levels' twiddles as csrc/ntt.cu stages them, w_len its
    root: for each level but the last, of radix R over segments of M words
    (M = L on the first), w_M^(i_a k) at k (M / R) + i_a for k < R and
    i_a < M / R, w_M = w_len^(L / M); the levels one after another."""
    L = 1 << p.log_len
    out, log_m = [], p.log_len
    powers = powers_u64(w_len, 1, L)
    for r in p.levels[:-1]:
        m = 1 << log_m
        e = np.arange(1 << r)[:, None] * np.arange(m >> r)[None, :] % m
        out.append(powers[e.reshape(-1) * (L // m)])
        log_m -= r
    return (np.concatenate(out) if out else np.zeros(0, np.uint64))


def register_roots(w_len: int, log_len: int) -> np.ndarray:
    """w_16^j for j < 8, the roots of the radix-2 stages a thread runs in
    registers: w_16 = w_len^(L / 16); below 16 words only the powers
    w_len^(j L / 16) a stage uses (0 elsewhere)."""
    L = 1 << log_len
    return np.array([pow(w_len, j * L // 16, P) if j * L % 16 == 0 else 0
                     for j in range(8)], np.uint64)


@functools.lru_cache(maxsize=64)
def tables(length: int, root: int):
    """numpy u64 tables of a transform of `length` with `root`: the pass-2
    twiddle's (lo, hi), w^e = lo[e mod 2^12] hi[e >> 12] (None for a
    one-pass transform), and for each pass its levels' twiddles
    (`level_twiddles`) and its register roots (`register_roots`), each
    pass's root w_L = root^(length / L)."""
    passes = plan(length)
    inner, roots = [], []
    for p in passes:
        w_len = pow(root, length >> p.log_len, P)
        inner.append(level_twiddles(w_len, p))
        roots.append(register_roots(w_len, p.log_len))
    if len(passes) == 1:
        return None, tuple(inner), tuple(roots)
    lo = powers_u64(root, 1, 1 << gf.POW_BITS)
    hi = powers_u64(pow(root, 1 << gf.POW_BITS, P), 1,
                    max(1, length >> gf.POW_BITS))
    return (lo, hi), tuple(inner), tuple(roots)


def _device_tables(length: int, root: int, device):
    key = (length, root, str(device))
    t = _TABLES.get(key)
    if t is None:
        tw, inner, roots = tables(length, root)
        t = _TABLES[key] = (
            None if tw is None else tuple(gf.from_u64(a, device) for a in tw),
            tuple(gf.from_u64(np.concatenate([a, np.zeros(1, np.uint64)]),
                              device) for a in inner),
            tuple((ctypes.c_uint64 * 8)(*map(int, r)) for r in roots),
            tuple((ctypes.c_int * 3)(*p.levels, *[0] * (3 - len(p.levels)))
                  for p in plan(length)))
    return t


# ------------------------------------------------------------ K4

def _check_scale(name, scale):
    if scale is None:
        return
    if (not isinstance(scale, tuple) or len(scale) != 2
            or not all(isinstance(v, int) for v in scale)):
        raise TypeError(f"ntt: {name} must be (base, factor) ints, got "
                        f"{scale!r}")


def ntt_rows(x, root: int, length: int, pre=None, post=None, out=None):
    """K4 over the rows of x: out[r, k] = post(k) * sum_i pre(i) x[r, i]
    root^(i k), x zero-padded from n_in to `length` words, where a scale
    (base, factor) is i -> factor * base^i and None is 1.

    x: int64 (rows, n_in) on a CUDA device, each row contiguous (any
    non-negative row stride); root a primitive length-th root of unity
    (length a power of two, n_in <= length <= 2^24); out int64 (rows,
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
    _check_scale("pre", pre)
    _check_scale("post", post)
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


def _enqueue(lib, x, root, length, pre, post, out, stream, only=None):
    """Launch every pass of `plan(length)` through `lib` on `stream` (or
    only pass `only`: tools/ntt_probe.py times a pass alone)."""
    rows, n_in = x.shape
    tw, inner, roots, lv = _device_tables(length, root, x.device)
    pre_t = None if pre is None else gf.power_tables(*pre, x.device)
    post_t = None if post is None else gf.power_tables(*post, x.device)
    for k, p in enumerate(plan(length)):
        if only is not None and k != only:
            continue
        src, src_row, src_n = ((x, x.stride(0), n_in) if p.first
                               else (out, out.stride(0), length))
        scale_in = pre_t if p.first else None
        scale_out = post_t if p.last else None
        # the ratio of a scale from a thread's word to its next (csrc/ntt.cu)
        step_in = 1 if scale_in is None else pow(
            pre[0], p.in_elem << (p.log_len - p.levels[0]), P)
        step_out = 1 if scale_out is None else pow(
            post[0], p.out_elem << (p.log_len - p.levels[-1]), P)
        rc = lib.ntt_pass_launch(
            src.data_ptr(), src_row, src_n, out.data_ptr(), out.stride(0),
            rows, p.log_seqs, p.in_seq, p.in_elem, p.out_seq, p.out_elem,
            *(None, None) if scale_in is None else
            (t.data_ptr() for t in scale_in),
            *(None, None) if scale_out is None else
            (t.data_ptr() for t in scale_out), step_in, step_out,
            tw[0].data_ptr() if p.twiddle else None,
            tw[1].data_ptr() if p.twiddle else None,
            inner[k].data_ptr(), inner[k].numel() - 1, roots[k], lv[k],
            p.log_len, p.log_tile, stream)
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
