"""The prover's randomizers: ChaCha12 (rand::StdRng) draws of base-field
elements, on the card by the hand-written kernel of csrc/chacha12.cu.

`draw` gives one row of draws per seed offset, row b drawn exactly as
`ChaCha12Rng(offset_seed(seed, offsets[b])).random_bfe()` n times (the
prover's `_drbg_bfes` streams, master_table.rs:631-663), as an int64
tensor on the device it is asked for:

- BFE rows, (B, n): draw j of row b at [b, j];
- XFE rows (`xfe=True`, n XFEs = 3n draws a row), (B, 3, n): draw 3i + k
  of row b at [b, k, i], component-major, the layout in which the prover
  commits the aux table's randomizers and keeps XFE columns.

For a CUDA device it launches `chacha12_bfe_kernel` (one thread a ChaCha12
block of 4 draws, every row of the call in one launch, the output written
in its layout), then reads the kernel's per-row flags once: a row where a
draw skipped Canon's bias-correction branch (probability 2^-32 a draw) is
redrawn exactly on the host with the scalar `ChaCha12Rng`. For the CPU it
runs the plain version, `draw_plain`: the numpy keystream of
`utils/stdrng.drbg_bfes_batch` in the same layout. There is no fallback: the
kernel runs for every CUDA device, and what it cannot take raises.

While a profiler session is open, a call on the card counts its draws
(`DRAWS`) and the rows it redrew on the host (`EXACT_ROWS`); the flag read
counts as one device read.

The kernel is built at first use with `nvcc` into a shared library under
`triton_vm_tpu_torch/_build/` (keyed by its source's hash, as
ops/tip5_cuda.py builds K1 and K2) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import profiler, stdrng
from . import gf, tip5_cuda

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "chacha12.cu"
KERNEL = "chacha12_bfe_kernel"
DRAWS = "randomizer draws"
EXACT_ROWS = "randomizer exact rows"
# the kernel's grid has one y index a row, and a row's draws index in u32
MAX_ROWS = 65535
MAX_DRAWS_PER_ROW = 1 << 31

# Kernel launches since the last reset, one per `draw` on a card, in all
# and by the card it launched on.
launches = {"chacha12_bfe": 0}
launches_by_device: dict = {}

_LOCK = threading.Lock()
_LIB = None


def reset_launch_counts():
    launches["chacha12_bfe"] = 0
    launches_by_device.clear()


def _count(device):
    launches["chacha12_bfe"] += 1
    per = launches_by_device.setdefault(str(device), {"chacha12_bfe": 0})
    per["chacha12_bfe"] += 1


def build(src: Path = _SRC) -> Path:
    return tip5_cuda.build(src)


def ptxas_report(src: Path = _SRC) -> dict:
    """ptxas's registers, spills, stack and shared memory of the kernel,
    as tip5_cuda.ptxas_report reads them."""
    return tip5_cuda.ptxas_report(build(src), (KERNEL,))


def bind(so) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.chacha12_bfe_launch.argtypes = [vp, i64, i64, i32, vp, vp, vp]
    lib.chacha12_bfe_launch.restype = i32
    lib.chacha12_error_string.argtypes = [i32]
    lib.chacha12_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build())
    return _LIB


def load() -> float:
    """Build and load the kernel now; returns the seconds it took."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


def _shape(rows, n, xfe):
    return (rows, 3, n) if xfe else (rows, n)


def draw(seed: bytes, offsets, n: int, xfe: bool = False, device="cpu"):
    """One row of n BFEs (n XFEs where `xfe`) per offset of `seed`'s
    streams, int64 on `device`: (B, n), or (B, 3, n) component-major."""
    device = torch.device(device)
    if device.type != "cuda":
        return draw_plain(seed, offsets, n, xfe, device)
    seeds = stdrng.offset_seeds(seed, offsets)
    out, flags = launch(seeds, n, xfe, device)
    return settle(out, flags, seeds, n, xfe)


def launch(seeds, n: int, xfe: bool, device):
    """Enqueue the kernel for one row per 32-byte seed on the CUDA
    `device`: returns the draws, unchecked, and the per-row flags (int64
    (B,), 1 where a row must be redrawn), both still being computed."""
    rows, total = len(seeds), 3 * n if xfe else n
    if not (0 < rows <= MAX_ROWS and 0 < total < MAX_DRAWS_PER_ROW):
        raise ValueError(f"chacha12_bfe: {rows} rows of {total} draws; "
                         f"1 to {MAX_ROWS} rows of 1 to "
                         f"{MAX_DRAWS_PER_ROW - 1} draws")
    out = torch.empty(_shape(rows, n, xfe), dtype=torch.int64,
                      device=device)
    flags = torch.zeros(rows, dtype=torch.int64, device=device)
    keys = np.frombuffer(b"".join(seeds), np.uint32).reshape(rows, 8)
    keys = torch.from_numpy(keys.view(np.int32).copy()).to(device)
    enqueue(keys, total, 3 if xfe else 1, out, flags)
    return out, flags


def enqueue(keys, total: int, components: int, out, flags):
    """One launch over buffers on the card: `keys` int32 (B, 8) (the row
    seeds' little-endian words), `total` draws a row in the layout of
    `components` (1 or 3), into `out` (B * total int64) and `flags`
    (B int64, zeroed)."""
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().chacha12_bfe_launch(keys.data_ptr(), keys.shape[0],
                                        total, components, out.data_ptr(),
                                        flags.data_ptr(), stream)
        if rc != 0:
            msg = _lib().chacha12_error_string(rc).decode()
            raise RuntimeError(f"chacha12_bfe launch failed: {msg} ({rc})")
        _count(keys.device)


def settle(out, flags, seeds, n: int, xfe: bool):
    """Read the kernel's flags (one device read) and redraw each flagged
    row exactly on the host into `out`; returns `out`."""
    redo = np.nonzero(gf.to_u64(flags))[0]
    total = 3 * n if xfe else n
    for b in redo:
        row = stdrng.ChaCha12Rng(seeds[int(b)]).random_bfes(total)
        out[int(b)] = gf.from_u64(_layout(np.array([row], np.uint64), n,
                                          xfe)[0], out.device)
    profiler.count(DRAWS, len(seeds) * total)
    profiler.count(EXACT_ROWS, len(redo))
    return out


def _layout(flat, n: int, xfe: bool):
    """(B, total) u64 draws in stream order -> the output layout."""
    if not xfe:
        return flat
    return np.ascontiguousarray(
        flat.reshape(flat.shape[0], n, 3).transpose(0, 2, 1))


def draw_plain(seed: bytes, offsets, n: int, xfe: bool = False,
               device="cpu"):
    """The plain version of `draw`: `utils/stdrng.drbg_bfes_batch` (numpy
    ChaCha12 blocks, Canon's step on exact ints, flagged rows redrawn with
    the scalar `ChaCha12Rng`) in the same layout, uploaded to `device`."""
    offsets = list(offsets)
    total = 3 * n if xfe else n
    flat = stdrng.drbg_bfes_batch(seed, offsets, total).astype(np.uint64)
    return gf.from_u64(_layout(flat.reshape(len(offsets), total), n, xfe),
                       device)
