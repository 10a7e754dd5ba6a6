"""Tip5 kernels: CUDA for tensors on the card, plain torch on the CPU.

K1 `permutation` and K2 `sponge_absorb_rows` launch the hand-written
kernels of csrc/tip5.cu for CUDA tensors, and run their plain torch
versions (`permutation_plain`, `sponge_absorb_rows_plain`) only for
tensors that lie on the CPU. There is no fallback: a CUDA tensor the kernel
cannot take raises.

The kernels are built at first use with `nvcc` into a shared library under
`triton_vm_tpu_torch/_build/` (keyed by the source's hash) and bound with
ctypes: a plain C interface keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..crypto import tip5
from ..fields.bfe import R, R_INV
from . import gf

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR / "csrc" / "tip5.cu"
BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KERNELS = ("tip5_permutation_kernel", "tip5_sponge_rows_kernel")

# Kernel launches since the last reset: one per launch, counted by the
# wrapper right where it launches, in all and by the card it launched on
# (a prover sharded over a mesh launches on every shard's card).
launches = {"tip5_permutation": 0, "tip5_sponge_rows": 0}
launches_by_device: dict = {}

_LOCK = threading.Lock()
_LIB = None
# seconds that each library built by this process took (nvcc's wall-clock)
BUILD_SECONDS: dict = {}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0
    launches_by_device.clear()


def _count(kernel, device):
    launches[kernel] += 1
    per = launches_by_device.setdefault(str(device), dict.fromkeys(launches,
                                                                   0))
    per[kernel] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the Tip5 kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _source_bytes(src: Path, include_dirs=()) -> bytes:
    """The bytes of `src` and of every file it includes with #include
    "..." (resolved beside the includer, else in `include_dirs`,
    recursively), so that an edited header changes the build's hash."""
    seen, out, todo = set(), [], [src]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        text = f.read_bytes()
        out.append(text)
        for m in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            name = m.decode()
            todo.append(next((d / name for d in (f.parent, *include_dirs)
                              if (d / name).exists()), f.parent / name))
    return b"".join(out)


def build(src: Path = _SRC) -> Path:
    """Compile `src` (csrc/tip5.cu by default, csrc/ntt.cu for
    ops/ntt_cuda.py; the probes in tools/ name other copies to time them
    in turns), if no library for this source and the files it includes
    exists yet, and return the library's path, lib<stem>_<hash>.so.
    ptxas's report (-v) is kept beside it, see `ptxas_report`."""
    src = Path(src)
    tag = hashlib.sha256(_source_bytes(src)
                         + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    BUILD_SECONDS[so] = time.perf_counter() - t0
    so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_parts(srcs, include_dirs=()) -> Path:
    """Compile the translation units `srcs` with relocatable device code
    (nvcc -rdc), all at once in parallel processes, and link them into one
    shared library, lib<first stem>_<hash>.so, if it does not exist yet
    (the hash over every unit and the files they include). ptxas's
    reports of all units are kept beside it, as `build` keeps one."""
    srcs = [Path(s) for s in srcs]
    include_dirs = tuple(Path(d) for d in include_dirs)
    tag = hashlib.sha256(b"".join(_source_bytes(s, include_dirs)
                                  for s in srcs)
                         + " ".join(_NVCC_FLAGS).encode()
                         + b"rdc").hexdigest()[:16]
    so = BUILD_DIR / f"lib{srcs[0].stem}_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in _NVCC_FLAGS if f != "-shared"]
    objs = [so.with_name(f"{s.stem}_{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [_nvcc(), *compile_flags, "-rdc=true", "-c",
         *(f"-I{d}" for d in include_dirs), "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    bad = [(s, p.returncode, log) for s, p, log in zip(srcs, procs, logs)
           if p.returncode != 0]
    if bad:
        s, rc, log = bad[0]
        raise RuntimeError(f"nvcc failed on {s.name} ({rc}):\n{log}")
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([_nvcc(), _NVCC_FLAGS[0], "-shared", "-o",
                           str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    BUILD_SECONDS[so] = time.perf_counter() - t0
    so.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return so


def ptxas_report(so: Path | None = None, kernels=KERNELS) -> dict:
    """Per kernel named in `kernels` of a built library (the current
    Tip5 source's by default; every function ptxas reported on, by its
    mangled name, if None): registers a thread, spill stores and loads,
    stack and static shared memory in bytes, as ptxas -v reported them at
    the build."""
    text = Path(so or build()).with_suffix(".ptxas.txt").read_text()
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = (m.group(1) if kernels is None else
                   next((k for k in kernels if k in m.group(1)), None))
            continue
        if cur is None:
            continue
        rec = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            rec["smem"] = int(m[1]) if m else 0
    return out


def bind(so: Path):
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tip5_permutation_launch.argtypes = [vp, vp, i64, vp]
    lib.tip5_permutation_launch.restype = ctypes.c_int
    lib.tip5_sponge_rows_launch.argtypes = [vp, i64, i64, i64, i64, vp, vp]
    lib.tip5_sponge_rows_launch.restype = ctypes.c_int
    lib.tip5_error_string.argtypes = [ctypes.c_int]
    lib.tip5_error_string.restype = ctypes.c_char_p
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build())
    return _LIB


def load() -> float:
    """Build and load the kernels now; returns the seconds it took."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


def _check(name, t, ndim):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def _raise_if(rc, name):
    if rc != 0:
        msg = _lib().tip5_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


# ------------------------------------------------------------ K1

def permutation(state):
    """Tip5 permutation of every column: int64 (16, B) -> (16, B)."""
    if state.device.type == "cpu":
        return permutation_plain(state)
    _check("tip5_permutation", state, 2)
    if state.shape[0] != tip5.STATE_SIZE or not state.is_contiguous():
        raise ValueError("tip5_permutation: expected a contiguous (16, B) "
                         f"state, got {tuple(state.shape)} strides "
                         f"{state.stride()}")
    out = torch.empty_like(state)
    batch = state.shape[1]
    if batch == 0:
        return out
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tip5_permutation_launch(state.data_ptr(), out.data_ptr(),
                                            batch, stream)
        _raise_if(rc, "tip5_permutation")
        _count("tip5_permutation", state.device)
    return out


# ------------------------------------------------------------ K2

def sponge_absorb_rows(rows):
    """Variable-length Tip5 sponge of every row: int64 (B, n) -> (5, B).

    `rows` may be any strided view with non-negative strides (a transposed
    column-major LDE, a strided slice of it): the kernel reads element j
    of row b at b * stride(0) + j * stride(1)."""
    if rows.device.type == "cpu":
        return sponge_absorb_rows_plain(rows)
    _check("tip5_sponge_rows", rows, 2)
    row_stride, col_stride = rows.stride()
    if row_stride < 0 or col_stride < 0:
        raise ValueError("tip5_sponge_rows: negative strides")
    batch, n = rows.shape
    out = torch.empty((tip5.DIGEST_LEN, batch), dtype=torch.int64,
                      device=rows.device)
    if batch == 0:
        return out
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tip5_sponge_rows_launch(rows.data_ptr(), n, batch,
                                            row_stride, col_stride,
                                            out.data_ptr(), stream)
        _raise_if(rc, "tip5_sponge_rows")
        _count("tip5_sponge_rows", rows.device)
    return out


# ------------------------------------------------------------ plain versions

_RC = [gf.to_i64(c) for c in tip5.ROUND_CONSTANTS]
_MDS = tip5.MDS_MATRIX_FIRST_COLUMN


def _split_and_lookup(v):
    lut = torch.tensor(tip5.LOOKUP_TABLE, dtype=torch.int64, device=v.device)
    raw = gf.mul_const(v, R)
    out = torch.zeros_like(raw)
    for k in range(8):
        out |= lut[(raw >> (8 * k)) & 0xFF] << (8 * k)
    return gf.mul_const(out, R_INV)


def _pow7(v):
    v2 = gf.mul(v, v)
    v4 = gf.mul(v2, v2)
    return gf.mul(gf.mul(v4, v2), v)


def _mds_half(x):
    """c * x for int64 32-bit halves x (16, ...), c =
    tip5.MDS_MATRIX_FIRST_COLUMN: out_i = sum_k c_k x_{(i - k) mod 16} in
    float64, as csrc/tip5.cu computes it on the FP64 pipe. Products are
    below 2^48 and sums below 2^52, so every step is exact."""
    xf = x.to(torch.float64)
    acc = torch.zeros_like(xf)
    for k, c in enumerate(_MDS):
        acc += c * torch.roll(xf, k, dims=0)
    return acc.to(torch.int64)


def _mds(s):
    """out_i = sum_k c_k * s_{(i - k) mod 16}: both 32-bit halves
    convolved (`_mds_half`), joined, one 128-bit reduction a lane."""
    acc_lo = _mds_half(s & gf.MASK32)
    acc_hi = _mds_half((s >> 32) & gf.MASK32)
    x_lo = acc_lo + (acc_hi << 32)
    carry = gf._ult(x_lo, acc_lo).to(torch.int64)
    x_hi = ((acc_hi >> 32) & gf.MASK32) + carry
    return gf._reduce128(x_lo, x_hi)


def permutation_plain(state):
    """Plain torch Tip5 permutation: int64 (16, B) -> (16, B)."""
    s = state
    for r in range(tip5.NUM_ROUNDS):
        s = torch.cat([_split_and_lookup(s[:4]), _pow7(s[4:])])
        s = _mds(s)
        rc = torch.tensor(_RC[r * 16:(r + 1) * 16], dtype=torch.int64,
                          device=s.device)
        s = gf.add(s, rc[:, None])
    return s


def sponge_absorb_rows_plain(rows):
    """Plain torch row sponge: int64 (B, n) -> digests (5, B)."""
    b, n = rows.shape
    total = -(-(n + 1) // tip5.RATE) * tip5.RATE
    padded = torch.zeros((b, total), dtype=torch.int64, device=rows.device)
    padded[:, :n] = rows
    padded[:, n] = 1
    state = torch.zeros((tip5.STATE_SIZE, b), dtype=torch.int64,
                        device=rows.device)
    for c in range(total // tip5.RATE):
        chunk = padded[:, c * tip5.RATE:(c + 1) * tip5.RATE].T
        state = permutation_plain(torch.cat([chunk, state[tip5.RATE:]]))
    return state[:tip5.DIGEST_LEN].contiguous()
