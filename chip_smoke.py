#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`triton_vm_tpu_torch`) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases kernels

Phases, in order; any failure exits non-zero and prints no result line:

1. versions, the card's name and power limit, the build of both Tip5
   kernels from csrc/ (seconds printed) and ptxas's report for each
   (registers, spills, stack, shared memory);
2. K1 (Tip5 permutation) against its plain torch version on the card
   (2^18 random states, edge-value states, the MDS's worst-case states,
   a ragged 2^18 + 3 batch) and 8 states against the host
   `tip5.permutation_python`; kernel and plain times at B = 2^17, and
   kernel times at every Merkle layer's batch, 2^0 .. 2^17, summed over
   the K1 launches of a spin_32768 prove;
3. K2 (Tip5 row sponge) against its plain version for 2^18 rows of 15,
   273 and 379 elements, row-major and column-major (the commit stage's
   layout), and a column-strided input, and a few rows against the host
   `tip5.hash_varlen`; kernel times at all three widths, column-major
   (their sum is K2's time per spin_32768 prove), plain time at 379;
4. the main path on the card: `prove_program` on fibonacci input 85
   (padded height 2^10) with seed bytes(range(32)), the proof digest held
   against the JAX package's, `Stark.verify` accepting it and rejecting a
   tampered word with a verification error;
5. the main path at padded height 2^15 (`spin(15)`, LDT domain 2^18):
   prove and verify.

The launch counts of both kernels are set to 0 just before phase 4 and
read after phase 5; both must be above 0, and the spin_32768 prove must
launch K1 once per Merkle layer, as the per-prove K1 total assumes.
The line before the last is a JSON object with each kernel's numbers;
the last line is the device record. Needs one card, no network;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SEED = bytes(range(32))
# Proof digest tip5.hash_varlen([len(w) + 1, len(w)] + w) of the JAX
# package's proof of fibonacci input 85 with seed bytes(range(32)),
# computed on the CPU with:
#   JAX_PLATFORMS=cpu python -c "
#   from triton_vm_tpu.models import example_programs as ex
#   from triton_vm_tpu.stark.proof_stream import Claim
#   from triton_vm_tpu.stark.prover import Stark
#   from triton_vm_tpu.vm.machine import VM, PublicInput
#   from triton_vm_tpu.crypto import tip5
#   p = ex.fibonacci(); aet, out = VM.trace_execution(p, PublicInput([85]))
#   c = Claim.about_program(p).with_input([85]).with_output(out)
#   w = Stark().prove(c, aet, seed=bytes(range(32))).words
#   print(tip5.hash_varlen([len(w) + 1, len(w)] + w))"
JAX_FIB85_DIGEST = (6144958900407217928, 9077105590016610808,
                    16174150112158250861, 17868824170144435741,
                    5525090009455519693)

# Work of one Tip5 permutation in 32-bit integer multiplies (the H100's
# integer pipe issues 64 of them per SM per clock; a 32 x 32 -> 64-bit
# product counts as 2). Only products of two run-time values count: per
# round, the 48 products of the x^7 chains (4 partial products each) and
# the 256 MDS taps on 2 halves. The S-box's Montgomery products and the
# 2^64 = 2^32 - 1 reductions multiply by constants (R = 2^32 - 1,
# R^-1 = -2^32 and eps = 2^32 - 1 mod p), which are shifts and adds. The
# count is the direct circulant's work whatever computes it: the kernel
# runs the MDS's 512 products a round as FP64 FMAs, off the integer pipe.
INT32_OPS_PER_PERMUTATION = 5 * (48 * 4 * 2 + 256 * 2 * 2)
INT32_OPS_PER_SM_PER_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

SOURCE = "triton_vm_tpu_torch/csrc/tip5.cu"


def log(msg):
    print(msg, flush=True)


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean milliseconds of fn() on the card (CUDA events, after a warm-up
    call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b):
    """Largest |a - b| over two int64 tensors read as u64 field words."""
    from triton_vm_tpu_torch.ops import gf

    x, y = gf.to_u64(a), gf.to_u64(b)
    bad = x != y
    if not bad.any():
        return 0
    return max(abs(int(p) - int(q)) for p, q in zip(x[bad], y[bad]))


def random_field(rng, shape):
    import numpy as np

    from triton_vm_tpu_torch.fields.bfe import P

    return rng.integers(0, P, size=shape, dtype=np.uint64)


def worst_case_states():
    """(16, 5) states at the MDS's largest halves among field elements:
    every word p - 1 (high half 2^32 - 1), every word 2^32 - 1 (low half
    2^32 - 1), and each alternating with 0 (tests/test_torch_mds.py holds
    the plain version at the same states against the JAX package)."""
    import numpy as np

    from triton_vm_tpu_torch.fields.bfe import P

    lo, hi = 2**32 - 1, P - 1
    cols = [[hi] * 16, [lo] * 16, [0, hi] * 8, [hi, 0] * 8, [0, lo] * 8]
    return np.array(cols, np.uint64).T.copy()


def k1_batches_per_prove(log_domain=18, log_last=10):
    """log2 of the batch of every K1 launch in a spin_32768 prove, one per
    Merkle layer: the main, aux and quotient trees over the 2^18-row LDT
    domain and the FRI trees over codewords of 2^18 down to 2^10 rows."""
    trees = [log_domain] * 3 + list(range(log_domain, log_last - 1, -1))
    return [k for m in trees for k in range(m)]


class Bound:
    """Least time the card could take: bytes over HBM bandwidth vs int32
    multiplies over the integer pipe's peak."""

    def __init__(self):
        import torch

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = float(smi("clocks.max.sm").split()[0])
        self.int_ops_per_s = sms * INT32_OPS_PER_SM_PER_CLOCK * mhz * 1e6
        log(f"integer peak: {sms} SMs x {INT32_OPS_PER_SM_PER_CLOCK} "
            f"int32 ops/clock x {mhz:.0f} MHz = "
            f"{self.int_ops_per_s / 1e12:.2f} Tops/s")

    def __call__(self, bytes_moved, permutations):
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = permutations * INT32_OPS_PER_PERMUTATION / self.int_ops_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")


def phase_build():
    """Build both kernels; returns ptxas's report for each (registers,
    spills, stack and shared memory)."""
    import torch

    from triton_vm_tpu_torch.ops import tip5_cuda

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    secs = tip5_cuda.load()
    log(f"built Tip5 kernels from {SOURCE} in {secs:.1f} s")
    report = tip5_cuda.ptxas_report()
    for name, rec in report.items():
        log(f"ptxas {name}: {json.dumps(rec)}")
    return report


def phase_k1(rng, bound):
    import numpy as np

    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.ops import gf, tip5_cuda

    errs = []
    for b in (1 << 18, (1 << 18) + 3):
        s = gf.from_u64(random_field(rng, (16, b)), "cuda")
        errs.append(max_abs_err(tip5_cuda.permutation(s),
                                tip5_cuda.permutation_plain(s)))
    edge = [0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**63, P - 2**32,
            2**64 - 2**32]
    e = np.array([[edge[(i + j) % len(edge)] % P for j in range(64)]
                  for i in range(16)], np.uint64)
    s = gf.from_u64(e, "cuda")
    errs.append(max_abs_err(tip5_cuda.permutation(s),
                            tip5_cuda.permutation_plain(s)))
    s = gf.from_u64(worst_case_states(), "cuda")
    errs.append(max_abs_err(tip5_cuda.permutation(s),
                            tip5_cuda.permutation_plain(s)))
    host = random_field(rng, (16, 8))
    got = gf.to_u64(tip5_cuda.permutation(gf.from_u64(host, "cuda")))
    for j in range(8):
        want = tip5.permutation_python([int(x) for x in host[:, j]])
        if [int(x) for x in got[:, j]] != want:
            raise AssertionError(f"K1 disagrees with permutation_python "
                                 f"on state {j}")
    # main-path shape: the widest Merkle layer of a 2^18-leaf tree
    b = 1 << 17
    s = gf.from_u64(random_field(rng, (16, b)), "cuda")
    errs.append(max_abs_err(tip5_cuda.permutation(s),
                            tip5_cuda.permutation_plain(s)))
    err = max(errs)
    if err:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    ms = time_ms(lambda: tip5_cuda.permutation(s), 20)
    plain_ms = time_ms(lambda: tip5_cuda.permutation_plain(s), 2)
    bound_ms, bound_by = bound(2 * 16 * 8 * b, b)
    log(f"K1 ok (max_abs_err 0); B=2^17: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # every Merkle layer's batch, 2^0 .. 2^17, for the per-prove total
    by_batch = {}
    for k in range(18):
        layer = gf.from_u64(random_field(rng, (16, 1 << k)), "cuda")
        by_batch[k] = (time_ms(lambda: tip5_cuda.permutation(layer),
                               20 if k > 12 else 200),
                       bound(2 * 16 * 8 * (1 << k), 1 << k)[0])
    batches = k1_batches_per_prove()
    prove_ms = sum(by_batch[k][0] for k in batches)
    prove_bound_ms = sum(by_batch[k][1] for k in batches)
    log(f"K1 per spin_32768 prove ({len(batches)} launches, one per Merkle "
        f"layer): {prove_ms:.4f} ms, bound {prove_bound_ms:.4f} ms")
    return dict(name="tip5_permutation", route="cuda", source=SOURCE,
                replaces="triton_vm_tpu/ops/tip5_pallas.py:157",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                ms_by_width={f"2^{k}": t for k, (t, _) in by_batch.items()},
                per_prove_ms=prove_ms, per_prove_bound_ms=prove_bound_ms)


def phase_k2(rng, bound):
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.ops import gf, tip5_cuda

    errs = []
    b = 1 << 18
    col_major = {}
    for n in (15, 273, 379):
        # row-major (B, n), and the commit stage's layout: a column-major
        # (n, B) LDE read through .T, strides (1, B)
        col_major[n] = gf.from_u64(random_field(rng, (n, b)), "cuda").T
        for rows in (gf.from_u64(random_field(rng, (b, n)), "cuda"),
                     col_major[n]):
            errs.append(max_abs_err(
                tip5_cuda.sponge_absorb_rows(rows),
                tip5_cuda.sponge_absorb_rows_plain(rows)))
    timed = col_major[379]  # main-path shape: the main table
    # column-strided: a column-major (n, B) block read as (B, n) rows,
    # every second row, as the commit stage reads a strided LDE
    cols = gf.from_u64(random_field(rng, (379, 2 * 4096 + 1)), "cuda")
    strided = cols.T[::2]
    errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(strided),
                            tip5_cuda.sponge_absorb_rows_plain(strided)))
    host = random_field(rng, (6, 379))
    got = gf.to_u64(tip5_cuda.sponge_absorb_rows(gf.from_u64(host, "cuda")))
    for j in range(6):
        want = tip5.hash_varlen([int(x) for x in host[j]])
        if [int(x) for x in got[:, j]] != want:
            raise AssertionError(f"K2 disagrees with hash_varlen on row {j}")
    err = max(errs)
    if err:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    # the three committed tables of a spin_32768 prove: main, aux, quotient
    by_width = {}
    for n, rows in col_major.items():
        # ceil((n + 1) / RATE) permutations a row, as the kernel runs
        perms = b * ((n + tip5.RATE) // tip5.RATE)
        by_width[n] = (time_ms(lambda: tip5_cuda.sponge_absorb_rows(rows),
                               5 if n > 100 else 40),
                       *bound(8 * b * (n + 5), perms))
        log(f"K2 2^18 x {n} column-major: kernel {by_width[n][0]:.4f} ms, "
            f"bound {by_width[n][1]:.4f} ms ({by_width[n][2]})")
    ms, bound_ms, bound_by = by_width[379]
    plain_ms = time_ms(lambda: tip5_cuda.sponge_absorb_rows_plain(timed), 1)
    prove_ms = sum(t for t, _, _ in by_width.values())
    prove_bound_ms = sum(t for _, t, _ in by_width.values())
    log(f"K2 ok (max_abs_err 0); 2^18 x 379: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({bound_by}); per "
        f"spin_32768 prove (3 launches): {prove_ms:.3f} ms, bound "
        f"{prove_bound_ms:.3f} ms")
    return dict(name="tip5_sponge_rows", route="cuda", source=SOURCE,
                replaces="triton_vm_tpu/ops/tip5_pallas.py:233",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                ms_by_width={str(n): t for n, (t, _, _) in by_width.items()},
                per_prove_ms=prove_ms, per_prove_bound_ms=prove_bound_ms)


def _launches_since(before):
    from triton_vm_tpu_torch.ops import tip5_cuda

    return {k: v - before[k] for k, v in tip5_cuda.launches.items()}


def prove_and_verify(label, program, public_input):
    """The main path on the card: prove_program, then verify, then a
    tampered proof word must be rejected with a verification error (any
    other exception, such as a failed kernel launch, fails the run).
    Returns the proof and the kernel launches of the prove and of the
    (accepting) verify."""
    import torch

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.ldt.fri import LdtError
    from triton_vm_tpu_torch.stark.codec import DecodeError
    from triton_vm_tpu_torch.ops import tip5_cuda
    from triton_vm_tpu_torch.utils import profiler

    torch.cuda.reset_peak_memory_stats()
    before = dict(tip5_cuda.launches)
    profiler.start(label)
    t0 = time.perf_counter()
    stark, claim, proof = tvm.prove_program(program, public_input,
                                            seed=SEED, device="cuda")
    prove_s = time.perf_counter() - t0
    stages = profiler.finish().spans()
    launches = {"prove": _launches_since(before)}
    before = dict(tip5_cuda.launches)
    t0 = time.perf_counter()
    if not stark.verify(claim, proof):
        raise AssertionError(f"{label}: verify rejected the proof")
    verify_s = time.perf_counter() - t0
    launches["verify"] = _launches_since(before)
    bad = list(proof.words)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % P
    try:
        accepted = stark.verify(claim, tvm.Proof(bad))
        rejection = "False"
    except (tvm.VerificationError, LdtError, DecodeError) as e:
        accepted = False
        rejection = f"{type(e).__name__}: {e}"
    if accepted:
        raise AssertionError(f"{label}: verify accepted a tampered proof")
    log(f"{label}: tampered proof rejected ({rejection})")
    log(f"{label}: padded height {proof.padded_height()}, "
        f"{len(proof.words)} words, prove {prove_s:.3f} s, "
        f"verify {verify_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{label} stages (s): " + json.dumps(
        {name: round(sec, 4) for name, sec, _ in stages}))
    log(f"{label} kernel launches: " + json.dumps(launches))
    return proof, launches


def phase_main_path(phases):
    """Both workloads of the main path, with every launch count set to 0
    just before and read just after. Returns the counts."""
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.ops import tip5_cuda

    tip5_cuda.reset_launch_counts()
    if "fib_1024" in phases:
        proof, _ = prove_and_verify("fib_1024", ex.fibonacci(), [85])
        w = proof.words
        digest = tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w))
        if digest != JAX_FIB85_DIGEST:
            raise AssertionError(f"fib_1024 proof digest {digest} != the "
                                 f"JAX package's {JAX_FIB85_DIGEST}")
        log("fib_1024 proof digest equals the JAX package's")
    if "spin_32768" in phases:
        program, iterations = ex.spin(15)
        proof, launches = prove_and_verify("spin_32768", program,
                                           [iterations])
        if proof.padded_height() != 1 << 15:
            raise AssertionError("spin(15) did not reach padded height 2^15")
        k1 = launches["prove"]["tip5_permutation"]
        if k1 != len(k1_batches_per_prove()):
            raise AssertionError(f"spin_32768 launched K1 {k1} times, not "
                                 "once per Merkle layer as the per-prove "
                                 "K1 total assumes")
    total = dict(tip5_cuda.launches)
    log(f"kernel launches on the main path, in all: {json.dumps(total)}")
    for name, n in total.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,fib_1024,spin_32768",
                    help="comma-separated subset of: kernels, fib_1024, "
                         "spin_32768")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import triton_vm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    import numpy as np

    name_power = smi("name,power.limit")
    report = phase_build()
    rng = np.random.default_rng(2024)
    kernels = []
    if "kernels" in phases:
        bound = Bound()
        kernels = [phase_k1(rng, bound), phase_k2(rng, bound)]
    launches = {}
    if phases & {"fib_1024", "spin_32768"}:
        launches = phase_main_path(phases)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        k["regs"] = report[k["name"] + "_kernel"]["registers"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
