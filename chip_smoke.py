#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`triton_vm_tpu_torch`) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases kernels,spin_65536

Phases, in order (`--phases` names in brackets); any failure exits
non-zero and prints no result line. Every path that proves and verifies
prints its prove's profile (the stage spans, and the spans within them
as `stage/span`) and beside it its verify's (`verify` and its parts
`verify/decode`, `AIR`, `DEEP`, `LDT`, `merkle`), each from a profiler
session of its own:

1. versions, the card's name and power limit, the build of both Tip5
   kernels, of K3 (its source generated from the row tape, its units
   compiled in parallel processes), of K4 and of the randomizer kernel
   from csrc/ (the four builds started together, seconds printed) and
   ptxas's report for each
   kernel (registers, spills, stack, shared memory; K3's segment kernels
   summed, with its build's seconds);
2. [kernels] K1 (Tip5 permutation) against its plain torch version on
   the card (2^18 random states, edge-value states, the MDS's worst-case
   states, a ragged 2^18 + 3 batch) and 8 states against the host
   `tip5.permutation_python`; kernel and plain times at B = 2^17, and
   kernel times at every Merkle layer's batch, 2^0 .. 2^18, summed over
   the K1 launches of a spin_32768 and of a spin_65536 prove;
3. [kernels] K2 (Tip5 row sponge) against its plain version for 2^18
   rows of 15, 273 and 379 elements, row-major and column-major (the
   commit stage's layout), a column-strided input, 2^17 rows of 12 (the
   STIR leaf rows) and, column-major, 2^19 rows of 379, 273 and 15 (a
   spin_65536 prove's commit launches), and a few rows against the host
   `tip5.hash_varlen`; kernel times at all four widths, plain times at
   379 and 12, and K2's time per spin_32768 and per spin_65536 prove
   (every launch's shape timed);
3b. [kernels] K3 (the AIR quotient: the row tape compiled into segment
   kernels by ops/tape_codegen.py around csrc/quotient.cu) against its plain
   version (`quotients_on_rows_plain`, the CPU prover's quotient path) at
   the full widths on 2^16 random rows, a ragged 2^16 + 3, edge values,
   aux as a permuted view and a mesh shard's rows with their halo, both
   timed at 2^16; K3 timed at every prove's launch shape (2^13 to 2^22
   rows) and summed per prove, and held against its plain version over
   every row of a 2^20 prove's 2^21-row JIT coset (its next-row shift,
   aux a permuted view);
3c. [kernels] K4 (the Goldilocks NTT, csrc/ntt.cu) against its plain
   version (the scales as gf.mul and the radix-2 network
   `ntt._transform_plain`) at every launch class: Bezout-style short
   batches (8192 rows of 2 words to 64 of 2^12, zero-padded), 379 and
   273 rows of 2^13 to 2^21 words with a coset offset, 3 and 15 rows of
   2^22 to 2^24 words, an iNTT with its scale, `lde` with padding, a
   ragged 1001 rows; each timed with its bound, the plain version timed
   at the 379 x 2^21 coset of a 2^20 prove;
3d. [kernels] the randomizer kernel (ChaCha12 draws of field elements,
   csrc/chacha12.cu) against its plain version (the host's numpy
   keystream, `stdrng_cuda.draw_plain`) at a 2^20 and a 2^16 prove's four
   draw calls (379 rows of ntr BFEs, 91 rows of ntr XFEs, the batch
   randomizer's h XFEs, the quotient randomizer's n_qr XFEs), two seeds
   each; kernel times at every call shape of 2^15, 2^16, 2^17 and 2^20
   proves beside the bound, summed per prove, the plain version's beside;
4. [fib_1024] the main path on the card: `prove_program` on fibonacci
   input 85 (padded height 2^10, FRI) with seed bytes(range(32)), the
   proof digest held against the JAX package's, `Stark.verify` accepting
   it and rejecting a tampered word with a verification error;
5. [spin_32768] the main path at padded height 2^15 (`spin(15)`, LDT
   domain 2^18, FRI): prove and verify;
6. [fib_1024_stir] `prove` with `Stark(ldt_choice="stir")` on fibonacci
   input 85: the digest held against the JAX package's STIR proof,
   verify, tamper check;
7. [spin_65536] the main path at padded height 2^16 (`spin(16)`, LDT
   domain 2^19), where `Stark` chooses STIR: prove, verify, tamper check;
   its digest held against the same proof with the randomizers drawn on
   the host (HOST_RNG_SPIN16_DIGEST);
8. [spin_65536_jit] the same claim and seed with the JIT LDE forced
   (`config.overwrite_lde_trace_caching_to(CacheDecision.JIT)`, 4 cosets
   a table): the proof must equal spin_65536's word for word; verify,
   tamper check;
9. [mesh] the prover sharded over TVM_MESH=4 shards (parallel/mesh.py,
   ops/ntt_sharded.py; shard i on cuda:(i % device_count), so all four on
   one card of a one-card host), TVM_MESH restored afterwards: first K2
   at a shard's commit block (2^17 rows of 379 and of 273, column-major
   as the exchange delivers it) and K1 at a shard subtree's widest layer
   (2^16) against their plain versions; then mesh_fib_1024
   (`prove_program` on fibonacci input 85, digest held against the JAX
   package's) and mesh_spin_65536 (spin(16), STIR, cached, the six-step
   transform asserted in STIR's tall transforms): its proof must equal
   spin_65536's from the same run word for word (spin_65536 runs first
   whenever mesh does); verify, tamper check, stage spans, the peak of
   every card, K1/K2 launches by card, prove wall-clock beside
   spin_65536's;
10. [recursive_verifier] BASELINE config 5, the verifier in the VM, as
   the JAX bench builds it (bench.py:107-121), all with the port:
   fibonacci input 7 proven with Stark() on the card (digest held against
   the JAX package's), `models/recursive_verifier.build` for one revealed
   index; the in-VM AIR evaluation within 200 cycles of the
   specification's 33,998 rows, the `combined` trace's table heights
   equal to the JAX package's (padded height 2^17), a tampered revealed
   row rejected in the VM (VMError); then the `combined` execution
   proven on the card with Stark() (STIR, cached LDE, both asserted),
   verified, a tampered word rejected, with the stage spans, the RAM
   table's Bezout step as `RAM table/RAM Bezout` (within `fill main/host
   table fill`), the peak device memory
   and the K1/K2 launches of the prove;
11. [factorial_4096], [hash_chain], [merkle_auth] bench.py's configs of
   those names as models/baseline.py builds them: factorial input 500
   (padded height 2^13; bench.py's name notwithstanding), BASELINE config
   3, the Tip5 hash chain, input 200 (2^14), and config 4, the Merkle
   authentication path of a height-10 tree with its sibling digests
   divined (2^10); each proven with Stark() (FRI) and seed
   bytes(range(32)), its digest held against the JAX package's, verified,
   a tampered word rejected, K1/K2 launches counted as for spin;
12. [hash_chain_65536] config 3 at padded height 2^16 (input 4000: 24,036
   hash and 64,260 cascade rows), STIR and the cached LDE asserted: prove,
   verify, tamper check, stage spans, peak, K1/K2 launches;
13. [spin_1048576] the main path at padded height 2^20 (`spin(20)`, LDT
   domain 2^23), where the cache decision chooses JIT on an 80 GB card
   (asserted from the prove's JIT spans): prove, verify, tamper check,
   with the stage spans, the JIT spans within them and the peak device
   memory;
14. [witness] the device-resident witness (`main_witness_dev`,
   `aux_witness_dev`) on the card for `u32_mix`, `spin(12)`, config 5's
   `fs_replay` and `queries` sections and hash_chain_65536's trace
   (padded height 2^16 each), word for word against the same functions on
   CPU tensors (which tier-1 holds to the JAX package's host witness),
   with the card's and the CPU's times;
15. [bench] the port's benchmark entry point as a user runs it,
   `python -m triton_vm_tpu_torch.bench`, in a process of its own for
   fib_1024 and for spin_65536 with TVM_BENCH_SOL=1 and TVM_PROFILE=1 (the
   cold and the warm prove's profiles on stderr): it must exit 0 and
   its last line must be a whole result (no `partial` or `incomplete`;
   `stages`, `verify_s` and `sol` present); every line is printed, and
   the speed-of-light pass's K1 and K2 times beside the kernels phase's.

[spin_262144] and [spin_524288], run only when `--phases` names them,
prove `spin(18)` and `spin(19)` (padded heights 2^18 and 2^19, LDT
domains 2^21 and 2^22) on the cached path the heuristic chooses there
(asserted), to record its peak device memory. [recursive_verifier_full],
also only when named, is config 5 with every revealed index (173) checked
in the VM, a full verification: padded height 2^21, JIT asserted; before
it, K1 at B = 2^23 and K2 at its shapes (2^22 rows of 379 and 273
column-major, 2^24 rows of 15, 2^22 rows of 12) are held against their
plain versions, and both kernels' per-prove totals are timed.
[spin_131072] and [spin_131072_jit], only when named (both together),
prove `spin(17)` (padded height 2^17, the largest cached cell's) on the
cached path and then with the JIT LDE forced, the same claim and seed:
the JIT proof must equal the cached one word for word, as in 8.
[hash_chain_1048576], only when named (in a call of its own, after
`kernels`, which holds its shapes, spin_1048576's), is config 3 at padded
height 2^20 (input 40000: 240,036 hash rows, a full cascade table of
65,536 rows), JIT asserted: prove, verify, tamper check, stage spans
with the JIT spans, peak.

The kernels phase also holds K1 at B = 2^20 and 2^22, K2 at 2^13, 2^16
and 2^17 rows of 379, 273 and 15 (column-major, the commits of
merkle_auth, factorial_4096 and hash_chain), at 2^20 rows of 379, 273
and 15 (column-major, the recursive_verifier prove's commits), 2^21 rows
of 379 and 273 (column-major, a JIT coset as the commit reads it), 2^23
rows of 15 and 2^21 rows of 12 (the widest STIR tree's leaves) against
their plain versions, and sums K1 and K2 per prove of every path but the
mesh's (`PER_PROVE_HEIGHTS`). `torch.cuda.empty_cache()` runs before
each proving path, so one path's cached blocks move neither the next
one's cache decision nor its peak. The launch counts of the kernels are
set to 0 just before each proving path (phases 4-13) and read just after
it (the bench's process starts from 0 and prints the launches of its
proves and verify, its speed-of-light pass left out); all four must be
above 0 on every path, and every prove but fib_1024's,
fib_1024_stir's and the mesh's (which counts its own) must launch K1
once per Merkle layer, K2 once per committed table (once per hashed
coset of the main and aux tables on the JIT path) and STIR tree, and K3
once (once per coset on the JIT path; a call launches a first kernel, one
a segment and a last one per chunk of rows, and each launch counts), as
the per-prove totals assume. No single-device prove may build a power
table of more than 2^12 words on the host (`npfield.long_tables`), and
every prove draws all its randomizers on the card: its profile's
`randomizer draws` must equal the four calls' draws at its height, and
the host keystream raises (rows the kernel flagged, redrawn on the host
with the scalar `ChaCha12Rng`, are printed).
While a path proves, the quotient stage's level-tape chunk function,
K3's plain versions and the NTT's plain network raise if handed a tensor
on the card (the derived columns' fill still runs `run_tape_scan` there),
and K4's calls are recorded by shape; after the paths, K4 is timed at
every shape they called it with and summed per path (K4 launches once a
pass: twice a transform above 2^12 words). The line before the last
is a JSON object with each kernel's numbers (launches summed over every
path, config 5's inner proof and build and the bench's proves included);
the last line is the device record. Needs one card, no network; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import json
import os
import re
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
# The same for the JAX package's STIR proof of the same claim and seed:
# the command above with Stark(ldt_choice="stir").
JAX_FIB85_STIR_DIGEST = (2557357267674768290, 7933928826770184855,
                         14971441563586756986, 17186831512452120839,
                         5748930431668251739)
# The same for the JAX package's proof of fibonacci input 7 with Stark()
# and the same seed, the inner proof of BASELINE config 5 (the JAX
# bench.py's TVM_BENCH=recursive_verifier): the command above with
# PublicInput([7]) and .with_input([7]).
JAX_FIB7_DIGEST = (16776481165773445315, 11632406580342972184,
                   4551248486225805797, 9432930646896196063,
                   16369719787940908687)
# The same for bench.py's factorial_4096 and BASELINE configs 3 and 4
# (models/baseline.config), with Stark() and the same seed, computed with
# TVM_DEVICE_QUOTIENT=1 (the JAX package's default quotient path on the
# CPU holds every node of the constraint graph as Python ints over the
# quotient domain, tens of GB of host memory at 2^13; =1 runs its
# compiled tapes in chunks of 2^16 rows, and merkle_auth's digest is the
# same on both paths):
#   JAX_PLATFORMS=cpu TVM_DEVICE_QUOTIENT=1 python -c "
#   from triton_vm_tpu.models import example_programs as ex
#   from triton_vm_tpu.stark.proof_stream import Claim
#   from triton_vm_tpu.stark.prover import Stark
#   from triton_vm_tpu.vm.machine import VM, PublicInput
#   from triton_vm_tpu.crypto import tip5
#   p, i, nd = ex.factorial(), [500], None
#   aet, out = VM.trace_execution(p, PublicInput(i), nd)
#   c = Claim.about_program(p).with_input(i).with_output(out)
#   w = Stark().prove(c, aet, seed=bytes(range(32))).words
#   print(tip5.hash_varlen([len(w) + 1, len(w)] + w))"
# factorial input 500, padded height 2^13:
JAX_FACTORIAL500_DIGEST = (4846685011731684962, 15020475707371369917,
                           313231693343479167, 5628249499949679645,
                           12137424526558821888)
# hash_chain input 200, padded height 2^14: the command above with
# p, i, nd = ex.hash_chain(), [200], None
JAX_HASH_CHAIN200_DIGEST = (13857134945194945349, 8145041707390557774,
                            3678209363899394061, 2905766062769593517,
                            10266487826333771854)
# merkle_auth, padded height 2^10: the command above, run from the repo
# root, with p, i, nd = tests.test_torch_baseline_configs.jax_merkle_auth(
# 10): bench.py's _merkle_auth_fixture(height=10) with its leaves drawn as
# uint64 (numpy refuses the fixture's int64 draw below P)
JAX_MERKLE_AUTH10_DIGEST = (12152112950504017383, 1379961327953900138,
                            949879719169528230, 3516083558584882264,
                            17984510444708907256)
# bench.py's configs proven on FRI: the JAX digest and log2 of the padded
# height
BASELINE_CELLS = {"factorial_4096": (JAX_FACTORIAL500_DIGEST, 13),
                  "hash_chain": (JAX_HASH_CHAIN200_DIGEST, 14),
                  "merkle_auth": (JAX_MERKLE_AUTH10_DIGEST, 10)}
# Config 5's verifier-core program (models/recursive_verifier.build on
# that proof): revealed indices checked in-VM, the table heights of the
# JAX package's trace of its `combined` section, and log2 of the padded
# height. Computed on the CPU with triton_vm_tpu.models.recursive_verifier
# .build(claim, proof, Stark(), num_queries), then VM.trace_execution of
# programs["combined"] with its non-determinism and aet.height_of_table.
RV_CELLS = {
    "recursive_verifier": (1, dict(
        processor=53823, op_stack=97202, ram=43793, hash=60982,
        program=94090, cascade=65529, lookup=256, u32=102,
        jump_stack=53823), 17),
    "recursive_verifier_full": (173, dict(
        processor=795143, op_stack=1238250, ram=538637, hash=903712,
        program=1313740, cascade=65536, lookup=256, u32=11017,
        jump_stack=795143), 21),
}
PATHS = ("fib_1024", "spin_32768", "fib_1024_stir", "spin_65536",
         "spin_65536_jit", "mesh", "recursive_verifier", "factorial_4096",
         "hash_chain", "merkle_auth", "hash_chain_65536", "spin_1048576",
         "spin_262144", "spin_524288", "recursive_verifier_full",
         "hash_chain_1048576", "spin_131072", "spin_131072_jit")
PHASES = ("kernels",) + PATHS + ("witness", "bench")
OPTIONAL_PHASES = ("spin_262144", "spin_524288", "recursive_verifier_full",
                   "hash_chain_1048576", "spin_131072", "spin_131072_jit")
DEFAULT_PHASES = tuple(p for p in PHASES if p not in OPTIONAL_PHASES)
SPIN_HEIGHTS = {"spin_32768": 15, "spin_65536": 16, "spin_65536_jit": 16,
                "spin_1048576": 20, "spin_262144": 18, "spin_524288": 19,
                "spin_131072": 17, "spin_131072_jit": 17}
# the forced-JIT paths, each held against the cached proof of its twin
JIT_TWINS = {"spin_65536_jit": "spin_65536", "spin_131072_jit": "spin_131072"}
# BASELINE config 3 at the prover's heights: hash_chain input 4000 and
# 40000 (log2 of the padded height)
HASH_CHAIN_CELLS = {"hash_chain_65536": (4000, 16),
                    "hash_chain_1048576": (40000, 20)}
# the paths whose K1 and K2 totals per prove the kernels phase sums, with
# log2 of their padded heights (JIT from 2^20); per_prove_ms in the
# kernels line
PER_PROVE_HEIGHTS = (("spin_32768", 15), ("spin_65536", 16),
                     ("recursive_verifier", 17), ("spin_1048576", 20),
                     ("fib_1024", 10), ("merkle_auth", 10),
                     ("factorial_4096", 13), ("hash_chain", 14),
                     ("hash_chain_65536", 16), ("hash_chain_1048576", 20))
MESH_SHARDS = 4  # TVM_MESH of the mesh phase
# bench.py's configs the bench phase runs through the port's entry point,
# each in a process given a little more than the entry point's 540 s budget
BENCH_CONFIGS = ("fib_1024", "spin_65536")
BENCH_TIMEOUT_S = 600
# prove and verify wall-clock (s) of each path's proof, by label
WALL = {}

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
SOURCE_K3 = "triton_vm_tpu_torch/csrc/quotient.cu"
# K3's row tape is compiled into its source by this generator
GENERATOR_K3 = "triton_vm_tpu_torch/ops/tape_codegen.py"
# K3 has no Pallas counterpart: the JAX package jits the same function
K3_REPLACES = "triton_vm_tpu/stark/prover.py:1185"
SOURCE_K4 = "triton_vm_tpu_torch/csrc/ntt.cu"
# neither has K4: the JAX package computes the transform with XLA
K4_REPLACES = "triton_vm_tpu/ops/ntt.py:70"
SOURCE_RNG = "triton_vm_tpu_torch/csrc/chacha12.cu"
# 32-bit operations of one ChaCha12 block: 6 double rounds of 8 quarter
# rounds of 4 adds, 4 xors and 4 rotates, then 16 adds of the input state
INT32_OPS_PER_CHACHA12_BLOCK = 6 * 8 * 12 + 16
# Proof digest (as JAX_FIB85_DIGEST's) of spin(16) proven on the card with
# seed bytes(range(32)) by the port as it was before the randomizers were
# drawn on the card (the host's numpy keystream, uploaded): a card proof
# at padded height 2^16 must still equal it word for word, since any
# randomizer gives a valid proof and `verify` cannot tell.
# Computed on an H100 at commit e4d2b62, where the prover drew them on the
# host: tip5.hash_varlen over the words of
#   Stark(device="cuda").prove(spin(16)'s claim and trace,
#                              seed=bytes(range(32)))
HOST_RNG_SPIN16_DIGEST = (2241502005789772168, 4913934641578679542,
                          12900401482629750527, 9375485281862461012,
                          13677339184192693677)
# K4's call shapes on each proving path of this run, by path: Counter of
# (rows, n_in, length, input scaled, output scaled)
K4_CALLS = {}


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


def ldt_tree_leaves(ldt):
    """log2 leaf count of each Merkle tree the low-degree test builds: FRI
    one per round's codeword (the initial domain, halved each round); STIR
    one per round's leaf stacks (a k-th of a domain that halves each
    round)."""
    from triton_vm_tpu_torch.ldt.stir import Stir

    log_l = ldt.initial_domain().length.bit_length() - 1
    if isinstance(ldt, Stir):
        log_k = ldt.folding_factor.bit_length() - 1
        return [log_l - log_k - r for r in range(len(ldt.round_queries) + 1)]
    return [log_l - r for r in range(ldt.num_rounds() + 1)]


def k1_batches_per_prove(log2_height):
    """log2 of the batch of every K1 launch in a prove at padded height
    2^log2_height, one per Merkle layer: the main, aux and quotient trees
    over the LDT domain and the low-degree test's own trees (spin_32768:
    3 trees of 2^18 leaves and FRI's of 2^18 down to 2^10; spin_65536: 3
    of 2^19 and STIR's of 2^17 down to 2^13)."""
    from triton_vm_tpu_torch import Stark

    ldt = Stark().ldt(1 << log2_height)
    log_l = ldt.initial_domain().length.bit_length() - 1
    trees = [log_l] * 3 + ldt_tree_leaves(ldt)
    return [k for m in trees for k in range(m)]


def k2_launches_per_prove(log2_height, jit):
    """(rows, width) of every K2 launch in a prove at padded height
    2^log2_height: the cached path hashes the main (379 words a row), aux
    (273) and quotient (15) tables over the LDT domain once each; the JIT
    path hashes the main and aux tables a coset at a time (L / n cosets
    hold LDT rows, n rows each); then each STIR tree's leaf rows of 12."""
    from triton_vm_tpu_torch import Stark
    from triton_vm_tpu_torch.ldt.stir import Stir

    ldt, _, _, rand_dom, _, ldt_dom = Stark().derive_domains(
        1 << log2_height)
    L, n = ldt_dom.length, rand_dom.length
    tables = ([(n, 379)] * (L // n) + [(n, 273)] * (L // n) if jit
              else [(L, 379), (L, 273)]) + [(L, 15)]
    leaves = ([(1 << k, 12) for k in ldt_tree_leaves(ldt)]
              if isinstance(ldt, Stir) else [])
    return tables + leaves


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
        return self.ops(bytes_moved,
                        permutations * INT32_OPS_PER_PERMUTATION)

    def ops(self, bytes_moved, int32_ops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = int32_ops / self.int_ops_per_s
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")


def phase_build():
    """Build every kernel (the three sources' nvcc runs started together);
    returns ptxas's report for each (registers, spills, stack and shared
    memory)."""
    import torch

    tip5_cuda, quotient_cuda, ntt_cuda, stdrng_cuda = kernel_modules()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        k3 = pool.submit(quotient_cuda.load)
        k4 = pool.submit(ntt_cuda.load)
        rng = pool.submit(stdrng_cuda.load)
        secs = tip5_cuda.load()
        k3_secs, k4_secs, rng_secs = k3.result(), k4.result(), rng.result()
    log(f"built Tip5 kernels from {SOURCE} in {secs:.1f} s, K3 from "
        f"{SOURCE_K3} in {k3_secs:.1f} s, K4 from {SOURCE_K4} in "
        f"{k4_secs:.1f} s, the randomizer kernel from {SOURCE_RNG} in "
        f"{rng_secs:.1f} s (the four builds started together)")
    report = {**tip5_cuda.ptxas_report(), **quotient_cuda.ptxas_report(),
              **ntt_cuda.ptxas_report(), **stdrng_cuda.ptxas_report()}
    for name, rec in report.items():
        log(f"ptxas {name}: {json.dumps(rec)}")
    return report


def phase_k1(rng, bound):
    import numpy as np

    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.ops import gf, tip5_cuda

    errs = []
    # the widest Merkle layers of a 2^21-leaf tree (recursive_verifier)
    # and of a 2^23-leaf tree (spin_1048576) too
    for b in (1 << 18, (1 << 18) + 3, 1 << 20, 1 << 22):
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
    # every Merkle layer's batch, 2^0 .. 2^22, for the per-prove totals
    by_batch = {}
    for k in range(23):
        layer = gf.from_u64(random_field(rng, (16, 1 << k)), "cuda")
        by_batch[k] = (time_ms(lambda: tip5_cuda.permutation(layer),
                               20 if k > 12 else 200),
                       bound(2 * 16 * 8 * (1 << k), 1 << k)[0])
    per_prove = {}
    for label, log2_height in PER_PROVE_HEIGHTS:
        batches = k1_batches_per_prove(log2_height)
        per_prove[label] = (sum(by_batch[k][0] for k in batches),
                            sum(by_batch[k][1] for k in batches))
        log(f"K1 per {label} prove ({len(batches)} launches, one per Merkle "
            f"layer): {per_prove[label][0]:.4f} ms, bound "
            f"{per_prove[label][1]:.4f} ms")
    return dict(name="tip5_permutation", route="cuda", source=SOURCE,
                replaces="triton_vm_tpu/ops/tip5_pallas.py:157",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                ms_by_width={f"2^{k}": t for k, (t, _) in by_batch.items()},
                per_prove_ms={k: t for k, (t, _) in per_prove.items()},
                per_prove_bound_ms={k: b for k, (_, b) in per_prove.items()})


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
    # the STIR leaf rows: 4 XFEs flattened, 12 words, row-major
    leaves = gf.from_u64(random_field(rng, (b // 2, 12)), "cuda")
    errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(leaves),
                            tip5_cuda.sponge_absorb_rows_plain(leaves)))
    for host in (gf.to_u64(leaves[:4]), random_field(rng, (6, 379))):
        got = gf.to_u64(tip5_cuda.sponge_absorb_rows(
            gf.from_u64(host, "cuda")))
        for j, row in enumerate(host):
            if [int(x) for x in got[:, j]] != \
                    tip5.hash_varlen([int(x) for x in row]):
                raise AssertionError(f"K2 disagrees with hash_varlen on a "
                                     f"row of {len(row)}, row {j}")
    err = max(errs)
    if err:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")

    def timed_bound(rows, reps):
        # ceil((n + 1) / RATE) permutations a row, as the kernel runs
        rb, n = rows.shape
        return (time_ms(lambda: tip5_cuda.sponge_absorb_rows(rows), reps),
                *bound(8 * rb * (n + 5), rb * ((n + tip5.RATE) // tip5.RATE)))

    # the three committed tables of a spin_32768 prove: main, aux, quotient
    by_width = {}
    for n, rows in col_major.items():
        by_width[str(n)] = timed_bound(rows, 5 if n > 100 else 40)
    by_width["12"] = timed_bound(leaves, 40)
    for n, (t, bms, by) in by_width.items():
        log(f"K2 2^{(b if n != '12' else b // 2).bit_length() - 1} x {n}: "
            f"kernel {t:.4f} ms, bound {bms:.4f} ms ({by})")
    ms, bound_ms, bound_by = by_width["379"]
    plain_ms = time_ms(lambda: tip5_cuda.sponge_absorb_rows_plain(timed), 1)
    plain12_ms = time_ms(
        lambda: tip5_cuda.sponge_absorb_rows_plain(leaves), 1)
    per_prove = {"spin_32768": [by_width[str(n)] for n in col_major]}
    # spin_65536: the three tables at 2^19 rows, each held against the
    # plain version, then the leaf rows of each STIR tree (2^17 down to
    # 2^13), every launch's own shape
    del col_major, timed
    per_prove["spin_65536"] = []
    by_shape = {}
    for n in (379, 273, 15):
        rows = gf.from_u64(random_field(rng, (n, 2 * b)), "cuda").T
        errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(rows),
                                tip5_cuda.sponge_absorb_rows_plain(rows)))
        if errs[-1]:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"2^19 x {n}: {errs[-1]}")
        by_shape[2 * b, n] = timed_bound(rows, 3 if n > 100 else 20)
        per_prove["spin_65536"].append(by_shape[2 * b, n])
        del rows
    from triton_vm_tpu_torch import Stark

    for k in ldt_tree_leaves(Stark().ldt(1 << 16)):
        per_prove["spin_65536"].append(timed_bound(leaves[:1 << k], 40))
    # recursive_verifier (cached, padded height 2^17): the three tables at
    # 2^20 rows, column-major; spin_1048576 (JIT): a coset of the main and
    # aux tables, 2^21 rows of 379 and 273 read column-major in place, and
    # the quotient table's 2^23 rows of 15; each held against the plain
    # version; then the leaf rows of each STIR tree (2^21 down to 2^15)
    for rb, n in ((1 << 20, 379), (1 << 20, 273), (1 << 20, 15),
                  (1 << 21, 379), (1 << 21, 273), (1 << 23, 15)):
        rows = gf.from_u64(random_field(rng, (n, rb)), "cuda").T
        t0 = time.perf_counter()
        errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(rows),
                                tip5_cuda.sponge_absorb_rows_plain(rows)))
        if errs[-1]:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"2^{rb.bit_length() - 1} x {n}: {errs[-1]}")
        log(f"K2 2^{rb.bit_length() - 1} x {n} column-major equals its "
            f"plain version ({time.perf_counter() - t0:.1f} s with it)")
        by_shape[rb, n] = timed_bound(rows, 3 if n > 100 else 10)
        del rows
    del leaves
    # the widest STIR tree's leaf rows at 2^20, row-major, held against the
    # plain version; the narrower trees' launches read a prefix of it
    leaves = gf.from_u64(random_field(rng, (1 << 21, 12)), "cuda")
    errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(leaves),
                            tip5_cuda.sponge_absorb_rows_plain(leaves)))
    if errs[-1]:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"2^21 x 12: {errs[-1]}")
    # bench.py's configs on FRI: the three tables of merkle_auth (2^13 LDT
    # rows), factorial_4096 (2^16) and hash_chain (2^17), column-major, each
    # held against the plain version
    for rb in (1 << 13, 1 << 16, 1 << 17):
        for n in (379, 273, 15):
            rows = gf.from_u64(random_field(rng, (n, rb)), "cuda").T
            errs.append(max_abs_err(tip5_cuda.sponge_absorb_rows(rows),
                                    tip5_cuda.sponge_absorb_rows_plain(rows)))
            if errs[-1]:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"at 2^{rb.bit_length() - 1} x {n}: "
                                     f"{errs[-1]}")
            by_shape[rb, n] = timed_bound(rows, 5 if n > 100 else 40)
            del rows
    for label, log2_height in PER_PROVE_HEIGHTS:
        if label in per_prove:
            continue
        launches = k2_launches_per_prove(log2_height, log2_height >= 20)
        for rb, n in launches:
            if (rb, n) not in by_shape:
                assert n == 12
                by_shape[rb, n] = timed_bound(leaves[:rb], 20)
        per_prove[label] = [by_shape[key] for key in launches]
    for (rb, n), (t, bms, by) in by_shape.items():
        if n != 12:
            log(f"K2 2^{rb.bit_length() - 1} x {n}: kernel {t:.4f} ms, "
                f"bound {bms:.4f} ms ({by})")
    totals = {label: (sum(t for t, _, _ in v), sum(bms for _, bms, _ in v))
              for label, v in per_prove.items()}
    err = max(errs)
    log(f"K2 ok (max_abs_err 0, also at 2^13, 2^16, 2^17, 2^19 and 2^20 x "
        f"379, 273 and 15, 2^21 x 379, 273 and 12, 2^23 x 15); 2^18 x "
        f"379: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}); 2^17 x 12: kernel "
        f"{by_width['12'][0]:.4f} ms, plain {plain12_ms:.2f} ms, bound "
        f"{by_width['12'][1]:.4f} ms ({by_width['12'][2]})")
    for label, (t, bms) in totals.items():
        log(f"K2 per {label} prove ({len(per_prove[label])} launches): "
            f"{t:.3f} ms, bound {bms:.3f} ms")
    return dict(name="tip5_sponge_rows", route="cuda", source=SOURCE,
                replaces="triton_vm_tpu/ops/tip5_pallas.py:233",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                ms_by_width={n: t for n, (t, _, _) in by_width.items()},
                bound_ms_by_width={n: bms for n, (_, bms, _)
                                   in by_width.items()},
                plain_ms_12=plain12_ms,
                ms_by_shape={f"2^{rb.bit_length() - 1}x{n}": t
                             for (rb, n), (t, _, _) in by_shape.items()},
                bound_ms_by_shape={f"2^{rb.bit_length() - 1}x{n}": bms
                                   for (rb, n), (_, bms, _)
                                   in by_shape.items()},
                per_prove_ms={k: t for k, (t, _) in totals.items()},
                per_prove_bound_ms={k: bms for k, (_, bms) in totals.items()})


def k3_launches_per_prove(log2_height, jit=None):
    """(rows, count) of K3's calls in a prove at padded height
    2^log2_height: one over the quotient domain on the cached path, one
    per coset of the randomized trace's length on the JIT path (from 2^20
    unless `jit` says otherwise). A call launches
    `quotient_cuda.launches_per_call(rows)` kernels (a first and a last
    one and one a segment, per chunk of rows)."""
    from triton_vm_tpu_torch import Stark

    _, _, _, rand_dom, quot_dom, _ = Stark().derive_domains(
        1 << log2_height)
    if log2_height >= 20 if jit is None else jit:
        return rand_dom.length, quot_dom.length // rand_dom.length
    return quot_dom.length, 1


def jit_coset_shift(log2_height):
    """The next-row shift within a JIT coset at padded height
    2^log2_height (stark/jit_lde.py: unit // m)."""
    from triton_vm_tpu_torch import Stark

    _, _, trace_dom, rand_dom, quot_dom, _ = Stark().derive_domains(
        1 << log2_height)
    m = quot_dom.length // rand_dom.length
    return quot_dom.length // trace_dom.length // m


def phase_k3(rng, bound):
    """K3 (csrc/quotient.cu) on the card at the full widths (379 main, 91
    aux columns): held word for word against its plain version on 2^16
    random rows, a ragged 2^16 + 3, edge values (every column cycling
    through 0, 1, p - 1, 2^32), aux as a permuted view and a mesh shard's
    block with its halo (M = N + 8), both timed at 2^16; K3 timed with
    CUDA events at every prove's launch shape and summed per prove, and
    at the 2^21-row JIT coset of a 2^20 prove (its shift, aux permuted)
    held against its plain version over all its rows in one chunk (K3
    runs them in its chunks of CHUNK_ROWS)."""
    import torch

    from triton_vm_tpu_torch.air import compile as aircomp
    from triton_vm_tpu_torch.ops import quotient_cuda
    from triton_vm_tpu_torch.tools import quotient_inputs as qi

    tape = aircomp.quotient_row_tape()
    n = 1 << 16
    checks = {"2^16": dict(), "2^16+3": dict(n=n + 3),
              "edge values": dict(edge=True),
              "permuted aux": dict(permuted_aux=True),
              "halo 8": dict(halo=8)}
    timed = None
    for label, kw in checks.items():
        inp = qi.make_inputs(rng, kw.pop("n", n), "cuda", **kw)
        err = max_abs_err(qi.k3(inp), qi.plain(inp))
        if err:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{label}: {err}")
        if label == "2^16":
            timed = inp
        del inp
    log("K3 equals its plain version word for word: " + ", ".join(checks))
    plain_ms = time_ms(lambda: qi.plain(timed), 1)
    del timed
    # every prove's launch shapes (recursive_verifier_full's coset of 2^22
    # rows too), aux a permuted view as the provers pass it, each with its
    # bound; the JIT coset of a 2^20 prove with its own shift
    jit_rows, _ = k3_launches_per_prove(20)
    shapes = sorted({k3_launches_per_prove(h)[0] for _, h in
                     PER_PROVE_HEIGHTS + (("recursive_verifier_full", 21),)}
                    | {n})
    by_rows = {}
    for rows in shapes:
        shift = jit_coset_shift(20) if rows == jit_rows else 4
        inp = qi.make_inputs(rng, rows, "cuda", permuted_aux=True,
                             shift=shift, device_draw=True)
        reps = 2 if rows >= 1 << 20 else 10
        ms = time_ms(lambda: qi.k3(inp), reps)
        b = bound.ops(*quotient_cuda.work(tape, rows, inp["trace_len"]))
        by_rows[rows] = (ms, *b)
        log(f"K3 2^{rows.bit_length() - 1} rows: {ms:.3f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]})")
        if rows == jit_rows:
            err = max_abs_err(qi.k3(inp), qi.plain(inp, chunk=rows))
            if err:
                raise AssertionError(
                    f"K3 disagrees with its plain version at the 2^21 JIT "
                    f"coset: {err}")
            log(f"K3 equals its plain version word for word at the 2^21 "
                f"JIT coset (shift {shift}, aux permuted), all rows")
        del inp
        torch.cuda.empty_cache()
    per_prove = {}
    for label, h in PER_PROVE_HEIGHTS + (("recursive_verifier_full", 21),):
        rows, count = k3_launches_per_prove(h)
        per_prove[label] = (count * by_rows[rows][0],
                            count * by_rows[rows][1])
    log("K3 per prove (ms, bound ms): " + json.dumps(per_prove))
    ms, bound_ms, bound_by = by_rows[n]
    log(f"K3 ok (max_abs_err 0); 2^16 rows: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="quotient_rows", route="cuda", source=SOURCE_K3,
                generator=GENERATOR_K3,
                replaces=K3_REPLACES, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None,
                ms_by_rows={f"2^{r.bit_length() - 1}": v[0]
                            for r, v in by_rows.items()},
                bound_ms_by_rows={f"2^{r.bit_length() - 1}": v[1]
                                  for r, v in by_rows.items()},
                per_prove_ms={k: t for k, (t, _) in per_prove.items()},
                per_prove_bound_ms={k: b for k, (_, b) in per_prove.items()})


K4_HEADLINE = (379, 1 << 21, 1 << 21, True, False)


def k4_inputs(rows, n_in, length, scaled_in, scaled_out, device_draw=False,
              rng=None):
    """Inputs of one K4 call of shape (rows, n_in) -> (rows, length): the
    words (numpy-drawn over all of [0, p), or drawn on the card below
    2^62 for the large shapes) and the root, input scale and output scale
    that ops/ntt.py passes for a coset NTT (offset 7) or an iNTT (offset
    7, root inverted)."""
    import torch

    from triton_vm_tpu_torch.fields import bfe
    from triton_vm_tpu_torch.ops import gf, ntt

    if device_draw:
        g = torch.Generator("cuda").manual_seed(rows * 131 + length)
        x = torch.randint(0, 1 << 62, (rows, n_in), dtype=torch.int64,
                          device="cuda", generator=g)
    else:
        x = gf.from_u64(random_field(rng, (rows, n_in)), "cuda")
    root = bfe.primitive_root_of_unity(length)
    if scaled_out:
        root = bfe.inv(root)
    pre = ntt._coset_scale(7) if scaled_in else None
    post = ntt._unscale(length, 7) if scaled_out else None
    return x, root, length, pre, post


def k4_shape_label(rows, n_in, length, scaled_in, scaled_out):
    pad = "" if n_in == length else f" from 2^{n_in.bit_length() - 1}"
    kind = "intt" if scaled_out else ("coset" if scaled_in else "ntt")
    return f"{rows}x2^{length.bit_length() - 1}{pad} {kind}"


def k4_time(shape, bound, reps=None):
    """K4's milliseconds (CUDA events) and bound at one call shape."""
    from triton_vm_tpu_torch.ops import ntt_cuda

    rows, n_in, length, scaled_in, scaled_out = shape
    x, root, length, pre, post = k4_inputs(*shape, device_draw=True)
    out = ntt_cuda.ntt_rows(x, root, length, pre, post)
    words = rows * length
    reps = reps or (3 if words >= 1 << 26 else 10 if words >= 1 << 20
                    else 50)
    ms = time_ms(lambda: ntt_cuda.ntt_rows(x, root, length, pre, post,
                                           out=out), reps)
    scaled = (n_in if scaled_in else 0) + (length if scaled_out else 0)
    return (ms, *bound.ops(*ntt_cuda.work(rows, n_in, length, scaled)))


def phase_k4(rng, bound):
    """K4 (csrc/ntt.cu) on the card, word for word against its plain
    version (`ntt._rows_plain`: the scales as gf.mul, then
    `_transform_plain`) at every launch class the provers make: Bezout
    products' short batches (many rows, lengths 2 to 2^12, zero-padded
    from half), the commit and JIT cosets (2^13 to 2^21 words of 379 and
    273 rows with a coset offset), the tall columns of segmentify and
    STIR (2^22 to 2^24 words, 3 and 15 rows), an iNTT with its offset^-i /
    n scale, `lde` with padding, and a ragged row count; each input drawn
    over all of [0, p) with numpy (below 2^62 on the card from 2^26
    words), its first words edge values. The plain version is timed at
    the JIT coset of a 2^20 prove (379 x 2^21, offset), K4 at every shape
    it was held at."""
    import torch

    from triton_vm_tpu_torch.fields import bfe
    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.ops import gf, ntt, ntt_cuda

    edge = [0, 1, 2**32 - 1, 2**32, 2**63, P - 2**32, P - 2, P - 1]
    classes = [(8192, 1, 2, False, False), (4096, 16, 32, False, False),
               (1024, 128, 256, False, False), (64, 2048, 4096, False, False),
               (1, 1 << 15, 1 << 16, False, False),
               (379, 1 << 13, 1 << 13, True, False),
               (1001, 1 << 13, 1 << 13, True, False),
               (273, 1 << 16, 1 << 17, True, False),
               (379, 1 << 19, 1 << 19, True, False),
               (273, 1 << 21, 1 << 21, True, False), K4_HEADLINE,
               (379, 1 << 20, 1 << 20, False, True),
               (3, 1 << 22, 1 << 22, False, True),
               (15, 1 << 23, 1 << 23, True, False),
               (3, 1 << 24, 1 << 24, False, True),
               (15, 1 << 24, 1 << 24, True, False)]
    by_shape, plain_ms = {}, None
    for shape in classes:
        x, root, length, pre, post = k4_inputs(
            *shape, device_draw=shape[0] * shape[1] >= 1 << 26, rng=rng)
        x.view(-1)[:len(edge)] = torch.as_tensor(
            [e - (1 << 64) if e >= 1 << 63 else e for e in edge][:x.numel()],
            device="cuda")
        got = ntt._rows(x, root, length, pre, post)
        if shape == K4_HEADLINE:
            t0 = time.perf_counter()
        want = ntt._blockwise(
            lambda b, o: o.copy_(ntt._rows_plain(b, root, length, pre, post)),
            x, length, gf.block_rows(length))
        if shape == K4_HEADLINE:
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{k4_shape_label(*shape)}: {err}")
        del x, got, want, pre, post
        by_shape[shape] = k4_time(shape, bound)
        torch.cuda.empty_cache()
    # lde with padding: the bench's SOL shape, K4 twice (iNTT, coset NTT)
    x = gf.from_u64(random_field(rng, (379, 4096)), "cuda")
    got = ntt.lde(x, 4, 1, 7)
    want = ntt._rows_plain(
        ntt._rows_plain(x, bfe.inv(bfe.primitive_root_of_unity(4096)),
                        4096, None, ntt._unscale(4096, 1)),
        bfe.primitive_root_of_unity(1 << 14), 1 << 14,
        ntt._coset_scale(7))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K4's lde disagrees with its plain version: "
                             f"{err}")
    lde_ms = time_ms(lambda: ntt.lde(x, 4, 1, 7), 20)
    del x, got, want
    # the scale, twiddle and bit-reversal tables built here for shapes a
    # prove may never use (2^24 words, the plain network's) would stay
    # allocated and count in the proves' peak device memory
    ntt._DEVICE_CACHE.clear()
    ntt_cuda._TABLES.clear()
    gf._POWER_TABLES.clear()
    torch.cuda.empty_cache()
    for shape, (ms, bms, by) in by_shape.items():
        log(f"K4 {k4_shape_label(*shape)}: {ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {100 * bms / ms:.1f}% of it")
    ms, bound_ms, bound_by = by_shape[K4_HEADLINE]
    log(f"K4 ok (max_abs_err 0 at {len(classes)} classes and lde 379 x 2^12 "
        f"by 4, {lde_ms:.4f} ms); 379 x 2^21 coset: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="ntt_pass", route="cuda", source=SOURCE_K4,
                replaces=K4_REPLACES, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, lde_ms=lde_ms,
                ms_by_shape={k4_shape_label(*s): v[0]
                             for s, v in by_shape.items()},
                bound_ms_by_shape={k4_shape_label(*s): v[1]
                                   for s, v in by_shape.items()})


def k4_per_prove(calls, bound, k4):
    """K4 timed at every call shape the proving paths made (`calls`: path
    -> Counter of shapes) and summed per prove: each path's milliseconds
    and bound, written into the kernels line's K4 record `k4` (when the
    kernels phase ran)."""
    import torch

    timed = {}
    per_prove = {}
    for path, shapes in calls.items():
        ms = bms = 0.0
        for shape, count in shapes.items():
            if shape not in timed:
                timed[shape] = k4_time(shape, bound)
                torch.cuda.empty_cache()
            ms += count * timed[shape][0]
            bms += count * timed[shape][1]
        per_prove[path] = (ms, bms, sum(shapes.values()))
        log(f"K4 per {path} path ({sum(shapes.values())} calls, "
            f"{len(shapes)} shapes): {ms:.3f} ms, bound {bms:.3f} ms")
    top = sorted(timed.items(), key=lambda kv: -kv[1][0])[:12]
    log("K4 at the provers' widest shapes (ms, bound ms): " + json.dumps(
        {k4_shape_label(*s): [round(v[0], 4), round(v[1], 4)]
         for s, v in top}))
    if k4 is not None:
        k4["per_prove_ms"] = {p: v[0] for p, v in per_prove.items()}
        k4["per_prove_bound_ms"] = {p: v[1] for p, v in per_prove.items()}
        k4["per_prove_calls"] = {p: v[2] for p, v in per_prove.items()}


def randomizer_calls(log2_height, stark=None):
    """(seed offsets, n, xfe) of the prover's four randomizer draws at
    padded height 2^log2_height with `stark` (the default Stark if None;
    its low-degree test sets ntr) (stark/prover.py): the main table's
    trace randomizers (379 rows of ntr BFEs), the aux table's (91 rows of
    ntr XFEs), the batch randomizer (one row of h XFEs) and the quotient
    randomizer (one row of n_qr XFEs)."""
    from triton_vm_tpu_torch import Stark
    from triton_vm_tpu_torch.stark.prover import NUM_AUX, NUM_MAIN

    stark = stark or Stark(device="cpu")
    _, ntr, *_ = stark.derive_domains(1 << log2_height)
    n_qr = Stark.num_quotient_table_randomizers(ntr)
    end = NUM_MAIN + NUM_AUX
    return [(range(NUM_MAIN), ntr, False), (range(NUM_MAIN, end), ntr, True),
            ([end], 1 << log2_height, True), ([end + 1], n_qr, True)]


def randomizer_draws(calls):
    """BFEs drawn by `calls` (as randomizer_calls gives them)."""
    return sum(len(o) * n * (3 if x else 1) for o, n, x in calls)


def rng_label(offsets, n, xfe):
    return f"{len(offsets)} x {3 * n if xfe else n}" + (" xfe" if xfe else "")


def rng_time(offsets, n, xfe, bound):
    """The randomizer kernel's time at one call shape (ms, CUDA events,
    its launches alone over buffers made once), its bound (ms, what bounds
    it), and the whole `draw` (ms: the buffers, the keys' upload, the
    launch and the flag read)."""
    import torch

    from triton_vm_tpu_torch.ops import stdrng_cuda
    from triton_vm_tpu_torch.utils import stdrng

    dev = torch.device("cuda")
    out, flags = stdrng_cuda.launch(stdrng.offset_seeds(SEED, offsets), n,
                                    xfe, dev)
    keys = torch.zeros((len(offsets), 8), dtype=torch.int32, device=dev)
    rows, per_row = len(offsets), 3 * n if xfe else n
    ms = time_ms(lambda: stdrng_cuda.enqueue(keys, per_row, 3 if xfe else 1,
                                             out, flags), 50)
    call_ms = time_ms(lambda: stdrng_cuda.draw(SEED, offsets, n, xfe=xfe,
                                               device=dev), 20)
    # each draw written once (8 bytes), each row's key read and flag
    # written once (32 + 8 bytes); one ChaCha12 block a 4 draws
    bound_ms, bound_by = bound.ops(
        8 * rows * per_row + 40 * rows,
        rows * -(-per_row // 4) * INT32_OPS_PER_CHACHA12_BLOCK)
    return ms, bound_ms, bound_by, call_ms


def phase_rng(rng, bound):
    """The randomizer kernel (csrc/chacha12.cu) on the card, word for word
    against its plain version (`stdrng_cuda.draw_plain`: the host's numpy
    keystream in the same layout, uploaded) at the main path's call shapes
    of a 2^20 prove (379 x 228 BFEs; 91 rows of 3 x 228 XFE-major; one row
    of 3 x 2^20 and one of 3 x 1145) and of a 2^16 one, each with the
    prover's seed and a random one; the plain version timed at each of
    them, the kernel at every call shape of a 2^15, 2^16, 2^17 and 2^20
    prove beside its bound, and summed per prove."""
    import torch

    from triton_vm_tpu_torch.ops import stdrng_cuda
    from triton_vm_tpu_torch.utils import stdrng

    dev = torch.device("cuda")
    per_height = {k: randomizer_calls(k) for k in (15, 16, 17, 20)}
    shapes = {rng_label(*c): c for calls in per_height.values()
              for c in calls}
    checked = [rng_label(*c) for k in (20, 16) for c in per_height[k]]
    seeds = [SEED, bytes(rng.integers(0, 256, 32, dtype="uint8"))]
    plain_ms, by_shape = {}, {}
    for label in checked:
        offsets, n, xfe = shapes[label]
        for seed in seeds:
            got = stdrng_cuda.draw(seed, offsets, n, xfe=xfe, device=dev)
            t0 = time.perf_counter()
            want = stdrng_cuda.draw_plain(seed, offsets, n, xfe, dev)
            torch.cuda.synchronize()
            plain_ms.setdefault(label, (time.perf_counter() - t0) * 1e3)
            if not torch.equal(got, want):
                raise AssertionError(f"the randomizer kernel disagrees with "
                                     f"its plain version at {label}: "
                                     f"{max_abs_err(got, want)}")
    for label, (offsets, n, xfe) in shapes.items():
        by_shape[label] = rng_time(offsets, n, xfe, bound)
        ms, bms, by, call_ms = by_shape[label]
        plain = (f"; plain {plain_ms[label]:.1f} ms" if label in plain_ms
                 else "")
        log(f"randomizer kernel {label}: {ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {100 * bms / ms:.1f}% of it; with the flag read "
            f"{call_ms:.4f} ms{plain}")
    per_prove, per_prove_bound, per_prove_call = {}, {}, {}
    for k, calls in per_height.items():
        labels = [rng_label(*c) for c in calls]
        key = f"2^{k}"
        per_prove[key] = sum(by_shape[lb][0] for lb in labels)
        per_prove_bound[key] = sum(by_shape[lb][1] for lb in labels)
        per_prove_call[key] = sum(by_shape[lb][3] for lb in labels)
        log(f"randomizer kernel per {key} prove (4 launches, "
            f"{randomizer_draws(calls)} draws): {per_prove[key]:.4f} ms, "
            f"bound {per_prove_bound[key]:.4f} ms, with the flag reads "
            f"{per_prove_call[key]:.4f} ms")
    head = rng_label(*per_height[20][2])
    ms, bound_ms, bound_by, _ = by_shape[head]
    plain_20 = sum(plain_ms[rng_label(*c)] for c in per_height[20])
    log(f"randomizer kernel ok (max_abs_err 0 at {len(checked)} shapes, "
        f"two seeds each); {head}: kernel {ms:.4f} ms, plain "
        f"{plain_ms[head]:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}); a "
        f"2^20 prove's four calls: kernel {per_prove['2^20']:.4f} ms, plain "
        f"{plain_20:.1f} ms")
    return dict(name="chacha12_bfe", route="cuda", source=SOURCE_RNG,
                replaces=None, max_abs_err=0, ms=ms,
                plain_ms=plain_ms[head], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                ms_by_shape={k: v[0] for k, v in by_shape.items()},
                bound_ms_by_shape={k: v[1] for k, v in by_shape.items()},
                call_ms_by_shape={k: v[3] for k, v in by_shape.items()},
                plain_ms_by_shape=plain_ms, per_prove_ms=per_prove,
                per_prove_bound_ms=per_prove_bound,
                per_prove_call_ms=per_prove_call)


def kernel_modules():
    """The wrappers of K1 and K2, K3, K4 and the randomizer kernel."""
    from triton_vm_tpu_torch.ops import (ntt_cuda, quotient_cuda, stdrng_cuda,
                                         tip5_cuda)

    return tip5_cuda, quotient_cuda, ntt_cuda, stdrng_cuda


def all_launches():
    """Every kernel's launches so far: K1, K2, K3, K4 (one a pass) and the
    randomizer kernel (one a draw call)."""
    return {k: n for m in kernel_modules() for k, n in m.launches.items()}


def launches_by_device():
    """Every kernel's launches so far by the card it launched on."""
    out = {}
    for m in kernel_modules():
        for d, c in m.launches_by_device.items():
            out.setdefault(d, dict.fromkeys(all_launches(), 0)).update(c)
    return out


def reset_launch_counts():
    for m in kernel_modules():
        m.reset_launch_counts()


@contextlib.contextmanager
def through_kernels():
    """While a path proves: K3's plain versions and the NTT's plain
    network (`ntt._transform_plain`) raise if they are handed a tensor on
    the card, so every prove's quotient stage must go through K3 and every
    transform through K4; K4's calls are recorded by shape (yielded, a
    Counter); the host's numpy keystream (`stdrng.drbg_bfes_batch`) raises
    whatever it is handed, so every randomizer is drawn by the kernel.
    `run_tape_scan` is not guarded: the derived columns' fill
    (tables/extend_device.py) runs it on the card."""
    from triton_vm_tpu_torch.ops import ntt, ntt_cuda, quotient_cuda
    from triton_vm_tpu_torch.utils import stdrng

    saved = {(stdrng, "drbg_bfes_batch"): stdrng.drbg_bfes_batch,
             (quotient_cuda, "quotients_on_rows_plain"):
                 quotient_cuda.quotients_on_rows_plain,
             (quotient_cuda, "run_row_tape_plain"):
                 quotient_cuda.run_row_tape_plain,
             (ntt, "_transform_plain"): ntt._transform_plain,
             (ntt_cuda, "ntt_rows"): ntt_cuda.ntt_rows}
    calls = collections.Counter()

    def guard(name, fn):
        def guarded(*args, **kwargs):
            if any(getattr(a, "is_cuda", False) for a in args):
                raise AssertionError(f"{name} ran on the card in a prove")
            return fn(*args, **kwargs)
        return guarded

    def host_keystream(*args, **kwargs):
        raise AssertionError("a prove on the card drew its randomizers "
                             "with the host's keystream "
                             "(stdrng.drbg_bfes_batch)")

    def recorded(x, root, length, pre=None, post=None, out=None):
        calls[(*x.shape, length, pre is not None, post is not None)] += 1
        return saved[ntt_cuda, "ntt_rows"](x, root, length, pre, post, out)

    for (mod, name), fn in saved.items():
        setattr(mod, name, recorded if mod is ntt_cuda else
                host_keystream if mod is stdrng else guard(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _launches_since(before):
    return {k: v - before[k] for k, v in all_launches().items()}


def prove_and_verify(label, program, public_input, ldt_choice=None,
                     non_determinism=None):
    """The main path on the card: prove_program (or, for an LDT chosen by
    the caller, `prove` with that Stark), then verify, then a tampered
    proof word must be rejected with a verification error (any other
    exception, such as a failed kernel launch, fails the run). Returns the
    Stark, the proof, the kernel launches of the prove and of the
    (accepting) verify, and the prove's spans within stages."""
    import torch

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.ldt.fri import LdtError
    from triton_vm_tpu_torch.ops import npfield, stdrng_cuda
    from triton_vm_tpu_torch.stark.codec import DecodeError
    from triton_vm_tpu_torch.utils import profiler

    torch.cuda.empty_cache()
    tables_before = npfield.long_tables["powers_u64"]
    cards = range(torch.cuda.device_count())
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    before = all_launches()
    before_dev = launches_by_device()
    profiler.start(label)
    t0 = time.perf_counter()
    if ldt_choice is None:
        stark, claim, proof = tvm.prove_program(
            program, public_input, non_determinism, seed=SEED,
            device="cuda")
    else:
        stark = tvm.Stark(ldt_choice=ldt_choice, device="cuda")
        _, output = tvm.VM.trace_execution(
            program, tvm.PublicInput(public_input), non_determinism)
        claim = (tvm.Claim.about_program(program).with_input(public_input)
                 .with_output(output))
        proof = tvm.prove(stark, claim, program, non_determinism, seed=SEED)
    prove_s = time.perf_counter() - t0
    profile = profiler.finish()
    stages = profile.spans()
    # the randomizers were drawn on the card, every one of them, and only
    # rows the kernel flagged were redrawn on the host
    counted = [profile.counts] + [t.counts for t in profile.tasks]
    draws, exact = (sum(c.get(name, 0) for c in counted)
                    for name in (stdrng_cuda.DRAWS, stdrng_cuda.EXACT_ROWS))
    want = randomizer_draws(randomizer_calls(
        proof.padded_height().bit_length() - 1, stark))
    if draws != want:
        raise AssertionError(f"{label}: {draws} randomizer draws on the "
                             f"card, not the prover's {want}")
    log(f"{label}: {draws} randomizer draws on the card, {exact} rows "
        "redrawn on the host")
    # spans opened inside a stage, as "stage/span"
    nested = {f"{profile.tasks[t.parent].name}/{t.name}":
              round(t.total_duration, 4)
              for t in profile.tasks if t.parent is not None}
    launches = {"prove": _launches_since(before), "prove_by_device": {
        d: {k: n - before_dev.get(d, {}).get(k, 0) for k, n in c.items()}
        for d, c in launches_by_device().items()}}
    # power tables of more than 2^12 words the prove built on the host
    # (npfield.powers_u64): none on one device, where K3, K4 and
    # gf.powers form every power from two 2^12-word tables on the card;
    # the mesh's six-step transform keeps its host tables
    launches["host_power_tables"] = (npfield.long_tables["powers_u64"]
                                     - tables_before)
    if launches["host_power_tables"] and not os.environ.get("TVM_MESH"):
        raise AssertionError(
            f"{label}: the prove built {launches['host_power_tables']} "
            f"power tables of more than {npfield.LONG_TABLE_WORDS} words "
            "on the host")
    before = all_launches()
    profiler.start(f"{label} verify")
    t0 = time.perf_counter()
    accepted = stark.verify(claim, proof)
    verify_s = time.perf_counter() - t0
    verify_profile = profiler.finish()
    if not accepted:
        raise AssertionError(f"{label}: verify rejected the proof")
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
    WALL[label] = (prove_s, verify_s)
    log(f"{label}: padded height {proof.padded_height()}, "
        f"{len(proof.words)} words, prove {prove_s:.3f} s, "
        f"verify {verify_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(cards) > 1:
        log(f"{label}: peak device memory by card (GiB): " + json.dumps({
            f"cuda:{card}": round(torch.cuda.max_memory_allocated(card)
                                  / 2**30, 2) for card in cards}))
    log(f"{label} stages (s): " + json.dumps(
        {name: round(sec, 4) for name, sec, _ in stages}))
    log(f"{label}: quotients span "
        f"{sum(sec for name, sec, _ in stages if name == 'quotients'):.4f}"
        f" s, K3 launches {launches['prove']['quotient_rows']} in the "
        f"prove, {launches['verify']['quotient_rows']} in the verify")
    if nested:
        log(f"{label} spans within stages (s): " + json.dumps(nested))
    # the verify's profile: its span and the sub-spans of its parts
    verify_spans = {}
    for iv in verify_profile.intervals():
        path = "/".join(iv.path)
        verify_spans[path] = (verify_spans.get(path, 0.0)
                              + (iv.end_ns - iv.start_ns) / 1e9)
    log(f"{label} verify spans (s): " + json.dumps(
        {path: round(sec, 4) for path, sec in verify_spans.items()}))
    log(f"{label} kernel launches: " + json.dumps(launches))
    return stark, proof, launches, nested


def check_digest(label, proof, want, whose="the JAX package's"):
    from triton_vm_tpu_torch.crypto import tip5

    w = proof.words
    digest = tuple(tip5.hash_varlen([len(w) + 1, len(w)] + w))
    if digest != want:
        raise AssertionError(f"{label} proof digest {digest} != {whose} "
                             f"{want}")
    log(f"{label} proof digest equals {whose}")


def check_proof(label, log2_height, stark, proof, launches, jit):
    """A proof reached its padded height, with the LDT the default Stark
    chooses there, and launched K1 once per Merkle layer and K2 once per
    committed table (on the JIT path once per hashed coset of the main and
    aux tables) and STIR tree, as the per-prove totals assume."""
    from triton_vm_tpu_torch.ldt.stir import Stir

    if proof.padded_height() != 1 << log2_height:
        raise AssertionError(f"{label} did not reach padded height "
                             f"2^{log2_height}")
    ldt = stark.ldt(proof.padded_height())
    log(f"{label}: low-degree test {type(ldt).__name__}")
    if isinstance(ldt, Stir) != (log2_height >= 16):
        raise AssertionError(f"{label}: Stark chose {type(ldt).__name__}")
    k1 = launches["prove"]["tip5_permutation"]
    if k1 != len(k1_batches_per_prove(log2_height)):
        raise AssertionError(f"{label} launched K1 {k1} times, not once "
                             "per Merkle layer as the per-prove K1 total "
                             "assumes")
    k2 = launches["prove"]["tip5_sponge_rows"]
    want_k2 = len(k2_launches_per_prove(log2_height, jit))
    if k2 != want_k2:
        raise AssertionError(f"{label} launched K2 {k2} times, not "
                             f"{want_k2}")
    from triton_vm_tpu_torch.ops import quotient_cuda

    k3 = launches["prove"]["quotient_rows"]
    rows, calls = k3_launches_per_prove(log2_height, jit)
    want_k3 = calls * quotient_cuda.launches_per_call(rows)
    if k3 != want_k3:
        raise AssertionError(f"{label} launched K3's kernels {k3} times, "
                             f"not {want_k3} ({calls} calls of "
                             f"2^{rows.bit_length() - 1} rows)")


def mesh_launch_counts(log2_height, mesh):
    """K1 and K2 launches of a prove sharded over `mesh` (cached LDE), and
    K3's by card: the main and aux trees take one K2 launch a shard and
    one K1 launch per layer of each shard's subtree, then one per layer of
    the top log2(shards) layers on the lead device; the quotient tree and
    the low-degree test's trees stay on the lead device; K3 runs on every
    shard over its rows and halo (`quotient_cuda.launches_per_call` of a
    shard's rows, in its card's chunks, `mesh.quotient_chunk_rows`)."""
    from triton_vm_tpu_torch import Stark
    from triton_vm_tpu_torch.ldt.stir import Stir
    from triton_vm_tpu_torch.ops import quotient_cuda
    from triton_vm_tpu_torch.parallel import mesh as pmesh

    shards = mesh.size
    ldt = Stark().ldt(1 << log2_height)
    log_l = ldt.initial_domain().length.bit_length() - 1
    log_d = shards.bit_length() - 1
    leaves = ldt_tree_leaves(ldt)
    k1 = 2 * (shards * (log_l - log_d) + log_d) + log_l + sum(leaves)
    k2 = 2 * shards + 1 + (len(leaves) if isinstance(ldt, Stir) else 0)
    _, _, _, _, quot_dom, _ = Stark().derive_domains(1 << log2_height)
    k3 = collections.Counter()
    for d in mesh.devices:
        k3[str(d)] += quotient_cuda.launches_per_call(
            quot_dom.length // shards, pmesh.quotient_chunk_rows(mesh, d))
    return k1, k2, k3


def phase_mesh_kernels(rng, bound):
    """K2 at a shard's commit block of mesh_spin_65536 (2^19 LDT rows over
    MESH_SHARDS shards: 2^17 rows of 379 and of 273 words, the (n, 2^17)
    block the cols->rows exchange delivers, read column-major) and K1 at
    a shard subtree's widest layer (2^16 pairs), each against its plain
    version on the card (max_abs_err 0), then timed. Returns
    {kernel: (max_abs_err, {shape: (ms, bound_ms)})}."""
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.ops import gf, tip5_cuda

    rows = (1 << 19) // MESH_SHARDS
    k2 = {}
    for n in (379, 273):
        block = gf.from_u64(random_field(rng, (n, rows)), "cuda").T
        err = max_abs_err(tip5_cuda.sponge_absorb_rows(block),
                          tip5_cuda.sponge_absorb_rows_plain(block))
        if err:
            raise AssertionError(f"K2 disagrees with its plain version at a "
                                 f"shard's block 2^17 x {n}: {err}")
        k2[f"2^17x{n}"] = (
            time_ms(lambda: tip5_cuda.sponge_absorb_rows(block), 10),
            bound(8 * rows * (n + 5),
                  rows * ((n + tip5.RATE) // tip5.RATE))[0])
        del block
    layer = gf.from_u64(random_field(rng, (16, rows // 2)), "cuda")
    err = max_abs_err(tip5_cuda.permutation(layer),
                      tip5_cuda.permutation_plain(layer))
    if err:
        raise AssertionError(f"K1 disagrees with its plain version at a "
                             f"shard subtree's layer 2^16: {err}")
    k1 = {"2^16": (time_ms(lambda: tip5_cuda.permutation(layer), 20),
                   bound(2 * 16 * 8 * (rows // 2), rows // 2)[0])}
    log("mesh: K2 at a shard's commit block and K1 at a shard subtree's "
        "widest layer equal their plain versions (max_abs_err 0); kernel / "
        "bound ms: " + json.dumps({**k2, **k1}))
    return {"tip5_sponge_rows": (0, k2), "tip5_permutation": (0, k1)}


def drive_mesh(proofs):
    """The mesh phase: TVM_MESH=MESH_SHARDS (restored afterwards, also when
    the phase fails), then mesh_fib_1024 against the JAX package's digest
    and mesh_spin_65536 against spin_65536's proof of this run, each
    verified with a tampered word rejected; the six-step transform must
    run in STIR, K1 and K2 must launch on every shard's card and as often
    as `mesh_launch_counts` says."""
    import os

    import torch

    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.ops import ntt_sharded
    from triton_vm_tpu_torch.parallel import sharding

    saved = os.environ.get("TVM_MESH")
    os.environ["TVM_MESH"] = str(MESH_SHARDS)
    try:
        mesh = sharding.active_mesh("cuda")
        cards = sorted({str(d) for d in mesh.devices})
        log(f"mesh: TVM_MESH={MESH_SHARDS}, shards on "
            f"{[str(d) for d in mesh.devices]}, torch.cuda.device_count() "
            f"{torch.cuda.device_count()}")
        program, iterations = ex.spin(16)
        for label, prog, public_input, log2_height in (
                ("mesh_fib_1024", ex.fibonacci(), [85], 10),
                ("mesh_spin_65536", program, [iterations], 16)):
            ntt_sharded.reset_launch_counts()
            stark, proof, launches, _ = prove_and_verify(label, prog,
                                                         public_input)
            six_step = ntt_sharded.launches["ntt_sharded"]
            by_card = launches["prove_by_device"]
            missing = [c for c in cards
                       if not all(by_card.get(c, {}).values())]
            if missing:
                raise AssertionError(f"{label}: K1, K2 or K3 never launched "
                                     f"on {missing}: {by_card}")
            # K3 on every shard, on the shard's own card
            k3_cards = {c: n["quotient_rows"] for c, n in by_card.items()
                        if n["quotient_rows"]}
            k1, k2, shard_cards = mesh_launch_counts(log2_height, mesh)
            if k3_cards != shard_cards:
                raise AssertionError(f"{label}: K3 launched {k3_cards} by "
                                     f"card, the shards lie {shard_cards}")
            want = (k1, k2, sum(shard_cards.values()))
            got = (launches["prove"]["tip5_permutation"],
                   launches["prove"]["tip5_sponge_rows"],
                   launches["prove"]["quotient_rows"])
            if got != want:
                raise AssertionError(f"{label}: K1/K2/K3 launched {got} "
                                     f"times, not {want}")
            log(f"{label}: K1/K2/K3 launches {got} as a {MESH_SHARDS}-shard "
                f"prove makes them (K3 by card {k3_cards}); six-step "
                f"transforms {six_step}")
            if label == "mesh_fib_1024":
                check_digest(label, proof, JAX_FIB85_DIGEST)
                continue
            if not six_step:
                raise AssertionError(f"{label}: STIR's tall transforms did "
                                     "not go through ops/ntt_sharded.py")
            w, single = proof.words, proofs["spin_65536"].words
            if w != single:
                raise AssertionError(f"{label}: the mesh proof differs from "
                                     "spin_65536's")
            log(f"{label}: proof equals spin_65536's word for word; prove "
                f"{WALL[label][0]:.3f} s beside spin_65536's "
                f"{WALL['spin_65536'][0]:.3f} s in this run "
                f"({len(mesh.devices)} shards on {len(cards)} card(s))")
            proofs[label] = proof
    finally:
        if saved is None:
            os.environ.pop("TVM_MESH", None)
        else:
            os.environ["TVM_MESH"] = saved


def prove_at_height(name, program, public_input, log2_height,
                    non_determinism=None, forced_jit=False):
    """prove_and_verify, then the LDE path asserted (JIT where forced and
    from padded height 2^20, as the cache decision takes it on an 80 GB
    card; cached below) and `check_proof`. Returns the proof and the
    prove's spans within stages."""
    from triton_vm_tpu_torch import config

    if forced_jit:
        config.overwrite_lde_trace_caching_to(config.CacheDecision.JIT)
    try:
        stark, proof, launches, nested = prove_and_verify(
            name, program, public_input, non_determinism=non_determinism)
    finally:
        config.overwrite_lde_trace_caching_to(None)
    # the JIT path opens its coset spans within the prover's stages
    jit = any(span.endswith("/JIT coset NTT") for span in nested)
    log(f"{name}: cache decision {'JIT' if jit else 'CACHE'}")
    if jit != (forced_jit or log2_height >= 20):
        raise AssertionError(f"{name}: the prover took the "
                             f"{'JIT' if jit else 'cached'} path")
    check_proof(name, log2_height, stark, proof, launches, jit)
    return proof, nested


def drive_path(name, proofs):
    """One proving path of the main path, with every launch count set to
    0 just before it and read just after; every kernel must have been
    launched. `proofs` holds the proofs of this run by path name
    (a JIT_TWINS path is held against its twin's) and config 5's built
    verifier core (the witness phase reuses it). Every prove's quotient
    stage must run K3 and every transform K4 (`through_kernels`); K4's
    call shapes go to K4_CALLS[name]. Returns the counts."""
    reset_launch_counts()
    t0 = time.perf_counter()
    with through_kernels() as calls:
        drive_proofs(name, proofs)
    K4_CALLS[name] = calls
    counts = all_launches()
    log(f"{name} kernel launches, prove and verify: {json.dumps(counts)}")
    log(f"{name} path: {time.perf_counter() - t0:.3f} s")
    for kernel, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{kernel} was never launched on {name}")
    return counts


def drive_proofs(name, proofs):
    """The proves of path `name` (see drive_path)."""
    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.models import baseline
    from triton_vm_tpu_torch.models import example_programs as ex

    if name in RV_CELLS:
        drive_recursive_verifier(name, proofs)
    elif name == "fib_1024":
        _, proof, _, _ = prove_and_verify(name, ex.fibonacci(), [85])
        check_digest(name, proof, JAX_FIB85_DIGEST)
    elif name == "mesh":
        drive_mesh(proofs)
    elif name == "fib_1024_stir":
        _, proof, _, _ = prove_and_verify(name, ex.fibonacci(), [85],
                                          ldt_choice="stir")
        check_digest(name, proof, JAX_FIB85_STIR_DIGEST)
    elif name in BASELINE_CELLS:
        digest, log2_height = BASELINE_CELLS[name]
        program, public_input, non_determinism = baseline.config(name)
        proofs[name], _ = prove_at_height(name, program, public_input,
                                          log2_height, non_determinism)
        check_digest(name, proofs[name], digest)
    elif name in HASH_CHAIN_CELLS:
        chain, log2_height = HASH_CHAIN_CELLS[name]
        proofs[name], _ = prove_at_height(name, ex.hash_chain(), [chain],
                                          log2_height)
    else:
        log2_height = SPIN_HEIGHTS[name]
        program, iterations = ex.spin(log2_height)
        forced = name in JIT_TWINS
        proof, _ = prove_at_height(name, program, [iterations],
                                   log2_height, forced_jit=forced)
        if name == "spin_65536":
            check_digest(name, proof, HOST_RNG_SPIN16_DIGEST,
                         "the host-drawn randomizers' proof")
        if forced:
            twin = JIT_TWINS[name]
            w, want = proof.words, proofs[twin].words
            digests = [tuple(tip5.hash_varlen([len(x) + 1, len(x)] + x))
                       for x in (w, want)]
            if w != want or digests[0] != digests[1]:
                raise AssertionError(f"{name}: the JIT proof differs from "
                                     f"{twin}'s ({digests})")
            log(f"{name}: proof equals {twin}'s word for word "
                f"(digest {digests[0]})")
        proofs[name] = proof


def config5(num_queries):
    """BASELINE config 5 as the JAX bench builds it (bench.py:107-121),
    with the port (models/baseline.py): fibonacci input 7 proven with
    Stark() and seed SEED on the card (its digest held against the JAX
    package's), then `recursive_verifier.build` on that proof (the port's
    verifier on the card fills the collector) for `num_queries` revealed
    indices."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import baseline

    stark = tvm.Stark(device="cuda")
    t0 = time.perf_counter()
    claim, proof = baseline.recursive_verifier_inner(stark)
    inner_s = time.perf_counter() - t0
    check_digest("config 5 inner fib(7)", proof, JAX_FIB7_DIGEST)
    t0 = time.perf_counter()
    built = baseline.recursive_verifier_fixture(
        stark, num_queries=num_queries, inner=(claim, proof))
    log(f"config 5: inner proof padded height {proof.padded_height()}, "
        f"{len(proof.words)} words, prove {inner_s:.3f} s; build of the "
        f"verifier core for {num_queries} revealed indices "
        f"{time.perf_counter() - t0:.3f} s")
    return built


def _divined(built):
    from triton_vm_tpu_torch.vm.machine import NonDeterminism

    return NonDeterminism(ram=dict(built.non_determinism.ram),
                          digests=list(built.non_determinism.digests))


def drive_recursive_verifier(name, proofs):
    """Config 5's verifier-core program, proven on the card: the in-VM
    AIR evaluation within 200 cycles of the specification's 33,998 rows,
    the `combined` trace's table heights equal to the JAX package's, the
    in-VM rejection of a tampered revealed row (VMError), then the
    `combined` execution proven with Stark() (STIR; the cache decision
    the heuristic makes, asserted), verified, a tampered word rejected,
    the RAM table's Bezout span printed within `fill main`'s host table
    fill."""
    import numpy as np

    from triton_vm_tpu_torch.fields.bfe import P
    from triton_vm_tpu_torch.models import recursive_verifier as rv
    from triton_vm_tpu_torch.vm.machine import VM, PublicInput, VMError

    num_queries, heights, log2_height = RV_CELLS[name]
    built = config5(num_queries)
    proofs[name + "_build"] = built
    cycles = built.run("air_eval")["cycles"]
    anchor = built.anchors["spec_static_air_eval_processor_rows"]
    if abs(cycles - anchor) >= 200:
        raise AssertionError(f"{name}: air_eval ran {cycles} cycles, not "
                             f"within 200 of {anchor}")
    t0 = time.perf_counter()
    aet, _ = VM.trace_execution(built.programs["combined"], PublicInput([]),
                                _divined(built))
    trace_s = time.perf_counter() - t0
    got = {t: aet.height_of_table(t) for t in heights}
    if got != heights or aet.padded_height() != 1 << log2_height:
        raise AssertionError(f"{name}: combined trace {got}, padded height "
                             f"{aet.padded_height()}; the JAX package's "
                             f"{heights}, 2^{log2_height}")
    pointers = len(np.unique(np.asarray(aet.ram_rows, np.uint64)[:, 2]))
    del aet
    log(f"{name}: air_eval {cycles} cycles (specification: {anchor}); "
        f"combined trace {json.dumps(got)} equals the JAX package's, padded "
        f"height 2^{log2_height}, {pointers} unique RAM pointers; traced "
        f"in {trace_s:.3f} s")
    # one word of the revealed main row flipped in RAM: the in-VM Merkle
    # walk must fail its root assertion
    tampered = _divined(built)
    addr = rv._q_main(0) + 7
    tampered.ram[addr] = (tampered.ram.get(addr, 0) + 1) % P
    try:
        VM.trace_execution(built.programs["queries"], PublicInput([]),
                           tampered)
    except VMError as e:
        log(f"{name}: tampered revealed row rejected in the VM ({e})")
    else:
        raise AssertionError(f"{name}: the verifier core accepted a "
                             "tampered revealed row")
    proof, nested = prove_at_height(name, built.programs["combined"], [],
                                    log2_height, _divined(built))
    if "RAM table/RAM Bezout" not in nested:
        raise AssertionError(f"{name}: no RAM Bezout span within the host "
                             "table fill")
    proofs[name] = proof


def phase_kernels_full(rng, bound):
    """Before recursive_verifier_full (padded height 2^21, JIT): K1 at B =
    2^23 (the widest layer of its 2^24-leaf trees) and K2 at a JIT coset of
    its main and aux tables (2^22 rows of 379 and 273, column-major), its
    quotient table (2^24 rows of 15, column-major; the plain version in
    slices of 2^22 rows) and its widest STIR tree's leaves (2^22 rows of
    12), each held against the plain version (max_abs_err 0), then timed;
    per-prove totals from every launch's shape. Returns the K1 and K2
    records of the kernels line."""
    import torch

    from triton_vm_tpu_torch.crypto import tip5
    from triton_vm_tpu_torch.ops import gf, tip5_cuda

    def held(rows, slice_rows):
        """max_abs_err of K2 against its plain version (run on slices of
        `slice_rows` rows), and the plain version's seconds."""
        got = tip5_cuda.sponge_absorb_rows(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.cat([tip5_cuda.sponge_absorb_rows_plain(
            rows[i:i + slice_rows]) for i in range(0, rows.shape[0],
                                                   slice_rows)], dim=1)
        torch.cuda.synchronize()
        return max_abs_err(got, want), time.perf_counter() - t0

    def k2_bound(rb, n):
        # ceil((n + 1) / RATE) permutations a row, as the kernel runs
        return bound(8 * rb * (n + 5), rb * ((n + tip5.RATE) // tip5.RATE))

    s = gf.from_u64(random_field(rng, (16, 1 << 23)), "cuda")
    k1_err = max_abs_err(tip5_cuda.permutation(s),
                         tip5_cuda.permutation_plain(s))
    if k1_err:
        raise AssertionError(f"K1 disagrees with its plain version at 2^23: "
                             f"{k1_err}")
    k1_ms = time_ms(lambda: tip5_cuda.permutation(s), 10)
    k1_plain_ms = time_ms(lambda: tip5_cuda.permutation_plain(s), 1)
    k1_bound = bound(2 * 16 * 8 * (1 << 23), 1 << 23)
    del s
    by_batch = {}
    for k in range(24):
        layer = gf.from_u64(random_field(rng, (16, 1 << k)), "cuda")
        by_batch[k] = (time_ms(lambda: tip5_cuda.permutation(layer),
                               20 if k > 12 else 200),
                       bound(2 * 16 * 8 * (1 << k), 1 << k)[0])
    batches = k1_batches_per_prove(21)
    k1_total = (sum(by_batch[k][0] for k in batches),
                sum(by_batch[k][1] for k in batches))
    log(f"K1 2^23 equals its plain version: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.2f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); "
        f"per recursive_verifier_full prove ({len(batches)} launches) "
        f"{k1_total[0]:.4f} ms, bound {k1_total[1]:.4f} ms")

    errs, by_shape = [], {}
    for rb, n in ((1 << 22, 379), (1 << 22, 273), (1 << 24, 15),
                  (1 << 22, 12)):
        host = random_field(rng, (rb, n) if n == 12 else (n, rb))
        rows = gf.from_u64(host, "cuda")
        del host
        rows = rows if n == 12 else rows.T
        err, plain_s = held(rows, 1 << 22)
        errs.append(err)
        if err:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"2^{rb.bit_length() - 1} x {n}: {err}")
        t = time_ms(lambda: tip5_cuda.sponge_absorb_rows(rows), 3)
        bms, by = k2_bound(rb, n)
        by_shape[rb, n] = (t, bms, by, plain_s)
        log(f"K2 2^{rb.bit_length() - 1} x {n} "
            f"{'row' if n == 12 else 'column'}-major equals its plain "
            f"version (plain {plain_s:.1f} s): kernel {t:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        if n == 12:
            for rb2, n2 in k2_launches_per_prove(21, jit=True):
                if n2 == 12 and (rb2, n2) not in by_shape:
                    by_shape[rb2, n2] = (
                        time_ms(lambda: tip5_cuda.sponge_absorb_rows(
                            rows[:rb2]), 20),
                        *k2_bound(rb2, n2), None)
        del rows
        torch.cuda.empty_cache()
    launches = k2_launches_per_prove(21, jit=True)
    k2_total = (sum(by_shape[key][0] for key in launches),
                sum(by_shape[key][1] for key in launches))
    log(f"K2 per recursive_verifier_full prove ({len(launches)} launches): "
        f"{k2_total[0]:.3f} ms, bound {k2_total[1]:.3f} ms")
    ms, bms, by, plain_s = by_shape[1 << 22, 379]
    shapes = {f"2^{rb.bit_length() - 1}x{n}": v
              for (rb, n), v in by_shape.items()}
    return (dict(name="tip5_permutation", route="cuda", source=SOURCE,
                 replaces="triton_vm_tpu/ops/tip5_pallas.py:157",
                 max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
                 bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
                 per_prove_ms={"recursive_verifier_full": k1_total[0]},
                 per_prove_bound_ms={
                     "recursive_verifier_full": k1_total[1]}),
            dict(name="tip5_sponge_rows", route="cuda", source=SOURCE,
                 replaces="triton_vm_tpu/ops/tip5_pallas.py:233",
                 max_abs_err=max(errs), ms=ms, plain_ms=plain_s * 1e3,
                 bound_ms=bms, bound_by=by, library_ms=None,
                 ms_by_shape={k: v[0] for k, v in shapes.items()},
                 bound_ms_by_shape={k: v[1] for k, v in shapes.items()},
                 per_prove_ms={"recursive_verifier_full": k2_total[0]},
                 per_prove_bound_ms={
                     "recursive_verifier_full": k2_total[1]}))


def _challenges(rng, program, public_input, output):
    """Random sampled challenges for a trace's claim."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.air.challenges import SAMPLE_COUNT, Challenges

    claim = (tvm.Claim.about_program(program).with_input(public_input)
             .with_output(output))
    return Challenges([tuple(int(c) for c in row)
                       for row in random_field(rng, (SAMPLE_COUNT, 3))],
                      claim)


def phase_witness(built):
    """The device-resident witness (`main_witness_dev`, `aux_witness_dev`)
    on the card against the same functions on CPU tensors, which tier-1
    holds to the JAX package's host witness (tests/test_torch_witness.py),
    word for word: on u32_mix (first, so the AIR and the tapes are built
    before spin(12) is timed), on spin(12), on config 5's fs_replay and
    queries sections of `built` (sponge_absorb_mem, sponge_squeeze,
    merkle_step, the extension-field instructions and RAM pointers from
    2^40 to 2^50) and on hash_chain_65536's trace (hash_chain input 4000:
    24,036 hash and 64,260 cascade rows), padded height 2^16 each."""
    import numpy as np
    import torch

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.ops import gf, gfx
    from triton_vm_tpu_torch.tables import extend_device as ed
    from triton_vm_tpu_torch.tables import master as mt

    rng = np.random.default_rng(17)
    spin_program, spin_iterations = ex.spin(12)
    chain, _ = HASH_CHAIN_CELLS["hash_chain_65536"]
    cases = [("u32_mix", ex.u32_mix(), [50], None),
             ("spin_4096", spin_program, [spin_iterations], None)]
    cases += [(f"config 5 {section}", built.programs[section], [],
               _divined(built)) for section in ("fs_replay", "queries")]
    cases.append(("hash_chain_65536", ex.hash_chain(), [chain], None))

    def witness(main_air, challenges, randomizer, device):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        main = ed.main_witness_dev(main_air, device)
        aux = ed.aux_witness_dev(main, challenges,
                                 gfx.from_u64(randomizer, device))
        if device == "cuda":
            torch.cuda.synchronize()
        return gf.to_u64(main), gf.to_u64(aux), time.perf_counter() - t0

    for label, program, public_input, non_determinism in cases:
        aet, output = tvm.VM.trace_execution(
            program, tvm.PublicInput(public_input), non_determinism)
        challenges = _challenges(rng, program, public_input, output)
        h = aet.padded_height()
        main_air = mt.fill_main_table(aet, padded_height=h, device="cuda")
        randomizer = random_field(rng, (h, 3))
        got_main, got_aux, dev_s = witness(main_air, challenges, randomizer,
                                           "cuda")
        main, aux, cpu_s = witness(main_air, challenges, randomizer, "cpu")
        bad = ([f"main {c}" for c in range(ed.NUM_MAIN)
                if not np.array_equal(got_main[c], main[c])]
               + [f"aux {c}" for c in range(ed.NUM_AUX)
                  if not np.array_equal(got_aux[c], aux[c])])
        if bad:
            raise AssertionError(f"witness {label}: the card's witness "
                                 f"differs from the CPU's in {bad}")
        log(f"witness {label} (padded height {h}): 379 main and 91 aux "
            f"columns equal the CPU's; card {dev_s:.4f} s, CPU "
            f"{cpu_s:.4f} s")


def phase_bench(kernels):
    """The bench phase (phase 15). `kernels` are the kernels phase's
    records, if it ran. Returns the K1 and K2 launches of the bench's
    proves and verifies, which it prints on stderr."""
    import torch

    from triton_vm_tpu_torch import bench

    torch.cuda.empty_cache()
    timed = {k["name"]: k for k in kernels}
    launches = {}
    for name in BENCH_CONFIGS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "triton_vm_tpu_torch.bench"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, TVM_BENCH=name, TVM_BENCH_SOL="1",
                     TVM_PROFILE="1"),
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"bench {name}: {line}")
        for line in proc.stderr.splitlines():
            log(f"bench {name} (stderr): {line}")
        if proc.returncode != 0:
            raise AssertionError(f"bench {name} exited {proc.returncode}")
        last = json.loads(proc.stdout.splitlines()[-1])
        if ("partial" in last or "incomplete" in last
                or not {"stages", "verify_s", "sol"} <= last.keys()
                or not last["stages"]
                or last["metric"] != bench.metric(name)):
            raise AssertionError(f"bench {name}: not a whole result: {last}")
        counts = json.loads(re.search(
            r"kernel launches \(proves and verify\): (\{.*\})",
            proc.stderr).group(1))
        for kernel, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{kernel} was never launched in "
                                     f"bench {name}'s proves")
            launches[kernel] = launches.get(kernel, 0) + n
        sol = last["sol"]
        b = bench.SOL_BATCH
        beside = ""
        if timed:
            beside = (f"; kernels phase: K1 2^18 "
                      f"{timed['tip5_permutation']['ms_by_width']['2^18']:.4f}"
                      f" ms, K2 2^18 x 379 column-major "
                      f"{timed['tip5_sponge_rows']['ms']:.3f} ms")
        log(f"bench {name}: prove {last['value']} s warm, "
            f"{last['cold_prove_s']} s cold, verify {last['verify_s']} s, "
            f"ramp {last['ramp_s']} s, {wall:.1f} s with the process; SOL "
            f"K1 2^18 {1e3 * b / sol['tip5_perms_per_s']:.4f} ms, K2 2^18 x "
            f"379 row-major {1e3 * b / sol['row_sponge_rows_per_s']:.3f} ms"
            + beside)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES)
                    + " (by default all but "
                    + " and ".join(OPTIONAL_PHASES) + ")")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases: {sorted(phases - set(PHASES))}")
    for jit, twin in JIT_TWINS.items():
        if jit in phases and twin not in phases:
            ap.error(f"{jit} is held against {twin}: name both")
    if "mesh" in phases:
        phases.add("spin_65536")  # the mesh proof is held against its proof

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
    bound = (Bound() if phases & {"kernels", "mesh", "recursive_verifier_full"}
             else None)
    if "kernels" in phases:
        kernels = [phase_k1(rng, bound), phase_k2(rng, bound),
                   phase_k3(rng, bound), phase_k4(rng, bound),
                   phase_rng(rng, bound)]
    if "recursive_verifier_full" in phases:
        full = phase_kernels_full(rng, bound)
        if not kernels:
            kernels = list(full)
        for k, f in zip(kernels, full):
            if k is not f:
                k["max_abs_err"] = max(k["max_abs_err"], f["max_abs_err"])
                k["per_prove_ms"].update(f["per_prove_ms"])
                k["per_prove_bound_ms"].update(f["per_prove_bound_ms"])
        torch.cuda.empty_cache()
    if "mesh" in phases:
        mesh_checks = phase_mesh_kernels(rng, bound)
        for k in kernels:
            if k["name"] not in mesh_checks:
                continue
            err, shapes = mesh_checks[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k["mesh_shard_ms"] = {s: t for s, (t, _) in shapes.items()}
            k["mesh_shard_bound_ms"] = {s: b for s, (_, b) in shapes.items()}
    launches, proofs = {}, {}
    for path in PATHS:
        if path in phases:
            for kernel, n in drive_path(path, proofs).items():
                launches[kernel] = launches.get(kernel, 0) + n
    if launches:
        log(f"kernel launches on the main path, all paths: "
            f"{json.dumps(launches)}")
        k4_per_prove(K4_CALLS, bound or Bound(), next(
            (k for k in kernels if k["name"] == "ntt_pass"), None))
    if "witness" in phases:
        phase_witness(proofs.get("recursive_verifier_build") or config5(1))
    if "bench" in phases:
        counts = phase_bench(kernels)
        log(f"kernel launches of the bench's proves and verifies: "
            f"{json.dumps(counts)}")
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
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
