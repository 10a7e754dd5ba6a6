"""A first look at K4 (csrc/ntt.cu) on the card, and at where a prove's
device memory goes.

Default: build K4 and K3 (csrc/goldilocks.cuh serves both), print ptxas's
report for each, hold K3 against its plain version at 2^12 rows, then hold
`ntt.ntt` / `intt` / `lde` on the card against the plain version
(`ntt._rows_plain`) at twelve shapes from 1000 rows of 4 words to 3 rows
of 2^24, each timed with CUDA events (three calls after a warm-up, the
host's dispatch included), and time a 379 x 2^21 coset NTT, a JIT coset
of a 2^20 prove. Exits 1 on any difference.

--memory: prove spin(16) (padded height 2^16, cached LDE) with
`prove_program`, outside chip_smoke.py's harness, and list the device
allocations still alive after it (1 MiB and up) with the port's frames
that made them, beside the prove's peak. --stage-peak STAGE: prove
hash_chain input 40000 (config 3 at padded height 2^20, JIT) and record
the allocator's events within the prover stage STAGE only; replay them
from the blocks alive when it began and list what was alive at the
stage's peak (by the port's frames that allocated it). Neither imports
anything of K4, so a copy of this file in an older checkout's tools/
measures that checkout.

    python3 -m triton_vm_tpu_torch.tools.ntt_probe
    python3 -m triton_vm_tpu_torch.tools.ntt_probe --memory
    python3 -m triton_vm_tpu_torch.tools.ntt_probe --stage-peak "weighted sum"

--time --src OLD --src NEW [--variants]: K4 from each source, built and
timed in turns (OLD, NEW, NEW, OLD, ... `--rounds` times) with CUDA events
at every launch class from 2^13 words a row up (`TIMED`), each result held
against the plain version first; a source is driven through its own
interface, the shared-memory design's of commit 3a5ce70 (n-word scales,
one inner table) or the current one
(levels, two-table scales), told apart by its text. `--variants` adds
timing-only variants (their results are not checked): of the first
source, built from its text, without the butterfly's multiply, without
the barriers between stages, with the inner twiddles staged in shared
memory, as a copy (loads and stores only), and with the strided passes'
tiles sized for 1, 2 and 4 CTAs an SM; of the last source, as a copy and
without the butterfly's multiply, and with its strided tiles at 32 and
64 KiB; of both, each pass of a two-pass transform alone.
The old source is taken from git into a git-ignored directory:

    mkdir -p _tree/old && for f in ntt.cu goldilocks.cuh; do git show \
        3a5ce70:triton_vm_tpu_torch/csrc/$f > _tree/old/$f; done
    python3 -m triton_vm_tpu_torch.tools.ntt_probe --time --variants \
        --src _tree/old/ntt.cu --src triton_vm_tpu_torch/csrc/ntt.cu

Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..fields import bfe
from ..fields.bfe import P
from ..ops import gf, ntt

SHAPES = [(4096, 32, 64, 1, "ntt"), (1000, 3, 4, 1, "ntt"),
          (7, 1, 1, 1, "ntt"), (37, 100, 128, 7, "ntt"),
          (1001, 4096, 4096, 7, "ntt"), (379, 1 << 13, 1 << 13, 7, "ntt"),
          (273, 1 << 14, 1 << 14, 7, "intt"),
          (379, 1 << 16, 1 << 17, 7, "ntt"),
          (3, 1 << 20, 1 << 20, 7, "intt"),
          (15, 1 << 22, 1 << 22, 7, "ntt"),
          (3, 1 << 24, 1 << 24, 7, "ntt"), (379, 1 << 12, 1 << 14, 1, "lde")]


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _plain(kind, x, n_in, length, off):
    inv_root = bfe.inv(bfe.primitive_root_of_unity(n_in))
    if kind == "intt":
        return ntt._rows_plain(x, inv_root, n_in, None,
                               ntt._unscale(n_in, off))
    if kind == "lde":
        x = ntt._rows_plain(x, inv_root, n_in, None, ntt._unscale(n_in, 1))
        off = 7
    return ntt._rows_plain(x, bfe.primitive_root_of_unity(length), length,
                           ntt._coset_scale(off))


# ------------------------------------------------------------ in turns

# (rows, n_in, length, kind): the launch classes of the provers from 2^13
# words a row up (chip_smoke.py's K4 classes), a coset at offset 7, an
# iNTT with its scale
TIMED = [(379, 1 << 13, 1 << 13, "coset"), (1, 1 << 15, 1 << 16, "ntt"),
         (273, 1 << 16, 1 << 17, "coset"), (379, 1 << 17, 1 << 17, "coset"),
         (379, 1 << 19, 1 << 19, "coset"), (379, 1 << 20, 1 << 20, "intt"),
         (273, 1 << 21, 1 << 21, "coset"), (379, 1 << 21, 1 << 21, "coset"),
         (3, 1 << 22, 1 << 22, "intt"), (15, 1 << 23, 1 << 23, "coset"),
         (3, 1 << 24, 1 << 24, "intt"), (15, 1 << 24, 1 << 24, "coset")]

# The shared-memory design's text that each timing-only variant of an old
# source replaces
VARIANT_EDITS = {
    "no multiply": [(
        "if (lm) w = fmul(w, __ldg(a.inner + (jj << (half_log - lm))));",
        "")],
    "no barriers": [(
        """      sm[s1] = fsub(u, w);
    }
    __syncthreads();""", """      sm[s1] = fsub(u, w);
    }""")],
    "smem twiddles": [(
        "  const int words = L << a.log_tile;\n",
        "  const int words = L << a.log_tile;\n"
        "  uint64_t* tws = sm + words;\n"
        "  for (int e = threadIdx.x; e < L / 2; e += kThreads)"
        " tws[e] = __ldg(a.inner + e);\n"), (
        "__ldg(a.inner + (jj << (half_log - lm)))",
        "tws[jj << (half_log - lm)]"), (
        "<< log_len << log_tile;",
        "<< log_len << log_tile) + 4 * (1 << log_len);"), (
        "const int smem = static_cast<int>(sizeof(uint64_t))",
        "const int smem = (static_cast<int>(sizeof(uint64_t))"), (
        "kMaxTileWords * static_cast<int>(sizeof(uint64_t)));",
        "kMaxTileWords * static_cast<int>(sizeof(uint64_t)) + 16384);")],
}
# the same for the current source (the last --src)
NEW_VARIANT_EDITS = {
    "new copy only": [
        ("    dft<LR>(v, a.rw);\n", ""),
        ("const uint64_t y = k ? fmul(v[k], tw[k << log_q]) : v[k];",
         "const uint64_t y = v[k];"),
        ("if (a.pre_lo) {", "if (false) {"),
        ("if (a.tw_lo) {", "if (false) {"),
        ("if (a.post_lo) {", "if (false) {")],
    "new no butterfly multiply": [(
        "const uint64_t w = j ? fmul(v[top + h], rw[j * (8 / h)])",
        "const uint64_t w = j ? v[top + h]")],
}
OLD_COPY_EDITS = [("for (int lm = 0; lm < a.log_len; ++lm) {",
                   "for (int lm = 0; lm < 0; ++lm) {"),
                  ("if (a.pre) v =", "if (false) v ="),
                  ("if (a.tw_lo) {", "if (false) {"),
                  ("if (a.post) v =", "if (false) v =")]
# The shared-memory design's strided tiles (words a CTA) for 1, 2 and 4
# CTAs an SM: 128, 64
# and 32 KiB of shared memory, 512 threads a CTA
OLD_STRIDED_TILES = {"1 CTA/SM": 1 << 14, "2 CTAs/SM": 1 << 13,
                     "4 CTAs/SM": 1 << 12}


def _is_old(src: Path) -> bool:
    return "lv[3]" not in src.read_text()


def _old_passes(length, strided_words=1 << 13):
    """The shared-memory design's plan: (log_len, log_seqs, in_seq,
    in_elem, out_seq, out_elem, first, twiddle, last, log_tile) a pass."""
    log_n = length.bit_length() - 1
    if log_n <= 12:
        return [(log_n, 0, 0, 1, 0, 1, True, False, True,
                 max(0, 11 - log_n))]
    log_n2 = (log_n + 1) // 2
    log_n1 = log_n - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2

    def tile(log_len):
        return min(5, max(2, strided_words.bit_length() - 1 - log_len))
    return [(log_n2, log_n1, 1, n1, n2, 1, True, False, False,
             tile(log_n2)),
            (log_n1, log_n2, 1, n2, 1, n2, False, True, True, tile(log_n1))]


def _old_launcher(so, strided_words=1 << 13, only=None):
    """fn(x, root, length, pre, post, out) for a build of the
    shared-memory design at `so`."""
    from ..ops.npfield import powers_u64

    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ntt_pass_launch.argtypes = [vp, i64, i64, vp, i64, i64, i32, i64,
                                    i64, i64, i64, vp, vp, vp, vp, vp, i32,
                                    i32, vp]
    lib.ntt_pass_launch.restype = i32
    cache = {}

    def tables(length, root):
        key = (length, root)
        if key not in cache:
            passes = _old_passes(length, strided_words)
            inner = [gf.from_u64(powers_u64(
                pow(root, length >> p[0], P), 1, max(1, (1 << p[0]) // 2)),
                "cuda") for p in passes]
            tw = [gf.from_u64(powers_u64(root, 1, 4096), "cuda"),
                  gf.from_u64(powers_u64(pow(root, 4096, P), 1,
                                         max(1, length >> 12)), "cuda")]
            cache[key] = passes, inner, tw
        return cache[key]

    def run(x, root, length, pre, post, out):
        rows, n_in = x.shape
        passes, inner, tw = tables(length, root)
        pre_v = None if pre is None else ntt._scales(n_in, *pre, "cuda")
        post_v = None if post is None else ntt._scales(length, *post,
                                                       "cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for k, p in enumerate(passes):
            if only is not None and k != only:
                continue
            log_len, log_seqs, i_s, i_e, o_s, o_e, first, twid, last, t = p
            src = x if first else out
            rc = lib.ntt_pass_launch(
                src.data_ptr(), src.stride(0), n_in if first else length,
                out.data_ptr(), out.stride(0), rows, log_seqs, i_s, i_e, o_s,
                o_e, pre_v.data_ptr() if first and pre_v is not None
                else None,
                post_v.data_ptr() if last and post_v is not None else None,
                tw[0].data_ptr() if twid else None,
                tw[1].data_ptr() if twid else None, inner[k].data_ptr(),
                log_len, t, stream)
            if rc:
                raise RuntimeError(f"launch failed ({rc})")
        return out
    return run


def _new_launcher(so, only=None):
    from ..ops import ntt_cuda

    lib = ntt_cuda.bind(so)

    def run(x, root, length, pre, post, out):
        ntt_cuda._enqueue(lib, x, root, length, pre, post, out,
                          torch.cuda.current_stream().cuda_stream, only)
        return out
    return run


def _timed_inputs(rows, n_in, length, kind):
    g = torch.Generator("cuda").manual_seed(rows * 131 + length)
    x = torch.randint(0, 1 << 62, (rows, n_in), dtype=torch.int64,
                      device="cuda", generator=g)
    root = bfe.primitive_root_of_unity(length)
    pre = post = None
    if kind == "intt":
        root, post = bfe.inv(root), ntt._unscale(length, 7)
    elif kind == "coset":
        pre = ntt._coset_scale(7)
    return x, root, length, pre, post


def time_in_turns(sources, variants, rounds, out_dir) -> int:
    from ..ops import ntt_cuda, tip5_cuda
    from . import tip5_probe

    srcs = [Path(s) for s in sources]
    runs = {}
    out_dir.mkdir(parents=True, exist_ok=True)
    if variants:
        for i, src, table in ((0, srcs[0], {**VARIANT_EDITS,
                                            "copy only": OLD_COPY_EDITS}),
                              (len(srcs) - 1, srcs[-1], NEW_VARIANT_EDITS)):
            # the edited sources go under out_dir, each beside a copy of
            # the header its source includes
            vdir = out_dir / f"variants_src{i}"
            vdir.mkdir(exist_ok=True)
            header = src.parent / "goldilocks.cuh"
            if header.exists():
                (vdir / header.name).write_bytes(header.read_bytes())
            base = src.read_text()
            for name, edits in table.items():
                text = base
                for a, b in edits:
                    if a not in text:
                        raise ValueError(f"variant {name!r}: text not found")
                    text = text.replace(a, b)
                path = vdir / f"ntt_{name.replace(' ', '_')}.cu"
                path.write_text(text)
                runs[name] = (path, False)
    labels = []
    for i, src in enumerate(srcs):
        labels.append(f"src{i} {src}")
        runs[labels[-1]] = (src, True)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        built = dict(zip(runs, pool.map(
            lambda kv: tip5_cuda.build(kv[0]), runs.values())))
    print(f"built {len(built)} sources in {time.time() - t0:.1f} s",
          flush=True)
    fns = {}
    for name, so in built.items():
        print(name, json.dumps(tip5_cuda.ptxas_report(
            so, (ntt_cuda.KERNEL,))), "SASS", json.dumps(
            tip5_probe.sass_summary(so)), flush=True)
        if _is_old(runs[name][0]):
            fns[name] = _old_launcher(so)
        else:
            fns[name] = _new_launcher(so)
    if variants:
        for k in (0, 1):
            fns[f"old pass {k + 1} only"] = _old_launcher(built[labels[0]],
                                                          only=k)
            fns[f"new pass {k + 1} only"] = _new_launcher(built[labels[-1]],
                                                          only=k)
        for name, words in OLD_STRIDED_TILES.items():
            fns[f"old {name}"] = _old_launcher(built[labels[0]], words)
            runs[f"old {name}"] = (None, False)
        for words in (1 << 12, 1 << 13):
            def tiled(x, root, length, pre, post, out, words=words,
                      fn=fns[labels[-1]]):
                saved = ntt_cuda.STRIDED_TILE_WORDS
                ntt_cuda.STRIDED_TILE_WORDS = words
                try:
                    return fn(x, root, length, pre, post, out)
                finally:
                    ntt_cuda.STRIDED_TILE_WORDS = saved
            name = f"new strided tile {words >> 7} KiB"
            fns[name], runs[name] = tiled, (None, False)
    bad = 0
    results = {}
    order = labels + labels[::-1]
    for shape in TIMED:
        rows, n_in, length, kind = shape
        x, root, length, pre, post = _timed_inputs(*shape)
        out = torch.empty((rows, length), dtype=torch.int64, device="cuda")
        want = None
        for name in labels:
            got = fns[name](x, root, length, pre, post, out).clone()
            if want is None:
                want = ntt._blockwise(
                    lambda b, o: o.copy_(ntt._rows_plain(b, root, length,
                                                         pre, post)),
                    x, length, gf.block_rows(length))
            if not torch.equal(got, want):
                print(f"MISMATCH {name} at {shape}", flush=True)
                bad += 1
            del got
        del want
        words = rows * length
        reps = 3 if words >= 1 << 26 else 10 if words >= 1 << 20 else 50
        times = {name: [] for name in fns}
        for _ in range(rounds):
            for name in order:
                times[name].append(_ms(lambda: fns[name](
                    x, root, length, pre, post, out), reps))
            for name in fns:
                if name not in labels:
                    times[name].append(_ms(lambda: fns[name](
                        x, root, length, pre, post, out), reps))
        label = f"{rows}x2^{length.bit_length() - 1} {kind}"
        results[label] = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
        print(label, json.dumps({n: [round(v, 4) for v in t]
                                 for n, t in times.items()}), flush=True)
        del x, out
        torch.cuda.empty_cache()
    (out_dir / "ntt_turns.json").write_text(json.dumps(results, indent=1))
    print("medians (ms):", json.dumps(results))
    print("mismatches", bad)
    return 1 if bad else 0


def check_and_time() -> int:
    from ..ops import ntt_cuda, quotient_cuda
    from . import quotient_inputs as qi

    t0 = time.time()
    ntt_cuda.load()
    print("K4 built", round(time.time() - t0, 1), "s", flush=True)
    print(json.dumps(ntt_cuda.ptxas_report()))
    t0 = time.time()
    quotient_cuda.load()
    print("K3 built", round(time.time() - t0, 1), "s",
          json.dumps(quotient_cuda.ptxas_report()), flush=True)
    rng = np.random.default_rng(5)
    inp = qi.make_inputs(rng, 1 << 12, "cuda")
    print("K3 vs plain at 2^12:", torch.equal(qi.k3(inp), qi.plain(inp)),
          flush=True)
    bad = 0
    for rows, n_in, length, off, kind in SHAPES:
        x = gf.from_u64(rng.integers(0, P, size=(rows, n_in),
                                     dtype=np.uint64), "cuda")
        run = {"ntt": lambda: ntt.ntt(x, off, length),
               "intt": lambda: ntt.intt(x, off),
               "lde": lambda: ntt.lde(x, length // n_in, 1, 7)}[kind]
        ok = torch.equal(run(), _plain(kind, x, n_in, length, off))
        bad += not ok
        print(kind, rows, n_in, length, "equal" if ok else "MISMATCH",
              f"{_ms(run, 3):.3f} ms", flush=True)
        del x
        torch.cuda.empty_cache()
    x = gf.from_u64(rng.integers(0, P, size=(379, 1 << 21),
                                 dtype=np.uint64), "cuda")
    print(f"379 x 2^21 coset: {_ms(lambda: ntt.ntt(x, 7), 3):.3f} ms; "
          f"launches {ntt_cuda.launches}", flush=True)
    print("mismatches", bad)
    return 1 if bad else 0


def memory() -> int:
    import gc

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import example_programs as ex

    torch.cuda.memory._record_memory_history(max_entries=200000)
    program, iterations = ex.spin(16)
    torch.cuda.reset_peak_memory_stats()
    tvm.prove_program(program, [iterations], seed=bytes(range(32)),
                      device="cuda")
    torch.cuda.synchronize()
    gc.collect()
    print(f"peak GiB {torch.cuda.max_memory_allocated() / 2**30}, alive "
          f"after the prove GiB {torch.cuda.memory_allocated() / 2**30}")
    rows = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "active_allocated" and b["size"] >= 1 << 20:
                frames = [f"{f['filename'].split('triton_vm_tpu_torch/')[-1]}"
                          f":{f['line']}:{f['name']}"
                          for f in b.get("frames", [])
                          if "triton_vm_tpu_torch" in f["filename"]]
                rows.append((b["size"], frames[:4]))
    for size, frames in sorted(rows, key=lambda r: -r[0])[:20]:
        print(round(size / 2**20, 1), "MiB", frames)
    print("alive, blocks of 1 MiB and up:",
          sum(r[0] for r in rows) / 2**20, "MiB")
    return 0


def _frames(frames):
    return tuple(f"{f['filename'].split('triton_vm_tpu_torch/')[-1]}"
                 f":{f['line']}:{f['name']}" for f in frames
                 if "triton_vm_tpu_torch" in f["filename"])[:3]


def stage_peak(stage: str) -> int:
    import collections

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import example_programs as ex
    from triton_vm_tpu_torch.stark import prover

    marker = prover._trace
    state = {}

    def report():
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        live = dict(state["base"])
        cur = peak = sum(size for size, _ in live.values())
        at = -1
        for i, ev in enumerate(events):
            if ev["action"] == "alloc":
                live[ev["addr"]] = (ev["size"], _frames(ev["frames"]))
                cur += ev["size"]
                if cur > peak:
                    peak, at = cur, i
            elif ev["action"] == "free_requested" and ev["addr"] in live:
                cur -= live.pop(ev["addr"])[0]
        live = dict(state["base"])
        for ev in events[:at + 1]:
            if ev["action"] == "alloc":
                live[ev["addr"]] = (ev["size"], _frames(ev["frames"]))
            elif ev["action"] == "free_requested" and ev["addr"] in live:
                live.pop(ev["addr"])
        by = collections.Counter()
        for size, frames in live.values():
            by[frames] += size
        print(f"stage {stage!r}: {len(events)} events, alive at its start "
              f"{sum(sz for sz, _ in state['base'].values()) / 2**30:.3f} "
              f"GiB, replayed peak {peak / 2**30:.3f} GiB")
        for frames, size in by.most_common(15):
            print(f"  {size / 2**30:.3f} GiB", list(frames) or
                  ["(alive when the stage began)"])

    def traced(msg, category=None, device=None):
        if state.get("on"):
            state["on"] = False
            report()
        out = marker(msg, category, device)
        if msg == stage:
            torch.cuda.synchronize()
            state["base"] = {
                b["address"]: (b["size"], ())
                for seg in torch.cuda.memory._snapshot()["segments"]
                for b in seg["blocks"] if b["state"] == "active_allocated"}
            torch.cuda.memory._record_memory_history(max_entries=2_000_000)
            state["on"] = True
        return out

    prover._trace = traced
    torch.cuda.reset_peak_memory_stats()
    tvm.prove_program(ex.hash_chain(), [40000], seed=bytes(range(32)),
                      device="cuda")
    torch.cuda.synchronize()
    print(f"prove peak GiB {torch.cuda.max_memory_allocated() / 2**30}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--memory", action="store_true",
                    help="list the allocations alive after a 2^16 prove")
    ap.add_argument("--stage-peak", metavar="STAGE",
                    help="what is alive at the peak of a 2^20 prove's STAGE")
    ap.add_argument("--time", action="store_true",
                    help="time the --src builds of K4 in turns")
    ap.add_argument("--src", action="append", default=[],
                    help="a csrc/ntt.cu to time (repeat; the first is the "
                         "baseline)")
    ap.add_argument("--variants", action="store_true",
                    help="also time variants of the first --src")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="triton_vm_tpu_torch/_build/ntt_probe")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.stage_peak:
        return stage_peak(args.stage_peak)
    if args.time:
        return time_in_turns(args.src, args.variants, args.rounds,
                             Path(args.out))
    return memory() if args.memory else check_and_time()


if __name__ == "__main__":
    sys.exit(main())
