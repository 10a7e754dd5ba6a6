"""K3 (the AIR quotient) from several sources, built and timed in turns on
the card.

`--src OLD` names the row-tape interpreter (csrc/quotient.cu of 3a5ce70,
which walks the row tape instruction by instruction; its interface takes
the tape's code, its constants and an n-word table of points); the current
generated source (ops/tape_codegen.py around csrc/quotient.cu) is built
at each segment size of `--targets`. Every build's seconds and ptxas
report (registers, stack, spills, summed over the segments) are printed.
Each build is held against K3's plain version at 2^16 rows (edge values,
aux permuted, a shard's halo); then all are timed in turns (OLD, NEW...,
NEW..., OLD, `--rounds` times) with CUDA events at every row count a
prove launches K3 with, 2^13 to 2^22 (`ROWS`). `--variants` adds builds
made by editing a copy of the source's text under `--out`: the generated
source with its XFE products inlined and with 256 threads a CTA
(`NEW_VARIANT_EDITS`, checked as the others), and the old interpreter
with its register file cut to 16 words (wrong results, timing only: what
its local-memory register file costs).

    mkdir -p _tree/old && for f in quotient.cu goldilocks.cuh; do \\
        git show 3a5ce70:triton_vm_tpu_torch/csrc/$f > _tree/old/$f; done
    python3 -m triton_vm_tpu_torch.tools.quotient_probe --src \\
        _tree/old/quotient.cu --targets 100 --variants

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

from ..air import compile as aircomp
from ..ops import gf, quotient_cuda, tape_codegen, tip5_cuda
from . import quotient_inputs as qi
from . import tip5_probe

ROWS = (1 << 13, 1 << 16, 1 << 19, 1 << 20, 1 << 21, 1 << 22)
CUT_EDITS = [("uint64_t reg[kMaxRegWords];", "uint64_t REGFILE;"),
             ("reg[", "reg[15 & "),
             ("uint64_t REGFILE;", "uint64_t reg[16];")]
# Timing-only edits of the current csrc/quotient.cu
NEW_VARIANT_EDITS = {
    "XFE products inlined": [
        ("__device__ __noinline__ Xfe xmul",
         "__device__ __forceinline__ Xfe xmul"),
        ("__device__ __noinline__ Xfe xscale",
         "__device__ __forceinline__ Xfe xscale")],
    "256 threads a CTA": [("constexpr int kThreads = 128;",
                           "constexpr int kThreads = 256;")],
}


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


def _old_launcher(so):
    """fn(inp) -> out for a build of the interpreter at `so`."""
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.quotient_rows_launch.argtypes = [
        vp, i64, vp, vp, vp, i64, vp, i64, vp, i64, i64, vp, i64, i64, i64,
        vp, i64, i64, i64, i32, ctypes.c_uint64, i32, i32, vp, vp]
    lib.quotient_rows_launch.restype = i32
    tape = aircomp.quotient_row_tape()
    code = torch.as_tensor(np.ascontiguousarray(tape.code, np.int32),
                           device="cuda")
    bconsts = gf.from_u64(np.concatenate([tape.bconsts,
                                          np.zeros(1, np.uint64)]), "cuda")
    xconsts = gf.from_u64(np.concatenate([tape.xconsts.reshape(-1),
                                          np.zeros(1, np.uint64)]), "cuda")
    xs_cache = {}

    def run(inp):
        main, aux, pts = inp["main"], inp["aux"], inp["points"]
        if pts not in xs_cache:
            xs_cache.clear()
            xs_cache[pts] = pts.tensor("cuda")
        out = torch.empty((3, pts.n), dtype=torch.int64, device="cuda")
        rc = lib.quotient_rows_launch(
            code.data_ptr(), code.shape[0], bconsts.data_ptr(),
            xconsts.data_ptr(), inp["ch"].data_ptr(), inp["ch"].shape[1],
            inp["ws"].data_ptr(), inp["ws"].shape[1], main.data_ptr(),
            *main.stride(), aux.data_ptr(), *aux.stride(),
            xs_cache[pts].data_ptr(), pts.n, main.shape[1], inp["shift"],
            inp["trace_len"].bit_length() - 1, inp["gen_inv"],
            tape.num_bregs, tape.reg_words, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return out
    return run


def _new_launcher(so):
    lib = quotient_cuda.bind(so)

    def run(inp):
        out = torch.empty((3, inp["points"].n), dtype=torch.int64,
                          device="cuda")
        quotient_cuda._enqueue(
            lib, inp["main"], inp["aux"], inp["points"], inp["shift"],
            inp["trace_len"], inp["gen_inv"], inp["ch"], inp["ws"], out,
            torch.cuda.current_stream().cuda_stream)
        return out
    return run


def _edited(src, edits, path):
    """Write `src`'s text with `edits` applied to `path`, beside a copy of
    the header it includes."""
    text = src.read_text()
    for a, b in edits:
        if a not in text:
            raise ValueError(f"{src}: {a!r} not found")
        text = text.replace(a, b)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    header = src.parent / "goldilocks.cuh"
    (path.parent / header.name).write_bytes(header.read_bytes())


def _build(job):
    """Build a job: an interpreter source (a path), the generated units
    (a list, csrc/ included) or edited units with their own directory."""
    if isinstance(job, Path):
        return tip5_cuda.build(job)
    if isinstance(job, list):
        return quotient_cuda.build(job)
    units, vdir = job
    return tip5_cuda.build_parts(units, include_dirs=(vdir,))


def _report(so):
    rep = quotient_cuda.ptxas_report(so)[quotient_cuda.KERNEL]
    rep["build_s"] = round(tip5_cuda.BUILD_SECONDS.get(so, 0.0), 1)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="an interpreter csrc/quotient.cu to time (3a5ce70's)")
    ap.add_argument("--targets",
                    default=str(tape_codegen.SEGMENT_INSTRUCTIONS),
                    help="segment sizes of the generated source, e.g. "
                         "50,100,200")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rows", default=",".join(str(r) for r in ROWS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out",
                    default="triton_vm_tpu_torch/_build/quotient_probe")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tape = aircomp.quotient_row_tape()
    out = Path(args.out)
    jobs = {}
    for i, src in enumerate(args.src):
        jobs[f"old{i} {src}"] = Path(src)
        if args.variants:
            vdir = out / f"old{i}"
            _edited(Path(src), CUT_EDITS, vdir / "quotient.cu")
            jobs[f"old{i} register file cut to 16 words"] = (
                vdir / "quotient.cu")
    targets = [int(v) for v in args.targets.split(",")]
    for t in targets:
        jobs[f"new segments of {t}"] = quotient_cuda.sources(tape, t)
    if args.variants:
        for j, (name, edits) in enumerate(NEW_VARIANT_EDITS.items()):
            vdir = out / f"new_variant{j}"
            _edited(quotient_cuda._SRC, edits, vdir / "quotient.cu")
            units = []
            for k, text in enumerate(tape_codegen.cuda_sources(
                    tape, targets[0], quotient_cuda.PARTS)):
                units.append(vdir / f"quotient_{k}.cu")
                units[-1].write_text(text)
            jobs[f"new segments of {targets[0]}, {name}"] = (units, vdir)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(_build, src) for k, src in jobs.items()}
        built = {}
        for k, f in futs.items():
            try:
                built[k] = f.result()
            except RuntimeError as e:  # reported; the other builds go on
                print(f"BUILD FAILED {k}: {str(e)[-3000:]}", flush=True)
    print(f"built {len(built)} sources in {time.time() - t0:.1f} s "
          "(started together)", flush=True)
    fns, reports = {}, {}
    for name, so in built.items():
        new = name.startswith("new")
        reports[name] = (_report(so) if new else tip5_cuda.ptxas_report(
            so, (quotient_cuda.KERNEL,)).get(quotient_cuda.KERNEL))
        sass = tip5_probe.sass_summary(so)
        reports[name]["sass"] = {
            "functions": len(sass),
            **{k: sum(v[k] for v in sass.values())
               for k in ("insns", "LDL", "STL")},
            "largest": max(v["insns"] for v in sass.values())}
        print(name, json.dumps(reports[name]), flush=True)
        fns[name] = _new_launcher(so) if new else _old_launcher(so)
    rng = np.random.default_rng(3)
    bad = 0
    checked = [n for n in fns if "cut" not in n]
    for label, kw in {"2^16": {}, "edge values": dict(edge=True),
                      "permuted aux": dict(permuted_aux=True),
                      "halo 8": dict(halo=8)}.items():
        inp = qi.make_inputs(rng, 1 << 16, "cuda", **kw)
        want = qi.plain(inp)
        for name in checked:
            if not torch.equal(fns[name](inp), want):
                print(f"MISMATCH {name} at {label}", flush=True)
                bad += 1
        del inp, want
    print(f"held against the plain version at 2^16: {len(checked)} builds, "
          f"{bad} mismatches", flush=True)
    turns = [n for n in fns if "cut" not in n]
    order = turns + turns[::-1]
    results = {}
    for rows in (int(v) for v in args.rows.split(",")):
        inp = qi.make_inputs(rng, rows, "cuda", permuted_aux=True,
                             device_draw=True)
        reps = 1 if rows >= 1 << 21 else 3 if rows >= 1 << 19 else 10
        times = {n: [] for n in fns}
        for _ in range(args.rounds):
            for n in order:
                times[n].append(_ms(lambda: fns[n](inp), reps))
            for n in fns:
                if n not in turns:
                    times[n].append(_ms(lambda: fns[n](inp), reps))
        label = f"2^{rows.bit_length() - 1}"
        results[label] = {n: sorted(t)[len(t) // 2] for n, t in
                          times.items()}
        print(label, json.dumps({n: [round(v, 4) for v in t]
                                 for n, t in times.items()}), flush=True)
        del inp
        torch.cuda.empty_cache()
    out.mkdir(parents=True, exist_ok=True)
    (out / "quotient_turns.json").write_text(json.dumps(
        dict(medians_ms=results, ptxas=reports), indent=1))
    print("medians (ms):", json.dumps(results))
    print("mismatches", bad)
    return 1 if bad or len(built) < len(jobs) else 0


if __name__ == "__main__":
    sys.exit(main())
