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

Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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
                               ntt._unscale(n_in, off, "cuda"))
    if kind == "lde":
        x = ntt._rows_plain(x, inv_root, n_in, None,
                            ntt._unscale(n_in, 1, "cuda"))
        off = 7
    return ntt._rows_plain(x, bfe.primitive_root_of_unity(length), length,
                           ntt._coset_scale(n_in, off, "cuda"))


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
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.stage_peak:
        return stage_peak(args.stage_peak)
    return memory() if args.memory else check_and_time()


if __name__ == "__main__":
    sys.exit(main())
