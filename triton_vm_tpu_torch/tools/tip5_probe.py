"""What a build of csrc/tip5.cu compiles to, and how fast it runs.

For each Tip5 source named (the package's own by default) this builds the
library as the port does, prints ptxas's registers, spills and shared
memory a kernel with its resident warps an SM, and counts the SASS
instructions of each kernel by class, for the whole kernel and for each
loop (the innermost loop of `permute()` is one Tip5 round). With --time
it then times K1 and K2 on the card at the main path's shapes, every
source in turn and back
(A, B, B, A for two sources) on the same inputs, after checking each
source's output against the plain torch version.

    python3 -m triton_vm_tpu_torch.tools.tip5_probe
    python3 -m triton_vm_tpu_torch.tools.tip5_probe --time \\
        --src old/triton_vm_tpu_torch/csrc/tip5.cu --src NEW

NEW stands for the package's own source. Needs a card and the CUDA
toolkit; writes the SASS listings under --out.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from ..ops import tip5_cuda

CLASSES = ("IMAD", "IMAD.WIDE", "IMAD.HI", "IMAD as move/add/shift",
           "IADD3", "LDS", "SEL/branch", "other")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def op_class(op: str) -> str:
    if op.startswith("IMAD.WIDE"):
        return "IMAD.WIDE"
    if op.startswith("IMAD.HI"):
        return "IMAD.HI"
    if op.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")):
        return "IMAD as move/add/shift"
    base = op.split(".")[0]
    if base == "IMAD":
        return "IMAD"
    if base == "IADD3":
        return "IADD3"
    if base == "LDS":
        return "LDS"
    if base in ("SEL", "BRA", "BSSY", "BSYNC", "ISETP"):
        return "SEL/branch"
    return "other"


def resident_warps(registers: int, threads: int = 128, smem: int = 0) -> int:
    """Warps a Hopper SM holds at once for a kernel of `registers` a
    thread and blocks of `threads` (the occupancy calculator's rule:
    registers allocated in units of 256 a warp out of 65,536, at most 64
    warps and 32 blocks an SM, 228 KB of shared memory with 1 KB held
    back a block)."""
    warps_per_block = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65536 // per_warp // warps_per_block, 32,
                 64 // warps_per_block, 228 * 1024 // (smem + 1024))
    return blocks * warps_per_block


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(f"cuobjdump not found in {cands}")


def parse_sass(text: str) -> dict:
    """SASS listing -> {kernel: [(address, opcode, operands)], ...} with
    each kernel's labels resolved to addresses."""
    kernels, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((k for k in tip5_cuda.KERNELS if k in m.group(1)),
                        m.group(1))
            cur = kernels.setdefault(name, {"insns": [], "labels": {}})
            labels = cur["labels"]
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur["insns"].append((addr, m.group(3), m.group(4)))
    return kernels


def count(insns) -> dict:
    by_class = collections.Counter(op_class(op) for _, op, _ in insns)
    by_op = collections.Counter(op.split(".")[0] for _, op, _ in insns)
    return {"total": len(insns),
            "classes": {c: by_class.get(c, 0) for c in CLASSES},
            "opcodes": dict(by_op.most_common())}


def loops(kernel) -> list:
    """Each backward branch as a loop [target, branch]: its instruction
    counts, innermost (shortest) first."""
    insns, labels = kernel["insns"], kernel["labels"]
    out = []
    for addr, op, args in insns:
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(args)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            body = [i for i in insns if target <= i[0] <= addr]
            out.append({"from": hex(target), "to": hex(addr), **count(body)})
    return sorted(out, key=lambda x: x["total"])


def sass_summary(so: Path, out_dir: Path | None = None) -> dict:
    """Per function of a built library's SASS (cuobjdump), its
    instructions and its local-memory loads and stores (LDL, STL: a stack
    array or spills); the listing is written to out_dir if given."""
    sass = subprocess.run([cuobjdump(), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{Path(so).stem}.sass").write_text(sass)
    out = {}
    for name, k in parse_sass(sass).items():
        ops = collections.Counter(op.split(".")[0] for _, op, _ in k["insns"])
        out[name] = {"insns": len(k["insns"]), "LDL": ops.get("LDL", 0),
                     "STL": ops.get("STL", 0)}
    return out


def describe(src: Path, out_dir: Path) -> dict:
    so = tip5_cuda.build(src)
    sass = subprocess.run([cuobjdump(), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{so.stem}.sass").write_text(sass)
    report = tip5_cuda.ptxas_report(so)
    result = {"source": str(src), "library": so.name, "kernels": {}}
    for name, k in parse_sass(sass).items():
        rec = dict(report.get(name, {}))
        if "registers" in rec:
            rec["resident_warps_per_sm"] = resident_warps(
                rec["registers"], smem=rec.get("smem", 0))
        rec["sass"] = count(k["insns"])
        rec["loops"] = loops(k)
        result["kernels"][name] = rec
    return result


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


def _raise_if(lib, rc):
    if rc != 0:
        raise RuntimeError(f"launch failed: "
                           f"{lib.tip5_error_string(rc).decode()} ({rc})")


def time_in_turns(sources, rounds=2, seed=7):
    """ms per launch of K1 and K2 for each source, timed in turns on the
    same inputs; each source's output is first held against the plain
    version."""
    import numpy as np
    import torch

    from ..fields.bfe import P
    from ..ops import gf

    libs = [tip5_cuda.bind(tip5_cuda.build(s)) for s in sources]
    rng = np.random.default_rng(seed)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for b in (1 << 17, 1 << 10):
        s = gf.from_u64(rng.integers(0, P, (16, b), dtype=np.uint64), "cuda")
        out = torch.empty_like(s)

        def k1(lib, s=s, out=out):
            rc = lib.tip5_permutation_launch(s.data_ptr(), out.data_ptr(),
                                             s.shape[1], stream)
            _raise_if(lib, rc)
            return out

        cases.append((f"K1 B=2^{b.bit_length() - 1}", k1,
                      lambda s=s: tip5_cuda.permutation_plain(s),
                      200 if b > 1024 else 2000))
    b = 1 << 18
    for n in (379, 273, 15):
        rows = gf.from_u64(rng.integers(0, P, (n, b), dtype=np.uint64),
                           "cuda").T
        out = torch.empty((5, b), dtype=torch.int64, device="cuda")

        def k2(lib, rows=rows, out=out):
            rc = lib.tip5_sponge_rows_launch(
                rows.data_ptr(), rows.shape[1], rows.shape[0],
                rows.stride(0), rows.stride(1), out.data_ptr(), stream)
            _raise_if(lib, rc)
            return out

        cases.append((f"K2 2^18 x {n} column-major", k2,
                      lambda rows=rows: tip5_cuda.sponge_absorb_rows_plain(
                          rows), 5 if n > 100 else 40))
    results = {}
    for label, fn, plain, reps in cases:
        want = plain()
        for i, lib in enumerate(libs):
            if not torch.equal(fn(lib), want):
                raise AssertionError(f"{label}: source {sources[i]} "
                                     "disagrees with the plain version")
        order = list(range(len(libs)))
        turns = []
        for _ in range(rounds):
            turns += order + order[::-1]
        ms = collections.defaultdict(list)
        for i in turns:
            ms[i].append(time_ms(lambda: fn(libs[i]), reps))
        results[label] = {str(sources[i]): v for i, v in ms.items()}
        print(json.dumps({"case": label, "turns": [str(sources[i]) for i in
                                                   turns],
                          "ms": results[label]}), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=None,
                    help="a copy of tip5.cu; NEW names the package's own")
    ap.add_argument("--time", action="store_true",
                    help="also time K1 and K2 on the card, in turns")
    ap.add_argument("--out", default=str(tip5_cuda.BUILD_DIR / "sass"),
                    help="directory for the SASS listings")
    args = ap.parse_args(argv)
    sources = [tip5_cuda._SRC if s in (None, "NEW") else Path(s).resolve()
               for s in (args.src or [None])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for s in sources:
        print(json.dumps(describe(s, Path(args.out))), flush=True)
    if args.time:
        time_in_turns(sources)
    return 0


if __name__ == "__main__":
    sys.exit(main())
