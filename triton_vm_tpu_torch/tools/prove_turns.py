"""Whole proves on the card, repeated in one process, to time two
checkouts in turns.

After a warm-up prove (fibonacci input 85), each path of `--paths` is
proven `--repeat` times with `prove_program` on the card, seed
bytes(range(32)). Each prove prints one JSON line: the path, its host
wall-clock (s), the prover's stage spans (utils/profiler), the card's peak
device memory (GiB) and the proof's length. Paths:

- spin_65536: the spin program at padded height 2^16 (cached LDE);
- mesh_spin_65536: the same under TVM_MESH=4 (four shards, several on one
  card of a one-card host), its proof held against spin_65536's when both
  ran;
- recursive_verifier: BASELINE config 5's verifier core (one revealed
  index) at padded height 2^17, its inner proof and build done once,
  outside the timed proves.

It names nothing of a kernel module, so a copy of this file in an older
checkout's tools/ times that checkout. Run it from each checkout's root,
alternating which goes first:

    python3 -m triton_vm_tpu_torch.tools.prove_turns \\
        --paths spin_65536,mesh_spin_65536,recursive_verifier --repeat 2

Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = bytes(range(32))
PATHS = ("spin_65536", "mesh_spin_65536", "recursive_verifier")
MESH_SHARDS = 4


def prove(label, program, public_input, non_determinism=None):
    """One prove on the card: (record, proof)."""
    import torch

    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.utils import profiler

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    profiler.start(label)
    t0 = time.perf_counter()
    _, _, proof = tvm.prove_program(program, public_input, non_determinism,
                                    seed=SEED, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    spans = profiler.finish().spans()
    return {"path": label, "prove_s": round(seconds, 4),
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
            "words": len(proof.words),
            "stages_s": {name: round(sec, 4) for name, sec, _ in spans}}, proof


def recursive_verifier_inputs():
    """Config 5's `combined` program, its public input and a maker of its
    non-determinism (a prove consumes what it is given)."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.models import baseline
    from triton_vm_tpu_torch.vm.machine import NonDeterminism

    stark = tvm.Stark(device="cuda")
    claim, proof = baseline.recursive_verifier_inner(stark)
    built = baseline.recursive_verifier_fixture(stark, num_queries=1,
                                                inner=(claim, proof))
    nd = built.non_determinism
    return built.programs["combined"], [], lambda: NonDeterminism(
        ram=dict(nd.ram), digests=list(nd.digests))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of: " + ", ".join(PATHS))
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--tag", default="", help="a label for every line")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"unknown paths: {sorted(set(paths) - set(PATHS))}")

    from triton_vm_tpu_torch.models import example_programs as ex

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    rec, _ = prove("warm-up fib_1024", ex.fibonacci(), [85])
    print(json.dumps({"tag": args.tag, **rec, "since_start_s": round(
        time.perf_counter() - t0, 1)}), flush=True)
    spin, iterations = ex.spin(16)
    proofs = {}
    for path in paths:
        program, public_input, nd = (
            recursive_verifier_inputs() if path == "recursive_verifier"
            else (spin, [iterations], lambda: None))
        saved = os.environ.get("TVM_MESH")
        if path == "mesh_spin_65536":
            os.environ["TVM_MESH"] = str(MESH_SHARDS)
        try:
            for _ in range(args.repeat):
                rec, proof = prove(path, program, public_input, nd())
                proofs.setdefault(path, proof.words)
                print(json.dumps({"tag": args.tag, **rec}), flush=True)
        finally:
            if saved is None:
                os.environ.pop("TVM_MESH", None)
            else:
                os.environ["TVM_MESH"] = saved
    if {"spin_65536", "mesh_spin_65536"} <= proofs.keys():
        if proofs["spin_65536"] != proofs["mesh_spin_65536"]:
            print("the mesh proof differs from spin_65536's", flush=True)
            return 1
        print("the mesh proof equals spin_65536's word for word", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
