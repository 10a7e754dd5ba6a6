"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The cell
(a `workloads` entry of BENCHMARK.json) names a configuration
(configs/<config>.json and its frozen files) and a traffic mix
(traffic/<traffic>.json). A run:

1. set-up: loads the inputs, builds the port's kernels (their build
   directories sit inside the checkout), builds the AIR and the prover's
   tables, and runs the traffic's warm-up steps;
2. the window: a closed loop of steps, one proof at a time, each
   `triton_vm_tpu_torch.prove` (the VM trace and `Stark.prove`, the card
   synchronised) and `triton_vm_tpu_torch.verify` of that proof, each
   with its own prover seed; steps start until --seconds have passed, and
   the step in flight when the window closes finishes and counts;
3. the check: once the window has closed and the program's state is
   freed, the plain reference (reference/) judges the window's proofs
   layer by layer against the claim it works out itself;
4. prints the metrics the cell reports (metrics/<name>.py reads each),
   the limits of every number compared, and one JSON line last.

With --trace 1 the window runs under `torch.profiler` (CUDA activity),
with the port's stage spans and its kernels' launch shapes recorded, and
the per-layer metrics are reported instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with few host threads: the prover is host-bound, and with
# eight intra-op threads on the card host's eight cores its steps ran
# slower and its runs spread wider than with four or one. Set before numpy
# and torch load their thread pools.
HOST_THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
# modules that may not be loaded in the process that prints the result,
# compared by their whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "triton_vm_tpu")
# each number compared must not exceed its limit: every one is exact
LIMITS = {"steps_failed": 0, "program_verify_failed": 0,
          "repeated_proofs": 0, "claim_output": 0, "decode": 0,
          "height": 0, "ood_quotient": 0, "ldt": 0, "merkle": 0, "deep": 0,
          "complete": 0}


@dataclass
class Step:
    index: int
    prove_s: float = 0.0
    verify_s: float = 0.0
    start_ns: int = 0
    proved_ns: int = 0
    end_ns: int = 0
    proof: np.ndarray | None = None                # the proof's words
    error: str | None = None
    program_verified: bool = False
    spans: dict = field(default_factory=dict)   # top-level stage seconds


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    cell: dict
    inputs: object
    trace: bool
    setup_s: float = 0.0
    steps: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    device_trace: object = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     + ", ".join(c["name"] for c in bench["workloads"]))


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def read_metric(name: str, run: Run, metrics_dir: Path = HERE / "metrics"):
    """metrics/<name>.py's `read(run)`: a number, or None where it finds
    nothing to read."""
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"),
        metrics_dir / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def _environment():
    """The port reads TVM_MESH and TVM_TRACE: a cell runs one card and
    prints no markers. (The port builds its kernels into
    triton_vm_tpu_torch/_build/ and native/_build/, inside the checkout.)"""
    for var in ("TVM_MESH", "TVM_TRACE"):
        os.environ.pop(var, None)


def _non_determinism(tvm, nondet):
    if nondet is None:
        return None
    return tvm.NonDeterminism(
        individual_tokens=list(nondet["individual_tokens"]),
        digests=[tuple(d) for d in nondet["digests"]],
        ram={k: v for k, v in nondet["ram"]})


def _stark(tvm, stated: dict, device, override: dict | None):
    params = dict(stated, **(override or {}))
    return tvm.Stark(security_level=params["security_level"],
                     log2_ldt_expansion_factor=params[
                         "log2_expansion_factor"],
                     soundness=params["soundness"], device=device)


def _synchronize(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _expectations(tvm, stark, inputs, device):
    """The traffic's low-degree test and cache-or-JIT decision hold."""
    from triton_vm_tpu_torch import config

    h = 1 << inputs.log2_padded_height
    ldt, *_, ldt_dom = stark.derive_domains(h)
    kind = "stir" if isinstance(ldt, tvm.Stir) else "fri"
    want = inputs.traffic["ldt"]
    if kind != want:
        raise SystemExit(f"the traffic expects {want} at 2^"
                         f"{inputs.log2_padded_height}, the Stark picks "
                         f"{kind}")
    if device.type == "cuda":
        decision = config.cache_lde_trace(ldt_dom.length, device)
        lde = "jit" if decision is config.CacheDecision.JIT else "cached"
        if lde != inputs.traffic["lde"]:
            raise SystemExit(f"the traffic expects the {inputs.traffic['lde']}"
                             f" LDE, the port decides {lde}")


def _step(tvm, torch, stark, claim, program, inputs, index, seed, device,
          profile: bool) -> Step:
    from triton_vm_tpu_torch.utils import profiler

    step = Step(index)
    nondet = _non_determinism(tvm, inputs.non_determinism)
    if profile:
        profiler.start(f"step {index}")
    step.start_ns = time.time_ns()
    t0 = time.perf_counter()
    try:
        proof = tvm.prove(stark, claim, program, nondet, seed=seed)
        _synchronize(torch, device)
    except Exception as e:  # a prove that raises counts in `failed`
        step.error = f"prove: {type(e).__name__}: {e}"
        proof = None
    t1 = time.perf_counter()
    step.proved_ns = time.time_ns()
    if profile:
        step.spans = {name: s for name, s, _ in profiler.finish().spans()}
    step.prove_s = t1 - t0
    if proof is not None:
        step.program_verified = tvm.verify(stark, claim, proof)
        _synchronize(torch, device)
    step.verify_s = time.perf_counter() - t1
    step.end_ns = time.time_ns()
    if proof is not None:
        step.proof = np.asarray(proof.words, np.uint64)
    return step


def _window(tvm, torch, stark, claim, program, inputs, seed, seconds,
            device, run: Run):
    from . import traffic

    start = time.perf_counter()
    index = 0
    while True:
        run.steps.append(_step(tvm, torch, stark, claim, program, inputs,
                               index, traffic.step_seed(seed, index),
                               device, run.trace))
        index += 1
        if time.perf_counter() - start >= seconds:
            break


def _traced_window(tvm, torch, stark, claim, program, inputs, seed,
                   seconds, device, run: Run):
    from triton_vm_tpu_torch.ops import (ntt_cuda, quotient_cuda, tip5_cuda,
                                         tip5_kernel)
    from triton_vm_tpu_torch.utils import profiler

    from . import trace

    record = trace.Trace()
    activity = torch.profiler.ProfilerActivity
    # a CPU run (the tests) traces the host, so no device metric is read
    kinds = [activity.CUDA if device.type == "cuda" else activity.CPU]
    with torch.profiler.profile(activities=kinds) as prof:
        # the marker: the trace's first device operation, run between two
        # host readings, puts the device's timestamps on the host clock
        _synchronize(torch, device)
        before = time.time_ns()
        torch.ones(1 << 16, device=device).sum()
        _synchronize(torch, device)
        after = time.time_ns()
        with trace.SpanRecorder(profiler) as spans, trace.LaunchRecorder(
                tip5_cuda, tip5_kernel, ntt_cuda, quotient_cuda) as launches:
            _window(tvm, torch, stark, claim, program, inputs, seed, seconds,
                    device, run)
        _synchronize(torch, device)
    t_read = time.perf_counter()
    record.ops, record.offset_ns, record.marker_slack_ns = \
        trace.on_host_clock(prof.profiler.kineto_results, before, after)
    record.read_s = time.perf_counter() - t_read
    record.spans = spans.spans
    record.launches = launches.launches
    run.device_trace = record


def reference_check(run: Run) -> dict:
    """The numbers compared, each against its limit in LIMITS."""
    from .reference import assembler, verifier
    from .reference.proof_stream import Claim

    inputs = run.inputs
    words = assembler.assemble(inputs.program_text)
    claim = Claim(verifier.program_digest(words),
                  list(inputs.public_input), list(inputs.output))
    params = verifier.Parameters(
        security_level=inputs.stark["security_level"],
        log2_expansion_factor=inputs.stark["log2_expansion_factor"],
        soundness=inputs.stark["soundness"])
    expected = reference_output(inputs)
    counts = dict.fromkeys(LIMITS, 0)
    counts["claim_output"] = int(expected is not None
                                 and expected != list(inputs.output))
    proofs = [s.proof.tobytes() for s in run.steps if s.proof is not None]
    counts["repeated_proofs"] = len(proofs) - len(set(proofs))
    counts["program_verify_failed"] = sum(
        1 for s in run.steps if s.proof is not None and not s.program_verified)
    bad = {s.index for s in run.steps
           if s.proof is None or not s.program_verified}
    checked = [s for s in run.steps if s.proof is not None]
    for step in checked:
        result = verifier.check(step.proof.tolist(), claim,
                                1 << inputs.log2_padded_height, params)
        for layer, failed in result.items():
            counts[layer] += failed
        if any(result.values()):
            bad.add(step.index)
    counts["steps_failed"] = len(bad)
    counts["proofs_checked"] = len(checked)
    return counts


def reference_output(inputs) -> list | None:
    """The output the configuration's program must give, worked out by the
    reference where it has a plain model of the program (None where the
    frozen output stands on its own)."""
    from .reference import programs

    if inputs.model is None:
        return None
    return programs.MODELS[inputs.model](inputs.public_input)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: Path = HERE.parent,
             stark_override: dict | None = None, inputs=None) -> dict:
    """One run of `cell`; returns the result line as a dict (the fields
    the command prints last). `stark_override` changes the program's
    Stark parameters, never the reference's: the control."""
    from . import inputs as inputs_mod
    from . import traffic

    _environment()
    import torch

    torch.set_num_threads(HOST_THREADS)

    import triton_vm_tpu_torch as tvm

    inputs = inputs or inputs_mod.load(cell, root / "port_bench")
    dev = torch.device(device)
    run = Run(cell, inputs, trace)
    program = tvm.triton_program(inputs.program_text)
    claim = (tvm.Claim.about_program(program).with_input(inputs.public_input)
             .with_output(inputs.output))
    stark = _stark(tvm, inputs.stark, device, stark_override)
    if dev.type == "cuda":
        from triton_vm_tpu_torch.ops import ntt_cuda, quotient_cuda, tip5_cuda

        tip5_cuda.load()
        ntt_cuda.load()
        quotient_cuda.load()
    if stark_override is None:
        # the control changes the Stark on purpose, and with it maybe the
        # low-degree test the traffic expects
        _expectations(tvm, stark, inputs, dev)
    for i in range(inputs.traffic.get("warmup_steps", 0)):
        warm = _step(tvm, torch, stark, claim, program, inputs, -1 - i,
                     traffic.warmup_seed(seed, i), dev, False)
        if warm.error:
            raise RuntimeError(f"warm-up step failed: {warm.error}")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - T_START

    window = _traced_window if trace else _window
    window(tvm, torch, stark, claim, program, inputs, seed, seconds, dev, run)
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    # free the program's state before the reference runs on the host
    del stark, program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    counts = reference_check(run)
    check_s = time.perf_counter() - t_check

    metrics = {}
    for m in metrics_of(bench, cell, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = len(run.steps) > 0 and all(
        counts[k] <= limit for k, limit in LIMITS.items())
    result = {
        "correct": correct,
        "attempted": len(run.steps),
        "failed": counts["steps_failed"],
        "metrics": metrics,
        "device": device_record(torch, dev, run),
    }
    if trace and run.device_trace is not None:
        from . import breakdown

        result["breakdown"] = breakdown.breakdown(run)
        result["trace"] = breakdown.alignment(run)
    result["reference_s"] = check_s
    result["steps"] = [[s.prove_s, s.verify_s] for s in run.steps]
    if dev.type == "cuda":
        from triton_vm_tpu_torch.ops import tip5_cuda

        # nonzero only where this run built the kernels: the first run in
        # a checkout, whose set-up is reported apart
        result["kernel_build_s"] = sum(tip5_cuda.BUILD_SECONDS.values())
    result["errors"] = [s.error for s in run.steps if s.error][:3]
    result["checks"] = {k: {"value": counts[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    result["checks"]["proofs_checked"] = {
        "value": counts["proofs_checked"], "limit": None}
    return result


def device_record(torch, dev, run: Run) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace and run.device_trace is not None:
        from . import breakdown

        out["busy_s"], out["window_s"] = breakdown.busy_and_window(run)
    limit = power_limit()
    if limit is not None:
        out["power_limit_w"] = limit
    return out


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = Path.cwd()
    bench = load_benchmark(root)
    cell = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda", root)
    found = forbidden_modules()
    if found:
        print("port_bench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
