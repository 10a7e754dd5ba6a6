"""The port's benchmark entry point, the counterpart of the JAX package's
`bench.py`: prover wall-clock of one BASELINE.md config on the card.

    python -m triton_vm_tpu_torch.bench                  # fib_1024
    TVM_BENCH=spin_65536 TVM_BENCH_SOL=1 python -m triton_vm_tpu_torch.bench

On the CPU, from Python: `main(device="cpu")`. The command line always
proves on the card and exits non-zero without one (`Stark` raises).

It prints JSON lines on stdout, each flushed; the LAST line is the result.
Its keys are bench.py's, with bench.py's meanings:
`metric` (bench.py's name of the config, `..._wall_clock`), `value` (the
warm prove's seconds, the cold one's until a warm prove ran), `unit`,
`vs_baseline` (anchor seconds / value; 0.0 for a config without an anchor),
`baseline_source`, `cold_prove_s`, `ramp_s`, `stages` (the warm prove's
top-level profiler spans), `sol`, `verify_s`; `partial` marks the line
printed after the cold prove, `incomplete` and `phase_reached` the
watchdog's line when the budget runs out before any prove ended.

Phases:
1. ramp: the CUDA context is created and the Tip5 kernels, K3 (the
   quotient), K4 (the NTT) and the randomizer kernel are built
   (`tip5_cuda.load`, `quotient_cuda.load`, `ntt_cuda.load`,
   `stdrng_cuda.load`) before the timed window;
   `ramp_s` is their seconds;
2. witness: the config (`models/baseline.config`; config 5 proves its
   inner proof here, on the same device) and its execution trace;
3. cold prove, the process's first: it builds the AIR (the `setup` span)
   and the device's constant tables; a `partial` line follows;
4. warm prove, under the profiler, if the budget holds it: a warm prove
   takes at most the cold one's time less the cold `setup` span;
5. speed of light, with TVM_BENCH_SOL=1 (`sol`): K1 on 2^18 states, K2 on
   2^18 row-major rows of 379, `ntt.lde` of 379 x 4096 by 4, each timed
   with CUDA events after a warm-up call. `*_hbm_gbps` are the bytes
   bench.py counts (one read of the input, one write of the output) over
   the time, and `*_pct_of_hbm_sol` their share of the HBM peak,
   TVM_HBM_GBPS (default 3350, the H100 SXM's 3.35 TB/s). That share is
   not a kernel's bound: K1 is bound by its 32-bit multiplies (PERF.md
   §6), so it reads low against HBM;
6. verify: the proof must verify.

The card is synchronised before every clock read around a prove and the
verify. A watchdog prints the best line known (or an `incomplete` one)
15 s before TVM_BENCH_BUDGET_S (default 540) seconds have passed since
`main` began, and phases that the rest of the budget cannot hold are
skipped. Any error ends the process non-zero, watchdog line or not.
On stderr: the card, and the kernel launches (K1, K2, K3, K4 and the
randomizer kernel) of the proves and the verify; with TVM_PROFILE=1 also
the cold and the warm prove's profiler reports.
Environment variables are read by `main`, never at import.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from .fields.bfe import P
from .models import baseline
from .ops import gf, ntt, ntt_cuda, quotient_cuda, stdrng_cuda, tip5_cuda
from .stark.proof_stream import Claim
from .stark.prover import Stark
from .utils import profiler
from .vm.machine import VM, PublicInput

SEED = bytes(range(32))
# bench.py's configs and their metrics (bench.py:136-163); spin_<n> is
# spin at padded height 2^floor(log2 n)
METRICS = {
    "fib_1024": "prove_fib_padded_height_1024",
    "factorial_4096": "prove_factorial_padded_height_4096",
    "spin_65536": "prove_spin_padded_height_65536",
    "hash_chain": "prove_hash_chain_hash_table_dominated",
    "merkle_auth": "prove_merkle_auth_path",
    "recursive_verifier": "prove_recursive_verifier",
}
# Anchors (s) derived from the Rust reference's operation counts priced at
# single-core Rust throughputs (BASELINE.md "Derived absolute anchors";
# bench.py:196-206); not a measurement of any device
ANCHORS_S = {"fib_1024": 0.5, "spin_65536": 1.6}
ANCHOR_SOURCE = ("BASELINE.md derived-anchor table "
                 "(op counts x published per-op throughputs)")
HBM_GBPS = 3350.0  # H100 SXM data sheet
SOL_BATCH = 1 << 18
SOL_ROW_WIDTH = 379
SOL_LDE_SHAPE = (379, 1 << 12)


def metric(name: str) -> str:
    """The metric of bench.py's config `name`; exits, listing the names,
    for a name bench.py does not know."""
    if name in METRICS:
        return METRICS[name] + "_wall_clock"
    if name.startswith("spin_") and name[5:].isdigit() and int(name[5:]):
        return (f"prove_spin_padded_height_{baseline.padded_height(name)}"
                "_wall_clock")
    raise SystemExit(f"unknown TVM_BENCH={name!r}; "
                     f"choose from {sorted(METRICS)}")


def result_line(name: str, seconds: float, **extra) -> dict:
    """bench.py's line for a prove of config `name` that took `seconds`."""
    anchor = ANCHORS_S.get(name)
    line = {
        "metric": metric(name),
        "value": round(seconds, 3),
        "unit": "s",
        "vs_baseline": round(anchor / seconds, 4) if anchor else 0.0,
        "baseline_source": ANCHOR_SOURCE if anchor else "none",
    }
    line.update(extra)
    return line


class _Run:
    """The phase a run has reached and its best line so far, shared with
    the watchdog thread."""

    def __init__(self, metric_name: str, budget_s: float):
        self.t0 = time.perf_counter()
        self.budget_s = budget_s
        self.metric = metric_name
        self.phase = "start"
        self.line = None
        self.final = False
        self.lock = threading.Lock()
        self.done = threading.Event()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def fits(self, seconds: float, margin_s: float) -> bool:
        """Whether `seconds` more end `margin_s` before the budget does."""
        return self.elapsed() + seconds < self.budget_s - margin_s

    def emit(self, line: dict, final: bool = False):
        with self.lock:
            self.line = line
            self.final = final
            print(json.dumps(line), flush=True)

    def watchdog(self):
        """Print what is known 15 s before the budget ends, unless the
        run ended first."""
        if self.done.wait(max(self.budget_s - 15.0 - self.elapsed(), 0.0)):
            return
        with self.lock:
            if self.final:
                return
            line = self.line
            if line is None:
                # not a prover measurement: a lower bound and the phase
                # the run was in when the budget ran out
                line = {"metric": self.metric,
                        "value": round(self.elapsed(), 3), "unit": "s",
                        "vs_baseline": 0.0, "incomplete": True,
                        "phase_reached": self.phase}
            print(json.dumps(line), flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn):
    """(seconds, fn()), the device synchronised before each clock read."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _launches() -> dict:
    """Every kernel's launches so far: K1 and K2, K3, K4, then the
    randomizer kernel."""
    return {**tip5_cuda.launches, **quotient_cuda.launches,
            **ntt_cuda.launches, **stdrng_cuda.launches}


def _ramp(device) -> float:
    """Create the CUDA context and build the Tip5 kernels, K3, K4 and the
    randomizer kernel; their seconds (0 on the CPU, where the kernels'
    plain versions run)."""
    if device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    torch.empty(1, device=device)
    _sync(device)
    tip5_cuda.load()
    quotient_cuda.load()
    ntt_cuda.load()
    stdrng_cuda.load()
    return time.perf_counter() - t0


def _prove(stark, claim, aet, label):
    """One prove under the profiler: (seconds, proof, profile)."""
    profiler.start(label)
    try:
        seconds, proof = _timed(stark.device,
                                lambda: stark.prove(claim, aet, seed=SEED))
    finally:
        report = profiler.finish()
    return seconds, proof, report


def _seconds_per_call(device, fn, reps: int) -> float:
    """Mean seconds of fn() over `reps` calls after a warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    _sync(device)
    start.record(stream)
    for _ in range(reps):
        fn()
    stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def sol_figures(batch: int, t_perm: float, t_rows: float, t_lde: float,
                peak_gbps: float) -> dict:
    """bench.py's speed-of-light figures (bench.py:278-303) from the
    seconds of one K1 call on (16, batch) states, one K2 call on (batch,
    379) rows and one 4x LDE of 379 x 4096."""
    b = batch
    sol = {}
    gbps = 2 * 16 * b * 8 / t_perm / 1e9  # one read + one write of state
    sol["tip5_perms_per_s"] = round(b / t_perm)
    sol["tip5_ns_per_perm"] = round(1e9 * t_perm / b, 2)
    sol["tip5_hbm_gbps"] = round(gbps, 1)
    sol["tip5_pct_of_hbm_sol"] = round(100 * gbps / peak_gbps, 1)
    gbps = (b * 379 * 8 + b * 40) / t_rows / 1e9
    sol["row_sponge_rows_per_s"] = round(b / t_rows)
    sol["row_sponge_hbm_gbps"] = round(gbps, 1)
    sol["row_sponge_pct_of_hbm_sol"] = round(100 * gbps / peak_gbps, 1)
    limbs = 379 * (1 << 12) * 4
    sol["lde4x_limbs_per_s_379x4096"] = round(limbs / t_lde)
    return sol


def sol(device, peak_gbps: float = HBM_GBPS, batch: int = SOL_BATCH,
        reps: int = 3) -> dict:
    """The speed-of-light pass on `device` at bench.py's shapes (`batch`
    smaller only to try it on the CPU): `sol_figures` of the timed calls.
    The wrappers launch the kernels on a card, their plain versions on the
    CPU."""
    rng = np.random.default_rng(3)

    def field(shape):
        return gf.from_u64(rng.integers(0, P, shape, dtype=np.uint64),
                           device)

    states = field((16, batch))
    t_perm = _seconds_per_call(
        device, lambda: tip5_cuda.permutation(states), reps)
    del states
    rows = field((batch, SOL_ROW_WIDTH))
    t_rows = _seconds_per_call(
        device, lambda: tip5_cuda.sponge_absorb_rows(rows), reps)
    del rows
    cols = field(SOL_LDE_SHAPE)
    t_lde = _seconds_per_call(device, lambda: ntt.lde(cols, 4, 1, 7), reps)
    return sol_figures(batch, t_perm, t_rows, t_lde, peak_gbps)


def main(argv=None, device="cuda"):
    """Benchmark the config TVM_BENCH (default fib_1024) on `device`."""
    argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Configured by TVM_BENCH, TVM_BENCH_SOL, TVM_BENCH_BUDGET_S, "
               "TVM_HBM_GBPS and TVM_PROFILE.").parse_args(argv)
    which = os.environ.get("TVM_BENCH", "fib_1024")
    run = _Run(metric(which), float(os.environ.get("TVM_BENCH_BUDGET_S",
                                                   "540")))
    watchdog = threading.Thread(target=run.watchdog, daemon=True)
    watchdog.start()
    try:
        _bench(run, which, device)
    finally:
        run.done.set()
        watchdog.join()


def _bench(run, which, device):
    stark = Stark(device=device)  # raises for a card that is not there
    dev = stark.device
    print(f"bench {which} on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}",
          file=sys.stderr, flush=True)
    run.phase = "ramp"
    ramp_s = _ramp(dev)

    run.phase = "witness"
    program, public_input, non_determinism = baseline.config(which, dev)
    aet, output = VM.trace_execution(program, PublicInput(public_input),
                                     non_determinism)
    claim = (Claim.about_program(program)
             .with_input(public_input).with_output(output))

    run.phase = "cold_prove"
    launches0 = _launches()
    cold_s, proof, cold = _prove(stark, claim, aet, "cold prove " + which)
    timings = dict(cold_prove_s=round(cold_s, 3), ramp_s=round(ramp_s, 1))
    run.emit(result_line(which, cold_s, partial=True, **timings))
    profile = os.environ.get("TVM_PROFILE") == "1"
    if profile:
        print(cold, file=sys.stderr, flush=True)

    # a warm prove takes at most the cold one's time less its AIR build
    setup_s = sum(s for name, s, _ in cold.spans() if name == "setup")
    if run.fits(cold_s - setup_s, 20.0):
        run.phase = "warm_prove"
        warm_s, proof, report = _prove(stark, claim, aet, "prove " + which)
        report = (report.with_cycle_count(aet.height_of_table("processor"))
                  .with_padded_height(aet.padded_height()))
        if profile:
            print(report, file=sys.stderr, flush=True)
        stages = {name: round(s, 3) for name, s, _ in report.spans()}
        run.emit(result_line(which, warm_s, stages=stages, **timings))

    sol_launches = dict.fromkeys(launches0, 0)
    if os.environ.get("TVM_BENCH_SOL") == "1" and run.fits(60.0, 20.0):
        run.phase = "sol"
        before = _launches()
        peak = float(os.environ.get("TVM_HBM_GBPS", HBM_GBPS))
        figures = sol(dev, peak_gbps=peak)
        sol_launches = {k: v - before[k] for k, v in _launches().items()}
        run.emit(dict(run.line, sol=figures))

    if run.fits(30.0, 10.0):
        run.phase = "verify"
        verify_s, ok = _timed(dev, lambda: stark.verify(claim, proof))
        if not ok:
            raise RuntimeError(f"{which}: the proof did not verify")
        with run.lock:
            run.line = dict(run.line, verify_s=round(verify_s, 3))
    run.emit(run.line, final=True)
    launches = {k: v - launches0[k] - sol_launches[k]
                for k, v in _launches().items()}
    print(f"bench {which} kernel launches (proves and verify): "
          f"{json.dumps(launches)}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
