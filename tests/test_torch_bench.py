"""The port's benchmark entry point (triton_vm_tpu_torch.bench) against the
JAX package's bench.py.

bench.py's names, metric strings, JSON keys and speed-of-light formulas are
read from bench.py itself: `bench.main()` runs with the JAX `Stark.prove`
and `verify` stubbed (no JAX proof is made), its kernels and numpy's draw
stubbed in the speed-of-light pass, and a clock that advances a fixed step
at each read of the main thread, so every time it measures is known. The
port's `main(device="cpu")` proves a small program (fibonacci input 7) in
place of the config, on the CPU."""

import contextlib
import io
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import triton_vm_tpu
from triton_vm_tpu.ops import ntt as jntt
from triton_vm_tpu.ops import tip5_kernel as jtip5_kernel
from triton_vm_tpu.stark.prover import Stark as JStark
from triton_vm_tpu_torch import bench as tbench
from triton_vm_tpu_torch.models import baseline
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.stark import prover as tprover
from triton_vm_tpu_torch.vm.machine import VM, PublicInput

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CLOCK_STEP = 2.0 ** -10  # exact in binary, so each step measures exactly
HBM_GBPS = "1000"  # TVM_HBM_GBPS for both benches
NAMES = ["fib_1024", "factorial_4096", "spin_65536", "spin_262144",
         "hash_chain", "merkle_auth", "recursive_verifier"]


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


class _Clock:
    """time for bench.py: perf_counter advances CLOCK_STEP at each read by
    the thread that made the clock."""

    def __init__(self, start):
        self.now = start
        self.owner = threading.current_thread()

    def perf_counter(self):
        if threading.current_thread() is self.owner:
            self.now += CLOCK_STEP
        return self.now


class _Draws:
    """numpy's default_rng for bench.py's speed-of-light pass: a (2, 2)
    array for any draw, so no full-size operand is made."""

    def __init__(self, seed):
        pass

    def integers(self, low, high, size=None, dtype=np.int64):
        return np.zeros((2, 2), dtype)


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def jax_lines():
    """The JSON lines bench.py prints for fib_1024 with TVM_BENCH_SOL=1,
    its proves and kernels stubbed; bench.py's watchdog line last."""
    out = io.StringIO()
    watchdog = bench._watchdog
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("TVM_BENCH", "fib_1024")
        mp.setenv("TVM_BENCH_SOL", "1")
        mp.setenv("TVM_HBM_GBPS", HBM_GBPS)
        mp.setenv("TVM_JAX_CACHE", "1")
        mp.delenv("TVM_PROFILE", raising=False)
        mp.setattr(bench, "_watchdog", lambda: None)
        mp.setattr(bench, "_STATE", {"phase": "import", "line": None,
                                     "final": False})
        mp.setattr(bench, "_BUDGET", 540.0)
        mp.setattr(bench, "_T0", 1024.0)
        mp.setattr(bench, "time", _Clock(1024.0))
        mp.setattr(JStark, "prove", lambda self, claim, aet, seed=None: None)
        mp.setattr(JStark, "verify", lambda self, claim, proof: True)
        mp.setattr(jtip5_kernel, "permutation", lambda s: s)
        mp.setattr(jtip5_kernel, "sponge_absorb_rows", lambda r: r)
        mp.setattr(jntt, "lde", lambda v, *args: v)
        mp.setattr(np.random, "default_rng", _Draws)
        bench.main()
        # the watchdog's line when no prove ended before the budget did
        mp.setattr(bench, "_STATE", {"phase": "cold_prove", "line": None,
                                     "final": False, "metric": "m"})
        mp.setattr(bench, "_BUDGET", 0.0)
        watchdog()
    return _lines(out.getvalue())


def _jax_metric(name, monkeypatch):
    """bench.py's metric for TVM_BENCH=name: main() stopped where it
    starts building the config."""
    monkeypatch.setenv("TVM_BENCH", name)
    monkeypatch.setenv("TVM_JAX_CACHE", "1")
    monkeypatch.setattr(bench, "_watchdog", lambda: None)
    monkeypatch.setattr(bench, "_STATE", {"phase": "import", "line": None,
                                          "final": False})
    monkeypatch.setattr(triton_vm_tpu.VM, "trace_execution",
                        staticmethod(_stop))
    monkeypatch.setattr(bench, "_merkle_auth_fixture", _stop)
    monkeypatch.setattr(bench, "_recursive_verifier_fixture", _stop)
    with pytest.raises(_Stop):
        bench.main()
    return bench._STATE["metric"]


@pytest.mark.parametrize("name", NAMES)
def test_metric_equals_bench(name, monkeypatch):
    assert tbench.metric(name) == _jax_metric(name, monkeypatch)


def test_unknown_name_exits_as_bench_does(monkeypatch):
    monkeypatch.setenv("TVM_BENCH", "fib_2048")
    monkeypatch.setattr(bench, "_watchdog", lambda: None)
    with pytest.raises(SystemExit) as want:
        bench.main()
    with pytest.raises(SystemExit) as got:
        tbench.main([], device="cpu")
    assert str(got.value) == str(want.value)
    assert "fib_1024" in str(got.value)
    for name in ("spin_", "spin_0", "spin_x"):
        with pytest.raises(SystemExit):
            tbench.metric(name)


def test_result_line_anchors():
    line = tbench.result_line("fib_1024", 2.0)
    assert line["vs_baseline"] == 0.25
    assert line["baseline_source"].startswith("BASELINE.md")
    assert tbench.result_line("spin_65536", 0.8)["vs_baseline"] == 2.0
    line = tbench.result_line("hash_chain", 2.0)
    assert (line["vs_baseline"], line["baseline_source"]) == (0.0, "none")


def _fib7(name, device="cuda"):
    return ex.fibonacci(), [7], None


def test_main_on_the_cpu(jax_lines, monkeypatch, capsys):
    """The port's phases on the CPU, with bench.py's keys on every line
    and the speed-of-light pass at a small batch."""
    monkeypatch.setenv("TVM_BENCH", "hash_chain")  # a config with no anchor
    monkeypatch.setenv("TVM_BENCH_SOL", "1")
    monkeypatch.setenv("TVM_PROFILE", "1")
    monkeypatch.delenv("TVM_BENCH_BUDGET_S", raising=False)
    monkeypatch.setattr(baseline, "config", _fib7)
    small = tbench.sol
    monkeypatch.setattr(tbench, "sol", lambda device, peak_gbps: small(
        device, peak_gbps, batch=1 << 6, reps=1))
    tbench.main([], device="cpu")
    out, err = capsys.readouterr()
    lines = _lines(out)
    first, last = lines[0], lines[-1]
    assert first["partial"] is True
    assert first.keys() == jax_lines[0].keys()
    assert last.keys() == jax_lines[-2].keys()  # bench's final line
    assert last["metric"] == tbench.metric("hash_chain")
    assert last["vs_baseline"] == 0.0 and last["baseline_source"] == "none"
    assert 0 < last["value"] and 0 < first["cold_prove_s"]
    assert last["ramp_s"] == 0.0  # nothing to build on the CPU
    assert last["verify_s"] > 0
    # every top-level stage marker of the port's prover, in order
    markers = list(dict.fromkeys(re.findall(
        r'_trace\("([^"]+)"', Path(tprover.__file__).read_text())))
    assert list(last["stages"]) == markers
    assert all(s >= 0 for s in last["stages"].values())
    assert last["sol"].keys() == jax_lines[-2]["sol"].keys()
    assert all(v > 0 for k, v in last["sol"].items() if "per_s" in k)
    # TVM_PROFILE=1
    assert "### cold prove hash_chain" in err and "### prove hash_chain" in err
    assert 'kernel launches (proves and verify): {"tip5_permutation": 0' \
        in err  # the plain versions ran, not the kernels


def test_sol_figures_equal_bench(jax_lines):
    """bench.py's figures at its shapes, each of its three timings one
    clock step over three calls."""
    t = CLOCK_STEP / 3
    assert jax_lines[-2]["sol"] == tbench.sol_figures(
        1 << 18, t, t, t, float(HBM_GBPS))


def test_watchdog_reports_the_phase(jax_lines, monkeypatch):
    """A cold prove that does not end before the budget does: the
    watchdog's line says so with bench.py's keys, and the error that ends
    the prove still ends `main`."""
    out = io.StringIO()

    def blocked(self, claim, aet, seed=None):
        deadline = time.perf_counter() + 60
        while "incomplete" not in out.getvalue():
            assert time.perf_counter() < deadline
            time.sleep(0.05)
        raise RuntimeError("the prove was stopped")

    monkeypatch.setenv("TVM_BENCH", "fib_1024")
    monkeypatch.setenv("TVM_BENCH_BUDGET_S", "20")  # watchdog after 5 s
    monkeypatch.setattr(baseline, "config", _fib7)
    monkeypatch.setattr(tprover.Stark, "prove", blocked)
    VM.trace_execution(ex.fibonacci(), PublicInput([7]))  # the VM is built
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="was stopped"):
        tbench.main([], device="cpu")
    line = _lines(out.getvalue())[-1]
    assert line.keys() == jax_lines[-1].keys()
    assert line["incomplete"] is True
    assert line["phase_reached"] == "cold_prove"
    assert line["metric"] == "prove_fib_padded_height_1024_wall_clock"
    assert line["value"] >= 5.0


def test_cli_without_a_card_exits_with_the_provers_error():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    proc = subprocess.run(
        [sys.executable, "-m", "triton_vm_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not _lines(proc.stdout)
