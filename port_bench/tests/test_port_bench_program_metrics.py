"""The readers of the program's own records on synthetic runs: the VM
trace span, and the host's device reads from the profiler's totals
(synthetic totals in place of the process's); and a traced run at a tiny
size on the CPU reporting them."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import inputs, run
from triton_vm_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"


def _step(i, spans):
    s = run.Step(i)
    s.proof = np.array([i], np.uint64)
    s.program_verified = True
    s.spans = spans
    return s


def _run(steps, trace=True):
    return run.Run(cell={"name": "x"}, inputs=None, trace=trace,
                   steps=steps)


def test_vm_trace_s_reads_its_top_level_span():
    r = _run([_step(0, {"VM trace": 0.5, "LDT": 2.0}),
              _step(1, {"VM trace": 0.25, "LDT": 3.0})])
    assert run.read_metric("vm_trace.s", r) == pytest.approx(0.375)


@pytest.mark.parametrize("steps, trace", [
    ([_step(0, {"LDT": 2.0})], True),   # a program without the span
    ([_step(0, {})], False),            # untraced: no session
    ([], True),
])
def test_vm_trace_s_is_silent_without_the_span(steps, trace):
    assert run.read_metric("vm_trace.s", _run(steps, trace)) is None


def _totals(sessions, counts):
    return profiler.Totals(sessions, {("fill main",): 1.0}, counts)


@pytest.mark.parametrize("name, want", [("device_reads.count", 12.5),
                                        ("device_reads.s", 0.75)])
def test_device_reads_per_prove(monkeypatch, name, want):
    counts = {("OOD", "OOD reads and Fiat-Shamir"): {
                  "device reads": 20, "device reads.bytes": 4096,
                  "device reads.s": 1.0},
              ("LDT",): {"device reads": 5, "device reads.s": 0.5},
              (): {"other": 7}}
    monkeypatch.setattr(profiler, "totals", lambda: _totals(2, counts))
    r = _run([_step(0, {"OOD": 1.0}), _step(1, {"OOD": 1.0})])
    assert run.read_metric(name, r) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_reads.count", "device_reads.s"])
def test_device_reads_are_silent_where_no_session_ran(monkeypatch, name):
    r = _run([_step(0, {})], trace=False)
    assert run.read_metric(name, r) is None
    monkeypatch.setattr(profiler, "totals", lambda: _totals(0, {}))
    assert run.read_metric(name, _run([_step(0, {})])) is None
    # a program whose profiler keeps no totals
    monkeypatch.delattr(profiler, "totals")
    assert run.read_metric(name, _run([_step(0, {"OOD": 1.0})])) is None


def test_traced_run_reports_the_program_metrics():
    """A CPU run reads no CUDA tensor: its device reads count 0."""
    bench = run.load_benchmark(ROOT)
    cell = {"name": "fib_tiny.tiny", "config": "fib_tiny", "traffic": "tiny",
            "chips": 1, "why": "a size a CPU test proves"}
    bench["workloads"].append(cell)
    traffic = json.loads((DATA / "tiny.json").read_text())
    profiler.reset_totals()
    result = run.run_cell(bench, cell, 2**33 + 17, 0.1, True, "cpu", ROOT,
                          inputs=inputs.load_config(DATA / "fib_tiny.json",
                                                    traffic))
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["vm_trace.s"]["value"] > 0
    assert metrics["device_reads.count"]["value"] == 0
    assert metrics["device_reads.s"]["value"] == 0
    assert profiler.totals().sessions == result["attempted"]
