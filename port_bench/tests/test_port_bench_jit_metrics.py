"""The readers of the JIT LDE's records on synthetic runs: its spans at
any depth and its coset counter, from the profiler's totals (synthetic
totals in place of the process's)."""

import numpy as np
import pytest

from port_bench import run
from triton_vm_tpu_torch.utils import profiler


def _run(trace=True):
    s = run.Step(0)
    s.proof = np.array([0], np.uint64)
    s.program_verified = True
    return run.Run(cell={"name": "x"}, inputs=None, trace=trace, steps=[s])


JIT_SECONDS = {
    ("main LDE",): 3.0,
    ("main LDE", "JIT coset NTT"): 1.0,
    ("main LDE", "JIT coset hash"): 0.5,
    ("aux LDE", "JIT coset NTT"): 0.25,
    ("quotients",): 4.0,
    ("quotients", "JIT coset NTT"): 0.5,
    ("quotients", "JIT coset quotients"): 2.0,
    ("reveal", "JIT coset NTT"): 0.25,
    ("LDT", "STIR commit"): 9.0,
}
JIT_COUNTS = {("main LDE", "JIT coset NTT"): {"JIT cosets": 8},
              ("quotients", "JIT coset NTT"): {"JIT cosets": 16},
              ("reveal", "JIT coset NTT"): {"JIT cosets": 16},
              ("OOD",): {"device reads": 3}}


def _totals(monkeypatch, sessions, seconds, counts):
    monkeypatch.setattr(profiler, "totals", lambda: profiler.Totals(
        sessions, seconds, counts))


def test_jit_lde_s_sums_the_jit_spans_at_any_depth(monkeypatch):
    _totals(monkeypatch, 2, {**JIT_SECONDS,
                             ("reveal", "x", "JIT coset NTT"): 0.5}, {})
    assert run.read_metric("jit_lde.s", _run()) == pytest.approx(2.5)


def test_jit_cosets_count_reads_the_counter_over_the_sessions(monkeypatch):
    _totals(monkeypatch, 2, JIT_SECONDS, JIT_COUNTS)
    assert run.read_metric("jit_cosets.count", _run()) == 20


@pytest.mark.parametrize("name", ["jit_lde.s", "jit_cosets.count"])
def test_jit_metrics_are_silent_where_nothing_took_the_jit_path(
        monkeypatch, name):
    _totals(monkeypatch, 2, JIT_SECONDS, JIT_COUNTS)
    assert run.read_metric(name, _run(trace=False)) is None
    # a cached prove: no JIT span, no JIT counter
    _totals(monkeypatch, 2, {("main LDE",): 3.0},
            {("OOD",): {"device reads": 3}})
    assert run.read_metric(name, _run()) is None
    _totals(monkeypatch, 0, {}, {})
    assert run.read_metric(name, _run()) is None
    # a program whose profiler keeps no totals
    monkeypatch.delattr(profiler, "totals")
    assert run.read_metric(name, _run()) is None


def test_jit_cosets_count_is_silent_where_the_program_has_no_counter(
        monkeypatch):
    """The JIT spans without the counter, as a program before it had one
    records them."""
    _totals(monkeypatch, 2, JIT_SECONDS, {("OOD",): {"device reads": 3}})
    assert run.read_metric("jit_cosets.count", _run()) is None
    assert run.read_metric("jit_lde.s", _run()) == pytest.approx(2.25)
