"""The reader of the host table fill's per-table sub-spans, at any depth,
from the profiler's totals: on synthetic totals in place of the
process's, and on a real fill in a profiler session."""

import numpy as np
import pytest

from port_bench import run
from triton_vm_tpu_torch.utils import profiler

FILL = ("fill main", "host table fill")


def _run(trace=True):
    s = run.Step(0)
    s.proof = np.array([0], np.uint64)
    s.program_verified = True
    return run.Run(cell={"name": "x"}, inputs=None, trace=trace, steps=[s])


FILL_SECONDS = {
    ("fill main",): 40.0,
    FILL: 30.0,
    FILL + ("op stack table",): 1.0,
    FILL + ("RAM table",): 2.0,
    FILL + ("RAM table", "RAM Bezout"): 1.5,
    FILL + ("jump stack table",): 0.5,
    FILL + ("processor table",): 0.5,
    FILL + ("program table",): 16.0,
    FILL + ("hash table",): 3.0,
    FILL + ("cascade and lookup tables",): 0.25,
    FILL + ("U32 table",): 4.0,
    FILL + ("table padding",): 0.75,
    ("fill main", "main derived columns"): 8.0,
    ("LDT", "STIR commit"): 9.0,
}


def _totals(monkeypatch, sessions, seconds, counts):
    monkeypatch.setattr(profiler, "totals", lambda: profiler.Totals(
        sessions, seconds, counts))


def test_table_fill_s_sums_the_nine_sub_spans_over_the_sessions(
        monkeypatch):
    """RAM Bezout lies within `RAM table` and counts once, through it."""
    _totals(monkeypatch, 2, FILL_SECONDS, {})
    assert run.read_metric("table_fill.s", _run()) == pytest.approx(14.0)
    # the same names at another depth count too
    _totals(monkeypatch, 2, {**FILL_SECONDS,
                             ("x", "host table fill", "U32 table"): 2.0}, {})
    assert run.read_metric("table_fill.s", _run()) == pytest.approx(15.0)


@pytest.mark.parametrize("seconds, sessions", [
    # a program whose fill is one span, as before the sub-spans
    ({("fill main",): 40.0, FILL: 30.0}, 2),
    # the parent's records: the RAM Bezout straight under the fill
    ({("fill main",): 40.0, FILL: 30.0, FILL + ("RAM Bezout",): 1.5}, 2),
    # sub-span names under no fill still count; but no session, nothing
    ({}, 0),
    (FILL_SECONDS, 0),
], ids=["one_span", "parent", "empty", "no_session"])
def test_table_fill_s_is_silent_where_nothing_was_recorded(
        monkeypatch, seconds, sessions):
    _totals(monkeypatch, sessions, seconds, {("OOD",): {"device reads": 3}})
    assert run.read_metric("table_fill.s", _run()) is None


def test_table_fill_s_is_silent_untraced_or_without_totals(monkeypatch):
    _totals(monkeypatch, 2, FILL_SECONDS, {})
    assert run.read_metric("table_fill.s", _run(trace=False)) is None
    # a program whose profiler keeps no totals
    monkeypatch.delattr(profiler, "totals")
    assert run.read_metric("table_fill.s", _run()) is None


def test_table_fill_s_reads_a_real_fill():
    """A fill of a tiny program's main table in a profiler session: the
    reader finds the nine sub-spans, within the fill's own time."""
    import triton_vm_tpu_torch as tvm
    from triton_vm_tpu_torch.tables import master

    program = tvm.triton_program(
        "push 3 push 4 lt pop 1 push 7 push 1 write_mem 1 pop 1 "
        "push 1 read_mem 1 pop 2 push 1 push 2 push 3 push 4 push 5 "
        "push 6 push 7 push 8 push 9 push 10 hash pop 5 halt")
    aet, _ = tvm.VM.trace_execution(program, tvm.PublicInput([]))
    profiler.finish()
    profiler.reset_totals()
    try:
        profiler.start("fill")
        master.fill_main_table(aet, device="cpu")
        profiler.finish()
        t = profiler.totals()
        fill = [p for p in t.seconds if p[-1] == "host table fill"]
        got = run.read_metric("table_fill.s", _run())
        assert t.sessions == 1 and len(fill) == 1
        assert 0 < got <= t.seconds[fill[0]]
        assert got == pytest.approx(sum(
            t.seconds[fill[0] + (n,)] for n in (
                "op stack table", "RAM table", "jump stack table",
                "processor table", "program table", "hash table",
                "cascade and lookup tables", "U32 table",
                "table padding")))
    finally:
        profiler.finish()
        profiler.reset_totals()
