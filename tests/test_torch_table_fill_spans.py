"""The host table fill's sub-spans (tables/master.py::fill_main_table):
in a profiler session a tiny prove shows each table's fill, and the
padding of all nine, as a span of its own within `host table fill` (the
RAM Bezout within `RAM table`); outside a session nothing is recorded, no
more work is done, and the main table is the same word for word."""

import numpy as np
import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu_torch.air import columns
from triton_vm_tpu_torch.tables import master
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)

SEED = bytes(range(32))
# a loop of u32 comparisons, a RAM write and read, and one hash: every
# table of the main table has rows
CODE = """
    read_io 1
    call loop
    pop 1
    push 9 push 42 write_mem 1 pop 1
    push 42 read_mem 1 pop 2
    push 1 push 2 push 3 push 4 push 5 push 6 push 7 push 8 push 9 push 10
    hash
    pop 5
    halt

    loop:
        dup 0 push 0 eq skiz return
        addi -1
        dup 0 push 3 lt pop 1
        recurse
"""
SUB_SPANS = {"op stack table", "RAM table", "jump stack table",
             "processor table", "program table", "hash table",
             "cascade and lookup tables", "U32 table", "table padding"}
FILL = ("fill main", "host table fill")


@pytest.fixture(autouse=True)
def no_open_session():
    profiler.finish()
    yield
    profiler.finish()


def _trace():
    program = tvm.triton_program(CODE)
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([6]))
    return program, aet, output


@pytest.fixture(scope="module")
def proved():
    """The program proven at its padded height with a profiler session
    open, and its AET."""
    profiler.finish()
    program, aet, output = _trace()
    claim = (tvm.Claim.about_program(program).with_input([6])
             .with_output(output))
    stark = tvm.Stark.low_security(device="cpu")
    profiler.start("prove")
    proof = tvm.prove(stark, claim, program, seed=SEED)
    profile = profiler.finish()
    assert tvm.verify(stark, claim, proof)
    return profile, aet


def test_every_table_has_rows(proved):
    _, aet = proved
    assert all(aet.height_of_table(t) > 0 for t in columns.TABLE_IDS)


def test_the_nine_sub_spans_lie_within_the_host_table_fill(proved):
    profile, _ = proved
    children = {iv.path[-1] for iv in profile.intervals()
                if iv.path[:-1] == FILL}
    assert children == SUB_SPANS
    assert any(iv.path == FILL + ("RAM table", "RAM Bezout")
               for iv in profile.intervals())
    ns = {}
    for iv in profile.intervals():
        ns[iv.path] = ns.get(iv.path, 0) + iv.end_ns - iv.start_ns
    assert sum(ns[FILL + (n,)] for n in SUB_SPANS) <= ns[FILL]


def test_each_sub_span_runs_once_a_fill(proved):
    profile, _ = proved
    fills = [iv for iv in profile.intervals() if iv.path == FILL]
    subs = [iv for iv in profile.intervals() if iv.path[:-1] == FILL]
    assert len(fills) == 1 and len(subs) == len(SUB_SPANS)
    # one after another, in the fill's order, within the fill
    assert [iv.path[-1] for iv in sorted(subs, key=lambda iv: iv.start_ns)] \
        == ["op stack table", "RAM table", "jump stack table",
            "processor table", "program table", "hash table",
            "cascade and lookup tables", "U32 table", "table padding"]
    assert all(fills[0].start_ns <= iv.start_ns <= iv.end_ns
               <= fills[0].end_ns for iv in subs)


def test_outside_a_session_nothing_is_recorded(monkeypatch):
    """Traced or not, the fill works out no table height beyond what the
    fill routines themselves read."""
    _, aet, _ = _trace()
    h = aet.padded_height()
    heights = []
    orig = aet.height_of_table
    monkeypatch.setattr(aet, "height_of_table",
                        lambda t: heights.append(t) or orig(t))
    profiler.start("fill")
    traced = master.fill_main_table(aet, padded_height=h, device="cpu")
    profiler.finish()
    traced_heights, heights[:] = list(heights), []
    before = profiler.totals()
    plain = master.fill_main_table(aet, padded_height=h, device="cpu")
    after = profiler.totals()
    assert (after.sessions, after.seconds, after.counts) == (
        before.sessions, before.seconds, before.counts)
    assert sorted(traced_heights) == sorted(heights)
    assert np.array_equal(plain, traced)
