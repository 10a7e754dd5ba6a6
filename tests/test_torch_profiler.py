"""The port's span profiler (triton_vm_tpu_torch/utils/profiler.py) on the
CPU: sessions, intervals on `time.time_ns`, counters and the process's
totals; no recording and no synchronisation without a session (a stub
CUDA device and a recording `torch.cuda.synchronize`); the spans of a
small prove and verify, the verify's `merkle hashed nodes` counts, and
the same proof words with a session open and without one."""

import time

import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu_torch.crypto import merkle
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.ops import gf
from triton_vm_tpu_torch.stark import prover
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)

SEED = bytes(range(32))
CUDA = torch.device("cuda")  # a stub: nothing runs on it


@pytest.fixture(autouse=True)
def no_open_session():
    profiler.finish()
    yield
    profiler.finish()


@pytest.fixture
def syncs(monkeypatch):
    """Every torch.cuda.synchronize call, with one stub card visible."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    return calls


def _device_span():
    with profiler.device_span("x", None, CUDA):
        pass


def _stage_markers():
    prover._trace("x", None, CUDA)
    prover._trace(None, device=CUDA)


@pytest.mark.parametrize("session", [False, True])
@pytest.mark.parametrize("marker", [_device_span, _stage_markers])
def test_synchronises_only_in_a_session(syncs, marker, session):
    if session:
        profiler.start("unit")
    marker()
    profile = profiler.finish()
    if session:
        assert syncs and [t.name for t in profile.tasks] == ["x"]
    else:
        assert syncs == [] and profile.tasks == []


def test_no_session_records_nothing():
    profiler.reset_totals()
    with profiler.span("outside"):
        profiler.count("things", 3)
        profiler.device_read(8, 0.5)
    profile = profiler.finish()
    assert profile.tasks == [] and profile.intervals() == []
    assert profiler.totals() == profiler.Totals()
    assert not profiler.recording()


def test_intervals_nest_on_the_host_wall_clock():
    before = time.time_ns()
    profiler.start("step 3")
    with profiler.span("a"):
        for _ in range(2):
            with profiler.span("b"):
                time.sleep(0.001)
    with profiler.span("c"):
        pass
    profile = profiler.finish()
    after = time.time_ns()
    assert profile.name == "step 3"
    got = profile.intervals()
    assert [iv.path for iv in got] == [("a", "b"), ("a", "b"), ("a",),
                                       ("c",)]
    b1, b2, a, c = got
    assert before <= a.start_ns <= b1.start_ns < b1.end_ns <= b2.start_ns
    assert b2.end_ns <= a.end_ns <= c.start_ns <= c.end_ns <= after
    # the summed tree is kept beside the intervals
    b_task = next(t for t in profile.tasks if t.name == "b")
    assert b_task.num_invocations == 2
    assert b_task.total_duration == pytest.approx(
        (b1.end_ns - b1.start_ns + b2.end_ns - b2.start_ns) / 1e9, abs=1e-3)


def test_a_span_within_its_own_category_counts_there_once():
    profiler.start("unit")
    with profiler.span("a", "witness"):
        with profiler.span("b", "witness"):
            time.sleep(0.001)
        with profiler.span("c", "hash"):
            time.sleep(0.001)
    profile = profiler.finish()
    tasks = {t.name: t for t in profile.tasks}
    assert profile.category_times == {
        "witness": tasks["a"].total_duration,
        "hash": tasks["c"].total_duration}


def test_unfinished_spans_close_into_intervals():
    profiler.start("unit")
    profiler.enter("left-open")
    profiler.count("n")
    profile = profiler.finish()
    assert profile.tasks[0].name == "left-open (unfinished)"
    (iv,) = profile.intervals()
    assert iv.path == ("left-open",) and iv.counts == {"n": 1}


def test_counts_land_on_the_innermost_span():
    profiler.start("unit")
    profiler.count("outside")
    with profiler.span("a"):
        profiler.count("rows", 2)
        with profiler.span("b"):
            profiler.count("rows", 5)
            profiler.device_read(16, 0.25)
        profiler.count("rows")
    profile = profiler.finish()
    tasks = {t.name: t for t in profile.tasks}
    assert tasks["a"].counts == {"rows": 3}
    assert tasks["b"].counts == {"rows": 5, profiler.DEVICE_READS: 1,
                                 profiler.DEVICE_READ_BYTES: 16,
                                 profiler.DEVICE_READ_SECONDS: 0.25}
    assert profile.counts == {"outside": 1}
    by_path = {iv.path: iv.counts for iv in profile.intervals()}
    assert by_path[("a",)] == {"rows": 3}
    assert by_path[("a", "b")]["rows"] == 5
    report = str(profile)
    assert "rows 3" in report and "device reads 1" in report
    assert "outside 1" in report


def test_totals_sum_over_sessions_until_reset():
    profiler.reset_totals()
    for n in (1, 2):
        profiler.start(f"step {n}")
        with profiler.span("a"):
            with profiler.span("b"):
                profiler.count("rows", n)
        profiler.count("loose", 10)
        profiler.finish()
    totals = profiler.totals()
    assert totals.sessions == 2
    assert set(totals.seconds) == {("a",), ("a", "b")}
    assert totals.seconds[("a",)] >= totals.seconds[("a", "b")] > 0
    assert totals.counts == {("a", "b"): {"rows": 3}, (): {"loose": 20}}
    assert totals.count("rows") == 3 and totals.count("missing") == 0
    profiler.reset_totals()
    assert profiler.totals() == profiler.Totals()


class _StubCudaTensor:
    """What gf.to_u64 and gf.equal touch of a CUDA tensor."""
    device = CUDA

    def detach(self):
        return self

    def cpu(self):
        return torch.arange(4, dtype=torch.int64)


@pytest.mark.parametrize("session", [False, True])
@pytest.mark.parametrize("on_card", [False, True])
def test_device_reads_are_counted_at_the_boundary(session, on_card,
                                                  monkeypatch):
    monkeypatch.setattr(torch, "equal", lambda a, b: True)
    t = _StubCudaTensor() if on_card else torch.arange(4)
    if session:
        profiler.start("unit")
    with profiler.span("read"):
        assert gf.to_u64(t).tolist() == [0, 1, 2, 3]
        assert gf.equal(t, t)
    profile = profiler.finish()
    counts = profile.tasks[0].counts if profile.tasks else {}
    if session and on_card:
        assert counts[profiler.DEVICE_READS] == 2
        assert counts[profiler.DEVICE_READ_BYTES] == 33
        assert counts[profiler.DEVICE_READ_SECONDS] >= 0
    else:
        assert counts == {}


# ------------------------------------------------------------ a whole prove

@pytest.fixture(scope="module")
def proves():
    """fib(10) at padded height 2^9 (FRI) proved without a session and with
    one, then verified in a session; every device span and stage marker
    of the proves is handed a stub CUDA device, and the synchronisations
    each prove asked for are recorded."""
    mp = pytest.MonkeyPatch()
    calls = []
    mp.setattr(torch.cuda, "synchronize",
               lambda device=None: calls.append(device))
    mp.setattr(torch.cuda, "device_count", lambda: 1)
    device_span, trace = profiler.device_span, prover._trace
    mp.setattr(profiler, "device_span",
               lambda name, category, device: device_span(name, category,
                                                          CUDA))
    mp.setattr(prover, "_trace",
               lambda msg, category=None, device=None: trace(
                   msg, category, device and CUDA))
    try:
        program = ex.fibonacci()
        _, output = tvm.VM.trace_execution(program, tvm.PublicInput([10]),
                                           tvm.NonDeterminism())
        claim = (tvm.Claim.about_program(program).with_input([10])
                 .with_output(output))
        stark = tvm.Stark.low_security(device="cpu")
        plain = tvm.prove(stark, claim, program, seed=SEED)
        plain_syncs = len(calls)
        profiler.start("prove")
        traced = tvm.prove(stark, claim, program, seed=SEED)
        prove_profile = profiler.finish()
        traced_syncs = len(calls) - plain_syncs
    finally:
        mp.undo()
    profiler.start("verify")
    assert tvm.verify(stark, claim, traced)
    verify_profile = profiler.finish()
    return {"plain": plain, "traced": traced, "plain_syncs": plain_syncs,
            "traced_syncs": traced_syncs, "prove": prove_profile,
            "verify": verify_profile}


def _children(profile):
    """{parent path: {child names}}, and the top-level names under ()."""
    paths = {iv.path for iv in profile.intervals()}
    out = {}
    for path in paths:
        out.setdefault(path[:-1], set()).add(path[-1])
    return out


def test_an_unprofiled_prove_does_not_synchronise(proves):
    assert proves["plain_syncs"] == 0
    assert proves["traced_syncs"] > 0


def test_proof_words_equal_with_and_without_a_session(proves):
    assert proves["traced"].words == proves["plain"].words


@pytest.mark.parametrize("parent, children", [
    ((), {"VM trace", "setup", "fill main", "extend aux", "OOD", "LDT"}),
    (("fill main",), {"host table fill", "main derived columns"}),
    (("extend aux",), {"aux factors", "aux scans", "aux derived columns"}),
    (("OOD",), {"OOD kernels", "OOD reads and Fiat-Shamir"}),
    (("LDT",), {"FRI commit", "FRI inclusion proofs"}),
])
def test_prove_spans(proves, parent, children):
    assert children <= _children(proves["prove"])[parent]


def test_vm_trace_is_split(proves):
    got = _children(proves["prove"])[("VM trace",)]
    assert got in ({"VM state", "native inputs", "native run",
                    "AET assembly"}, {"VM state", "interpreter run"})
    assert [t.name for t in proves["prove"].tasks][0] == "VM trace"


def test_prove_intervals_lie_inside_their_parents(proves):
    intervals = proves["prove"].intervals()
    by_path = {}
    for iv in intervals:
        by_path.setdefault(iv.path, []).append(iv)
    for iv in intervals:
        if len(iv.path) > 1:
            assert any(p.start_ns <= iv.start_ns and iv.end_ns <= p.end_ns
                       for p in by_path[iv.path[:-1]])


def test_verify_spans(proves):
    children = _children(proves["verify"])
    assert children[()] == {"verify"}
    assert children[("verify",)] == {"decode", "AIR", "DEEP", "LDT",
                                     "merkle"}


def test_verify_counts_merkle_hashed_nodes(proves):
    """The verify's Merkle checks count the parents they hash on their own
    spans: the three trees of the revealed rows (one set of indices, so
    a multiple of three) under `merkle`, FRI's rounds and last codeword
    under `LDT`."""
    counts = {iv.path: iv.counts.get(merkle.HASHED_NODES, 0)
              for iv in proves["verify"].intervals()}
    assert counts[("verify", "merkle")] > 0
    assert counts[("verify", "merkle")] % 3 == 0
    assert counts[("verify", "LDT")] > 0
    assert sum(counts.values()) == \
        counts[("verify", "merkle")] + counts[("verify", "LDT")]
