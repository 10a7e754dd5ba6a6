"""The benchmark's arithmetic on synthetic runs: the end-to-end metrics
over steps, the device's busy union and idle share, the roofline over a
fixed list of launches, the breakdown's labels, and the check for
forbidden modules."""

import sys
import types

import numpy as np
import pytest

from port_bench import breakdown, run, trace
from port_bench.roofline import work

MS = 1_000_000  # nanoseconds


def _step(i, start, proved, end, prove_s=None, spans=None):
    s = run.Step(i, b"")
    s.start_ns, s.proved_ns, s.end_ns = start, proved, end
    s.prove_s = (proved - start) / 1e9 if prove_s is None else prove_s
    s.verify_s = (end - proved) / 1e9
    s.proof = np.array([i], np.uint64)
    s.program_verified = True
    s.spans = spans or {}
    return s


def _run(steps, ops=(), spans=(), launches=()):
    r = run.Run(cell={"name": "x"}, inputs=None, trace=True, steps=steps)
    r.device_trace = trace.Trace(ops=trace.DeviceOps.of(list(ops)),
                                 spans=list(spans), launches=list(launches))
    return r


def test_prove_and_verify_s_are_sums_over_steps():
    r = _run([_step(0, 0, 2000 * MS, 3000 * MS),
              _step(1, 3000 * MS, 7000 * MS, 7500 * MS)])
    assert run.read_metric("prove_s", r) == pytest.approx(3.0)
    assert run.read_metric("verify_s", r) == pytest.approx(0.75)


def test_stage_metrics_sum_spans_over_proves():
    r = _run([_step(0, 0, 10, 11, prove_s=4.0,
                    spans={"LDT": 2.0, "fill main": 0.5, "extend aux": 1.0}),
              _step(1, 11, 20, 21, prove_s=6.0,
                    spans={"LDT": 3.0, "fill main": 0.5, "extend aux": 1.5})])
    assert run.read_metric("ldt.s", r) == pytest.approx(2.5)
    assert run.read_metric("witness.s", r) == pytest.approx(1.75)
    assert run.read_metric("outside_spans.s", r) == pytest.approx(0.75)
    assert run.read_metric("quotients.s", r) == 0.0


def test_untraced_run_reads_no_stage_or_device_metric():
    r = run.Run(cell={"name": "x"}, inputs=None, trace=False,
                steps=[_step(0, 0, 10, 11)])
    for name in ("ldt.s", "kernels.ms", "kernels_roofline",
                 "device.idle_pct"):
        assert run.read_metric(name, r) is None


def test_idle_share_is_the_union_over_prove_time():
    # prove [0, 100) ms: ops cover [10, 30) and [20, 50) -> busy 40 ms;
    # prove [200, 300) ms: op [250, 400) covers 50 ms of it
    ops = [("a", 10 * MS, 30 * MS),
           ("b", 20 * MS, 50 * MS),
           ("c", 250 * MS, 400 * MS)]
    r = _run([_step(0, 0, 100 * MS, 150 * MS),
              _step(1, 200 * MS, 300 * MS, 320 * MS)], ops)
    assert run.read_metric("device.idle_pct", r) == pytest.approx(55.0)
    busy, window = breakdown.busy_and_window(r)
    assert busy == pytest.approx(0.11)
    assert window == pytest.approx(0.32)


def test_union_of_device_operations():
    ops = trace.DeviceOps.of([("a", 5, 7), ("b", 0, 2), ("a", 1, 3),
                              ("c", 7, 9), ("d", 20, 21), ("e", 6, 8)])
    starts, ends, before = ops.union()
    assert list(zip(starts.tolist(), ends.tolist())) == [(0, 3), (5, 9),
                                                          (20, 21)]
    assert int(ops.covered(2, 6)) == 2
    assert ops.covered([0, 3, 8, 0], [12, 5, 30, 100]).tolist() == [7, 0, 2, 8]
    assert int(trace.DeviceOps.of([]).covered(0, 5)) == 0


def test_roofline_over_a_fixed_launch_list():
    launches = [("K1", {"batch": 1 << 17}),
                ("K2", {"rows": 1 << 18, "width": 379}),
                ("K4", {"rows": 379, "n_in": 1 << 16, "length": 1 << 18,
                        "scaled_words": 1 << 16}),
                ("K3", {"rows": 1 << 19, "trace_len": 1 << 16})]
    bound = sum(work.bound_s(k, s) for k, s in launches)
    # PERF.md's bounds: K1 0.0552 ms at 2^17, K2 4.193 ms at 2^18 x 379
    assert work.bound_s(*launches[0]) * 1e3 == pytest.approx(0.05516, 1e-3)
    assert work.bound_s(*launches[1]) * 1e3 == pytest.approx(4.1925, 1e-4)
    ops = [("tip5_permutation_kernel", 0, 2 * MS),
           ("void tip5_sponge_rows_kernel(...)", 0, 8 * MS),
           ("ntt_pass_kernel", 0, 10 * MS),
           ("seg_7(Args, long, long)", 0, 5 * MS),
           ("quotient_rows_kernel", 0, 5 * MS),
           ("vectorized_elementwise_kernel", 0, 50 * MS)]
    r = _run([_step(0, 0, 100 * MS, 110 * MS)], ops, launches=launches)
    assert run.read_metric("kernels_roofline", r) == pytest.approx(
        100 * bound / 0.030)
    assert run.read_metric("kernels.ms", r) == pytest.approx(30.0)


def test_kernel_names():
    assert trace.kernel_of("_Z6seg_12P4Argsll") == "K3"
    assert trace.kernel_of("quotient_out_kernel(Args)") == "K3"
    assert trace.kernel_of("ntt_pass_kernel") == "K4"
    assert trace.kernel_of("segment_reduce_forward_kernel") is None
    assert trace.kernel_of("elementwise_kernel") is None


def test_idle_gaps_are_labelled_by_the_innermost_span():
    spans = [trace.Span(("LDT",), 10 * MS, 90 * MS),
             trace.Span(("LDT", "STIR zerofier"), 20 * MS, 40 * MS)]
    ops = [("k", 50 * MS, 90 * MS)]
    r = _run([_step(0, 0, 100 * MS, 130 * MS)], ops, spans)
    idle = dict(breakdown.breakdown(r)["idle_gaps"])
    assert idle["LDT/STIR zerofier"] == pytest.approx(0.020)
    assert idle["LDT"] == pytest.approx(0.020)
    assert idle[breakdown.OUTSIDE] == pytest.approx(0.020)
    assert idle["verify"] == pytest.approx(0.030)
    assert breakdown.breakdown(r)["device_ops"] == [["k", 0.04]]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert not run.forbidden_modules()
    for name in ("triton_vm_tpu_torch", "triton_vm_tpu_torchx", "jaxfoo"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not run.forbidden_modules()
    for name in ("jax", "jaxlib.xla", "triton_vm_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib.xla",
                                       "triton_vm_tpu.ops"]


def test_frozen_work_equals_the_ports():
    """roofline/work.py's K3 and K4 are frozen copies of the port's
    `quotient_cuda.work` and `ntt_cuda.work` at the benchmark's commit."""
    from triton_vm_tpu_torch.air import compile as aircomp
    from triton_vm_tpu_torch.ops import ntt_cuda, quotient_cuda

    for shape in ((379, 1 << 16, 1 << 18, 1 << 16), (3, 1 << 12, 1 << 12,
                                                       1 << 12)):
        assert work.k4(*shape) == ntt_cuda.work(*shape)
    tape = aircomp.quotient_row_tape()
    for rows, h in ((1 << 19, 1 << 16), (1 << 13, 1 << 10)):
        assert work.k3(rows, h) == quotient_cuda.work(tape, rows, h)
