"""The JIT LDE's coset counter (`JIT cosets`, stark/jit_lde.py): one per
coset transform of a table's coefficients. A forced-JIT prove inside a
profiler session counts what the prove's domains give; outside a session
the same coset loops count nothing."""

import numpy as np
import pytest
import torch

import triton_vm_tpu_torch as tvm
from triton_vm_tpu_torch import config
from triton_vm_tpu_torch.fields.bfe import P
from triton_vm_tpu_torch.models import example_programs as ex
from triton_vm_tpu_torch.ops import gf
from triton_vm_tpu_torch.stark import jit_lde
from triton_vm_tpu_torch.stark.arithmetic_domain import Domain
from triton_vm_tpu_torch.utils import profiler

torch.set_num_threads(2)


@pytest.fixture
def forced_jit():
    config.overwrite_lde_trace_caching_to(config.CacheDecision.JIT)
    try:
        yield
    finally:
        config.overwrite_lde_trace_caching_to(None)


def _cosets_of(indices, stride, m):
    return len({i * stride % m for i in indices})


def test_a_jit_prove_counts_its_domains_cosets(forced_jit, monkeypatch):
    """fib(7) pads to 2^9, the least height a program gives: E = 4n, four
    cosets of each table to commit, of each for the quotients, and those
    that hold a revealed row."""
    revealed = []
    orig = jit_lde.reveal_rows

    def recording(coeffs, eval_dom, ldt_len, indices):
        revealed.append(list(indices))
        return orig(coeffs, eval_dom, ldt_len, indices)

    monkeypatch.setattr(jit_lde, "reveal_rows", recording)
    stark = tvm.Stark(security_level=32, device="cpu")
    program = ex.fibonacci()
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([7]))
    claim = tvm.Claim.about_program(program).with_input([7]) \
        .with_output(output)
    _, _, _, rand_dom, quot_dom, ldt_dom = stark.derive_domains(
        aet.padded_height())
    n, Q, L = rand_dom.length, quot_dom.length, ldt_dom.length
    E = max(L, Q)
    m, stride = E // n, E // L

    profiler.start("jit prove")
    stark.prove(claim, aet, seed=bytes(range(32)))
    prof = profiler.finish()

    assert m > 1 and len(revealed) == 2 and revealed[0] == revealed[1]
    want = (2 * (m // stride) + 2 * (Q // n)
            + 2 * _cosets_of(revealed[0], stride, m))
    got = {task.name: 0 for task in prof.tasks}
    for iv in prof.intervals():
        got[iv.path[0]] += iv.counts.get(jit_lde.JIT_COSETS, 0)
    assert got["main LDE"] == got["aux LDE"] == m // stride
    assert got["quotients"] == 2 * (Q // n)
    assert got["reveal"] == 2 * _cosets_of(revealed[0], stride, m)
    assert sum(got.values()) == want


def test_the_coset_loops_count_only_in_a_session():
    """committed_digests (E = 2L: every second coset holds LDT rows) and
    reveal_rows, outside a session and in one."""
    h, n = 32, 64
    rng = np.random.default_rng(5)
    coeffs = jit_lde.committed_coefficients(
        gf.from_u64(rng.integers(0, P, (4, h), dtype=np.uint64)),
        gf.from_u64(rng.integers(0, P, (4, 5), dtype=np.uint64)),
        Domain(h), n)
    eval_dom = Domain(8 * n, 7)
    L = eval_dom.length // 2

    def loops():
        jit_lde.committed_digests(coeffs, eval_dom, L)
        jit_lde.reveal_rows(coeffs, eval_dom, L, [0, 1, 2, 8])

    before = profiler.totals()
    loops()
    after = profiler.totals()
    assert after.count(jit_lde.JIT_COSETS) == before.count(
        jit_lde.JIT_COSETS)
    assert after.sessions == before.sessions

    profiler.start("coset loops")
    loops()
    prof = profiler.finish()
    # 4 of the 8 cosets hold LDT rows; rows 0, 1, 2, 8 sit at evaluation
    # indices 0, 2, 4, 16, in cosets 0, 2 and 4
    assert sum(iv.counts.get(jit_lde.JIT_COSETS, 0)
               for iv in prof.intervals()) == 4 + 3
    assert profiler.totals().count(jit_lde.JIT_COSETS) == before.count(
        jit_lde.JIT_COSETS) + 7
