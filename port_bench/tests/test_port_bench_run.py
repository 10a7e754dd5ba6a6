"""Whole runs of the harness at a tiny size, called in process on the CPU
(the command refuses to run without a card): a sound run is correct, the
control and each planted fault are not, and the command without a card
exits with no result."""

import json
from pathlib import Path

import pytest

from port_bench import inputs, run

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CELL = {"name": "fib_tiny.tiny", "config": "fib_tiny", "traffic": "tiny",
        "chips": 1, "why": "a size a CPU test proves"}
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def bench():
    b = run.load_benchmark(ROOT)
    b["workloads"].append(CELL)
    return b


def _inputs():
    traffic = json.loads((DATA / "tiny.json").read_text())
    return inputs.load_config(DATA / "fib_tiny.json", traffic)


def _run(bench, seconds=0.1, trace=False, **kw):
    return run.run_cell(bench, CELL, SEED, seconds, trace, "cpu", ROOT,
                        inputs=_inputs(), **kw)


def test_sound_run_is_correct(bench):
    result = _run(bench)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    # verify_s is the spin cells' only; a CPU run has no device peak
    assert set(result["metrics"]) == {"setup_s", "prove_s"}
    assert all(c["value"] == 0 for k, c in result["checks"].items()
               if c["limit"] is not None)
    assert result["checks"]["proofs_checked"]["value"] == result["attempted"]
    json.dumps(result)


def test_traced_run_reads_the_stage_spans(bench):
    result = _run(bench, trace=True)
    assert result["correct"] is True
    assert {"ldt.s", "witness.s", "commit.s", "quotients.s", "ood_deep.s",
            "outside_spans.s"} <= set(result["metrics"])
    # a CPU run has no device trace: its device metrics stay silent
    assert "device.idle_pct" not in result["metrics"]
    assert "kernels_roofline" not in result["metrics"]
    assert [label for label, _ in result["breakdown"]["idle_gaps"]]


def test_control_is_not_correct(bench):
    """The control: the program proves under the conjectured proximity
    regime, a guarantee below the proven one the configuration states."""
    result = _run(bench, stark_override={"soundness": "conjectured"})
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]


def test_answer_altered_where_produced_is_not_correct(bench, monkeypatch):
    """K2's output (every row digest) altered in one word: the program's
    own verifier hashes rows through the same path and may not notice;
    the reference does."""
    from triton_vm_tpu_torch.ops import tip5_kernel

    orig = tip5_kernel.sponge_absorb_rows

    def altered(rows):
        out = orig(rows).clone()
        out[0, 0] = (out[0, 0] + 1) % (1 << 32)
        return out

    monkeypatch.setattr(tip5_kernel, "sponge_absorb_rows", altered)
    result = _run(bench)
    assert result["correct"] is False
    assert result["checks"]["merkle"]["value"] >= 1 or \
        result["checks"]["steps_failed"]["value"] >= 1


def test_quotient_altered_where_produced_is_not_correct(bench, monkeypatch):
    """One value of the combined quotient codeword altered: segmentify
    interpolates it into every segment, so the out-of-domain check
    fails."""
    from triton_vm_tpu_torch.stark import prover

    orig = prover._all_quotients_combined_device

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0, 0] = (out[0, 0] + 1) % (1 << 32)
        return out

    monkeypatch.setattr(prover, "_all_quotients_combined_device", altered)
    result = _run(bench)
    assert result["correct"] is False
    assert result["checks"]["ood_quotient"]["value"] >= 1
    assert result["checks"]["program_verify_failed"]["value"] >= 1


def test_wrong_frozen_output_is_not_correct(bench):
    """The claim's output altered in the configuration: the program's VM
    disagrees (its prove raises) and so does the reference's model."""
    inp = _inputs()
    inp.output = [inp.output[0] + 1]
    result = run.run_cell(bench, CELL, SEED, 0.1, False, "cpu", ROOT,
                          inputs=inp)
    assert result["correct"] is False
    assert result["checks"]["claim_output"]["value"] == 1
    assert result["failed"] == result["attempted"]


def test_step_returning_a_stale_proof_is_not_correct(bench, monkeypatch):
    """Every step returns one proof made before the window, as a step
    that did no work would."""
    import triton_vm_tpu_torch as tvm

    orig = tvm.prove
    cached = []

    def stale(stark, claim, program, nondet=None, seed=None):
        if not cached:
            cached.append(orig(stark, claim, program, nondet, seed=seed))
        return cached[0]

    monkeypatch.setattr(tvm, "prove", stale)
    inp = _inputs()
    inp.traffic = dict(inp.traffic, warmup_steps=1)
    result = run.run_cell(bench, CELL, SEED, 1.5, False, "cpu", ROOT,
                          inputs=inp)
    assert result["attempted"] >= 2
    assert result["checks"]["repeated_proofs"]["value"] >= 1
    assert result["correct"] is False


def test_command_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    rc = run.main(["--workload", "spin.h15", "--seed", str(2**33 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "needs 1 CUDA card" in out.err


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_the_device(bench):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.run_cell(bench, CELL, SEED, 1.0, True, "cuda", ROOT,
                          inputs=_inputs())
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    assert {"device.idle_pct", "kernels.ms",
            "kernels_roofline"} <= set(result["metrics"])
