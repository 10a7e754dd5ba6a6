"""The benchmark's configuration spin_jit (port_bench/configs/spin_jit.json)
and its cell spin_jit.h20: frozen files against their SHA-256, the
output against the reference's plain model, the input against the
port's spin generator, the traffic's low-degree test and JIT decision at
the cell's height on an 80-GB card; and one forced-JIT run of the
harness at its tiny size on the CPU, judged correct by the reference,
its proof words those of the cached path with the same seed."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

import triton_vm_tpu_torch as tvm
from port_bench import inputs, run
from port_bench.reference import programs
from triton_vm_tpu_torch import config
from triton_vm_tpu_torch.models import example_programs as ex

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "port_bench" / "configs"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = next(c for c in BENCH["workloads"] if c["name"] == "spin_jit.h20")


def _record():
    return json.loads((CONFIGS / "spin_jit.json").read_text())


def test_spin_jit_runs_spins_frozen_program():
    record = _record()
    text = (CONFIGS / record["program"]["file"]).read_bytes()
    assert hashlib.sha256(text).hexdigest() == record["program"]["sha256"]
    assert record["program"] == json.loads(
        (CONFIGS / "spin.json").read_text())["program"]
    config_entry = next(c for c in BENCH["configs"]
                        if c["name"] == "spin_jit")
    assert config_entry["reduced"] == []
    assert record["stark"] == {"security_level": 160,
                               "log2_expansion_factor": 2,
                               "soundness": "proven"}


def test_spin_jit_input_and_output():
    at = _record()["heights"]["20"]
    assert at["public_input"] == [ex.spin(20)[1]] == [(2**20 - 16) // 11]
    assert at["output"] == programs.fibonacci(at["public_input"])
    assert 2**19 < at["cycles"] <= 2**20


def test_spin_jit_h20_takes_stir_and_the_jit_lde(monkeypatch):
    """The harness's own check before the window: at 80 GB free the
    port decides JIT for the 2^23-row LDT domain (44.8 GB of committed
    codewords), and STIR is the low-degree test."""
    got = inputs.load(CELL, ROOT / "port_bench")
    assert (got.log2_padded_height, got.traffic["ldt"],
            got.traffic["lde"]) == (20, "stir", "jit")
    stark = run._stark(tvm, got.stark, "cpu", None)
    ldt, *_, ldt_dom = stark.derive_domains(1 << 20)
    assert isinstance(ldt, tvm.Stir) and ldt_dom.length == 1 << 23
    monkeypatch.setattr(config, "_device_memory_bytes", lambda dev: 80e9)
    run._expectations(tvm, stark, got, torch.device("cuda"))
    # with room for the codewords the port would cache, and the check
    # would stop the run
    monkeypatch.setattr(config, "_device_memory_bytes", lambda dev: 120e9)
    with pytest.raises(SystemExit, match="decides cached"):
        run._expectations(tvm, stark, got, torch.device("cuda"))


@pytest.fixture
def forced_jit():
    threads = torch.get_num_threads()
    config.overwrite_lde_trace_caching_to(config.CacheDecision.JIT)
    try:
        yield
    finally:
        config.overwrite_lde_trace_caching_to(None)
        torch.set_num_threads(threads)


def test_forced_jit_tiny_run_is_correct_and_equals_the_cached_proof(
        forced_jit, monkeypatch):
    """The harness's tiny size (port_bench/tests/data: spin.tasm at 2^9,
    32 bits), one step, untraced: no profiler session, so the coset
    counter stays where it was."""
    from triton_vm_tpu_torch.stark import jit_lde
    from triton_vm_tpu_torch.utils import profiler

    data = ROOT / "port_bench" / "tests" / "data"
    tiny = inputs.load_config(data / "fib_tiny.json", json.loads(
        (data / "tiny.json").read_text()))
    orig = tvm.prove
    calls = []

    def recording(*args, **kw):
        proof = orig(*args, **kw)
        calls.append((args, kw, proof))
        return proof

    monkeypatch.setattr(tvm, "prove", recording)
    counted = profiler.totals().count(jit_lde.JIT_COSETS)
    result = run.run_cell(BENCH, CELL, 2**33 + 21, 0.0, False, "cpu", ROOT,
                          inputs=tiny)
    assert result["correct"] is True
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["checks"]["proofs_checked"]["value"] == 1
    assert profiler.totals().count(jit_lde.JIT_COSETS) == counted

    (args, kw, proof), = calls
    config.overwrite_lde_trace_caching_to(None)
    assert orig(*args, **kw).words == proof.words
