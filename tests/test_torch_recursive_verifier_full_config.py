"""The benchmark's configuration recursive_verifier_full
(port_bench/configs/recursive_verifier_full.json) and its cell
recursive_verifier_full.h21: BASELINE config 5 uncut, the in-VM verifier
checking all 173 revealed indices. Its frozen files against their
SHA-256, nothing cut; the reference's digest of the frozen program
against the port's; the port's VM tracing the frozen program with the
frozen non-determinism to a halt with no output, at the table heights
of the full check (padded height 2^21); the traffic's low-degree test and
JIT decision at 2^21 on an 80-GB card."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

import triton_vm_tpu_torch as tvm
from port_bench import inputs, run
from port_bench.reference import assembler, verifier
from triton_vm_tpu_torch import config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "port_bench" / "configs"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = next(c for c in BENCH["workloads"]
            if c["name"] == "recursive_verifier_full.h21")
# the full check's table heights, those of the JAX package's trace
# (chip_smoke.py's RV_CELLS): every table at recursive size
HEIGHTS = dict(processor=795143, op_stack=1238250, ram=538637, hash=903712,
               program=1313740, cascade=65536, lookup=256, u32=11017,
               jump_stack=795143)


def _record():
    return json.loads((CONFIGS / "recursive_verifier_full.json").read_text())


@pytest.fixture(scope="module")
def cell_inputs():
    return inputs.load(CELL, ROOT / "port_bench")


@pytest.fixture(scope="module")
def program(cell_inputs):
    return tvm.triton_program(cell_inputs.program_text)


def test_frozen_files_match_their_hashes_and_nothing_is_cut():
    record = _record()
    for key in ("program", "non_determinism"):
        text = (CONFIGS / record[key]["file"]).read_bytes()
        assert hashlib.sha256(text).hexdigest() == record[key]["sha256"]
    assert record["non_determinism"]["sha256"] != json.loads(
        (CONFIGS / "recursive_verifier.json").read_text()
    )["non_determinism"]["sha256"]
    assert record["revealed_indices"] == 173 and "published" not in record
    config_entry = next(c for c in BENCH["configs"]
                        if c["name"] == "recursive_verifier_full")
    assert config_entry["reduced"] == []
    assert record["stark"] == {"security_level": 160,
                               "log2_expansion_factor": 2,
                               "soundness": "proven"}
    assert record["heights"] == {"21": {"public_input": [], "output": [],
                                        "cycles": HEIGHTS["processor"]}}


def test_reference_digest_is_the_ports(cell_inputs, program):
    words = assembler.assemble(cell_inputs.program_text)
    assert words == [int(w) for w in program.to_bwords()]
    assert len(words) + 1 <= HEIGHTS["program"]
    assert verifier.program_digest(words) == tuple(
        int(x) for x in program.hash())


def test_the_ports_vm_runs_the_full_check(cell_inputs, program):
    """The program halts only if all 173 in-VM checks passed."""
    nondet = run._non_determinism(tvm, cell_inputs.non_determinism)
    aet, output = tvm.VM.trace_execution(program, tvm.PublicInput([]),
                                         nondet)
    assert list(output) == []
    assert {t: aet.height_of_table(t) for t in HEIGHTS} == HEIGHTS
    assert aet.padded_height() == 1 << 21


def test_h21_takes_stir_and_the_jit_lde(cell_inputs, monkeypatch):
    """The harness's own check before the window: at 80 GB free the port
    decides JIT for the 2^24-row LDT domain, and STIR is the low-degree
    test."""
    got = cell_inputs
    assert (got.log2_padded_height, got.traffic["ldt"],
            got.traffic["lde"], got.traffic["warmup_steps"]) == (
                21, "stir", "jit", 1)
    stark = run._stark(tvm, got.stark, "cpu", None)
    ldt, *_, ldt_dom = stark.derive_domains(1 << 21)
    assert isinstance(ldt, tvm.Stir) and ldt_dom.length == 1 << 24
    monkeypatch.setattr(config, "_device_memory_bytes", lambda dev: 80e9)
    run._expectations(tvm, stark, got, torch.device("cuda"))
    # with room for the codewords the port would cache, and the check
    # would stop the run
    monkeypatch.setattr(config, "_device_memory_bytes", lambda dev: 240e9)
    with pytest.raises(SystemExit, match="decides cached"):
        run._expectations(tvm, stark, got, torch.device("cuda"))
