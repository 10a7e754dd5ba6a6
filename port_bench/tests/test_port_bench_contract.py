"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of every name and unit, and every cell, configuration,
traffic mix and metric resolving to its files."""

import hashlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(LINE.match(w) for w in BENCH["command"])


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads")
                          else "metric", entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), entry[key]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metric_keys():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    from port_bench import inputs

    configs = {c["name"]: c for c in BENCH["configs"]}
    assert cell["config"] in configs
    assert cell["chips"] == 1
    got = inputs.load(cell, ROOT / "port_bench")
    assert got.config == cell["config"]
    assert got.traffic["ldt"] in ("fri", "stir")
    assert got.traffic["lde"] in ("cached", "jit")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_match_their_hashes(config):
    path = ROOT / config["file"]
    record = json.loads(path.read_text())
    assert record["name"] == config["name"]
    for key in ("program", "non_determinism"):
        if key in record:
            text = (path.parent / record[key]["file"]).read_bytes()
            assert hashlib.sha256(text).hexdigest() == record[key]["sha256"]
    for key in config["reduced"]:
        assert key in record


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert (ROOT / "port_bench" / "metrics" / f"{metric['name']}.py").exists()
