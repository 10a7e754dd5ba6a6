"""A cell's inputs, found by name: its configuration's frozen files under
configs/ (checked against the SHA-256 each is recorded with) and its
traffic mix under traffic/.

A configuration file, configs/<config>.json, names its program
(<config>.tasm, which the program and the reference each assemble),
optionally its non-determinism (<config>.nondet.json), the Stark parameters it is proven
with, and for each padded height it runs at the public input and the
expected output, and optionally the name of the program's plain model
(reference/programs.py), from which the reference works the output out
again. A traffic mix, traffic/<traffic>.json, is the work of
one run: see traffic.py.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Inputs:
    config: str
    traffic: dict
    stark: dict
    program_text: str
    public_input: list
    output: list
    non_determinism: dict | None
    log2_padded_height: int
    model: str | None = None


def _frozen(directory: Path, entry: dict):
    text = (directory / entry["file"]).read_text()
    if hashlib.sha256(text.encode()).hexdigest() != entry["sha256"]:
        raise ValueError(f"{entry['file']} does not match its SHA-256")
    return text


def load(cell: dict, root: Path = HERE) -> Inputs:
    """The inputs of `cell` (a `workloads` entry of BENCHMARK.json)."""
    traffic = json.loads(
        (root / "traffic" / f"{cell['traffic']}.json").read_text())
    return load_config(root / "configs" / f"{cell['config']}.json", traffic)


def load_config(path: Path, traffic: dict) -> Inputs:
    config = json.loads(path.read_text())
    directory = path.parent
    log2 = traffic["log2_padded_height"]
    at = config["heights"].get(str(log2))
    if at is None:
        raise ValueError(f"{config['name']} does not run at padded height "
                         f"2^{log2}; it runs at 2^"
                         + ", 2^".join(sorted(config["heights"])))
    nondet = None
    if "non_determinism" in config:
        nondet = json.loads(_frozen(directory, config["non_determinism"]))
    return Inputs(
        config=config["name"], traffic=traffic, stark=config["stark"],
        program_text=_frozen(directory, config["program"]),
        public_input=list(at["public_input"]), output=list(at["output"]),
        non_determinism=nondet, log2_padded_height=log2,
        model=config.get("model"))
