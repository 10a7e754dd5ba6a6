"""The master AIR at one point: the constraints of air_constraints.json
(frozen data; PERF.md gives the command that wrote it) evaluated over XFE rows, and the 63 challenges
(59 sampled, 4 derived: triton-vm/src/challenges.rs:48-124)."""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

from . import xfe
from .tip5 import LOOKUP_TABLE

HERE = Path(__file__).resolve().parent
PHASES = ("init", "cons", "tran", "term")
SAMPLE_COUNT = 59
# indices in the 63-slot challenge list (triton-air/src/challenge_id.rs)
COMPRESS_PROGRAM_DIGEST = 0
STANDARD_INPUT = 1
STANDARD_OUTPUT = 2
LOOKUP_TABLE_PUBLIC = 54


@functools.lru_cache(maxsize=1)
def constraints() -> dict:
    """{phase: {"steps", "out", "max_degree"}}, checked against its
    recorded SHA-256."""
    text = (HERE / "air_constraints.json").read_text()
    want = (HERE / "air_constraints.sha256").read_text().strip()
    if hashlib.sha256(text.encode()).hexdigest() != want:
        raise ValueError("air_constraints.json does not match its SHA-256")
    return json.loads(text)


def num_constraints() -> int:
    return sum(len(constraints()[p]["out"]) for p in PHASES)


def max_degrees() -> dict:
    return {p: constraints()[p]["max_degree"] for p in PHASES}


def evaluate(phase, main_row, aux_row, challenges, next_main_row=None,
             next_aux_row=None) -> list:
    """The phase's constraints at one point; rows are lists of XFE
    tuples. Returns one XFE a constraint."""
    rows = {"main": main_row, "aux": aux_row, "next_main": next_main_row,
            "next_aux": next_aux_row}
    env = {}
    for nid, kind, payload in constraints()[phase]["steps"]:
        if kind == "bconst":
            env[nid] = xfe.lift(payload)
        elif kind == "xconst":
            env[nid] = tuple(payload)
        elif kind == "challenge":
            env[nid] = tuple(challenges[payload])
        elif kind == "input":
            env[nid] = tuple(rows[payload[0]][payload[1]])
        else:
            op, lhs, rhs = payload
            env[nid] = (xfe.add if op == "+" else xfe.mul)(env[lhs], env[rhs])
    return [env[i] for i in constraints()[phase]["out"]]


def _eval_terminal(symbols, challenge, initial=xfe.ONE):
    """EvalArg::compute_terminal (cross_table_argument.rs:66-82)."""
    acc = initial
    for s in symbols:
        acc = xfe.add(xfe.mul(challenge, acc), xfe.lift(s))
    return acc


def challenges(sampled, claim) -> list:
    """The 59 sampled challenges followed by the 4 derived terminals:
    standard input, standard output, the lookup table's public terminal
    and the compressed program digest (challenges.rs:83-119)."""
    if len(sampled) != SAMPLE_COUNT:
        raise ValueError("59 challenges are sampled")
    ch = list(sampled)
    ch.append(_eval_terminal(claim.input, ch[STANDARD_INPUT]))
    ch.append(_eval_terminal(claim.output, ch[STANDARD_OUTPUT]))
    ch.append(_eval_terminal(LOOKUP_TABLE, ch[LOOKUP_TABLE_PUBLIC]))
    ch.append(_eval_terminal(claim.program_digest,
                             ch[COMPRESS_PROGRAM_DIGEST]))
    return ch
