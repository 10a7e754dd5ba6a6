"""The control of `correct`: the program run under a guarantee below the
one the configuration states, which the check has to find not correct.

    python3 -m port_bench.control --workload <cell> --seeds 11,12,13

runs, for each seed in one process, one step of the cell at its own size
with the program's Stark in the conjectured proximity regime (fewer
queries than the proven regime the configurations state: the step that
would tempt a later change), and prints each run's numbers compared. With
--sound the program keeps the stated parameters, for the readings of
sound runs. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import inputs, run

CONTROL = {"soundness": "conjectured"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--sound", action="store_true")
    args = parser.parse_args(argv)
    root = Path.cwd()
    bench = run.load_benchmark(root)
    cell = run.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell_inputs = inputs.load(cell, root / "port_bench")
        cell_inputs.traffic = dict(cell_inputs.traffic, warmup_steps=0)
        result = run.run_cell(bench, cell, seed, 0.0, False, "cuda", root,
                              None if args.sound else CONTROL, cell_inputs)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": not args.sound, "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "checks": {k: c["value"] for k, c in result["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
