"""Readings that set a cell's limits. Not run by the benchmark's own runs;
run on the card:

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 [--seconds 5]

For each seed, one process sets the cell up at its own size, runs a short
window, and prints one JSON line: the program's numbers against the plain
reference (``program``; with ``--program-only`` nothing more), the
control's (``control``: the reference computed in TF32, the precision below
the configuration's float32 with TF32 off, put in the program's place) and,
for a kind that names ``FAULTS``, each fault planted in the reference put in
the program's place (a training cell's: half the batch left out, the mean
taken over the rest; the fastest lane's learning rate doubled), and the
look at the widest gaps (``look``). A state left unchanged reads 1 by the
training comparison's measure and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

from . import run as harness


def readings(name: str, seeds: List[int], seconds: float, root: str = ".",
             program_only: bool = False) -> List[dict]:
    from . import common

    cell = harness.load_cell(name, root)
    out = []
    for seed in seeds:
        with common.precision(False):
            kind = cell.kind.Kind(cell.configs, cell.workload["params"], seed, "cuda:0")
            kind.setup()
            kind.window(seconds)
            program = kind.outputs()
            kind.release()
            reference = kind.reference()
        row = {"seed": seed, "program": kind.compare(program, reference)}
        out.append(row)
        if program_only:
            continue
        with common.precision(False):
            control = kind.reference(tf32=True)
        row["control"] = kind.compare(control, reference)
        for fault in getattr(cell.kind, "FAULTS", ()):
            with common.precision(False):
                row[fault] = kind.compare(kind.reference(fault=fault), reference)
        if hasattr(kind, "look"):
            row["look"] = {"program": kind.look(program, reference),
                           "control": kind.look(control, reference)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    rows = readings(args.workload, seeds, args.seconds, program_only=args.program_only)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(f"{args.workload}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
