"""Read the numbers that decide ``correct`` over many seeds, for the
program and for its control, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

The control is the plain reference computed in the configuration's
``control_dtype`` (bfloat16 for the float32 configurations), put in the
program's place for every answer the judge samples. Each seed runs the
cell's set-up and a window of ``seconds``, then judges the program and
the control; one JSON line a seed, then each number's largest program
reading and smallest control reading. The limits in the configuration
files are set from these readings (PERF.md). The benchmark's own runs
never run the control. Needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def readings(cell, seeds, seconds, device="cuda", log=print):
    """[(seed, program {name: value}, control {name: value})]."""
    rows = []
    driver = harness.load_module("drivers", cell.config["driver"])
    for seed in seeds:
        ctx = Context(cell, seed, seconds, False, device=device, control=True)
        res = driver.run(ctx)
        prog = {n: v for n, v, _, _ in res["check"].rows}
        ctrl = {n: v for n, v, _, _ in res["control"].rows}
        rows.append((seed, prog, ctrl))
        log(json.dumps({"seed": seed, "correct": res["check"].correct,
                        "control_correct": res["control"].correct,
                        "program": prog, "control": ctrl,
                        "frames": res["attempted"]}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None

    def log(text):
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    rows = readings(cell, args.seeds, args.seconds, log=log)
    names = rows[0][1].keys()
    log(json.dumps({"workload": args.workload, "seeds": len(rows),
                    "program_max": {n: max(r[1][n] for r in rows)
                                    for n in names},
                    "control_min": {n: min(r[2][n] for r in rows)
                                    for n in names}}))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
