"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell's files are found by the names in BENCHMARK.json: its
configuration (benchmark/configs/), its traffic (benchmark/workloads/
<cell>.json), the configuration's driver (benchmark/drivers/), the
traffic's generator (benchmark/traffic/) and each per-layer metric's
reader (benchmark/metrics/<metric>.py). With ``--trace 0`` the line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from the traced window. The last lines on standard error, and the
result line's last key, give each number compared with its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


class Context:
    """What a driver is handed: the cell, the run's arguments and the
    device helpers."""

    def __init__(self, cell, seed, seconds, trace, device="cuda",
                 control=False, t_process=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.control = trace, device, control
        self.t_process = harness.process_start() if t_process is None \
            else t_process
        self.t_driver = time.time()
        self.cuda = str(device).startswith("cuda")
        if self.cuda:
            import torch
            self.card = torch.cuda.get_device_name(0)
        else:
            self.card = "cpu"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def traced(self):
        if not self.trace:
            return None
        from benchmark.trace import Traced
        traced = Traced()
        traced.warm()
        return traced

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        torch.cuda.synchronize()
        return int(max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count())))

    def free(self):
        import gc
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def per_layer(cell, rec) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer():
        value = harness.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell, res: dict, trace: bool, n_cards: int, card: str) -> dict:
    rec = res["record"]
    if trace:
        metrics = per_layer(cell, rec)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {"setup_s": {"value": res["setup_s"], "unit": "s"}}
        for name, value in res["e2e"].items():
            metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu", "kind": card, "count": n_cards,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["check"].correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    tr = rec.get("traced")
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps(rec["spans"])}
    line["setup_parts_s"] = res["setup_parts"]
    line["compared"] = res["check"].as_dict()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    driver = harness.load_module("drivers", cell.config["driver"])
    res = driver.run(ctx)
    t = time.perf_counter()
    line = result_line(cell, res, bool(args.trace), cell.chips, ctx.card)
    read_s = time.perf_counter() - t
    found = harness.loaded_forbidden()
    if found:
        print(f"run: the process loaded {found}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 4
    rates = [round(r, 2) for r in harness.slice_rates(res["frame_ms"])]
    print(f"run: setup parts {json.dumps(res['setup_parts'])}, judged in "
          f"{res['judge_s']:.1f} s, read in {read_s:.1f} s; frames/s by 5-s "
          f"slice {rates}", file=sys.stderr)
    if args.trace:
        rows = Counter(r[0] for r in res["record"]["program"])
        print(f"run: the program's span rows by name {json.dumps(rows)}",
              file=sys.stderr)
    for text in res["check"].lines():
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
