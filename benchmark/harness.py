"""What every cell shares: finding a cell's files by name, timing, spans,
the comparison record, the result line and the check that no JAX module
was loaded. Configurations, traffic, drivers and per-layer metrics live in
files of their own under benchmark/ and are found by the names in
BENCHMARK.json.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# whole top-level module names a run may not load; kornia_tpu_torch is
# the program and begins with one of them, so names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "kornia_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod_name = f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location(mod_name, path))
    sys.modules[mod_name] = mod
    mod.__spec__.loader.exec_module(mod)
    return mod


def held_metrics(name: str) -> dict:
    """benchmark/held/<name>.json, the metric entries of a held cell, or
    none."""
    path = os.path.join(BENCH, "held", name + ".json")
    return load_json(path) if os.path.isfile(path) else {}


class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    files loaded."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench or spec()
        self.bench = bench
        self.name = name
        path = os.path.join(BENCH, "workloads", name + ".json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name and not os.path.isfile(path):
            raise KeyError(f"unknown workload {name!r}; known: "
                           f"{sorted(by_name)}")
        self.traffic = load_json(path)
        # a cell held out of BENCHMARK.json (PERF.md, Open questions) is
        # found by its files alone, and its metrics by held/<cell>.json,
        # entries in BENCHMARK.json's form that name only held cells. Once
        # the cell is listed, BENCHMARK.json alone holds for it.
        self.entry = by_name.get(name)
        if self.entry is None:
            self.entry = {"name": name, "chips": 1,
                          "config": self.traffic.get("config")}
            held = held_metrics(name)
            self.bench = dict(bench, **{
                kind: bench[kind] + held.get(kind, [])
                for kind in ("end_to_end", "per_layer")})
        self.config = load_json(os.path.join(
            BENCH, "configs", self.entry["config"] + ".json"))
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose moved metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def process_start() -> float:
    """This process's start on the time.time() clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


class Spans:
    """Host-clock spans (perf_counter_ns) around calls into the program's
    layers; off unless ``on``."""

    def __init__(self, on: bool):
        self.on = on
        self.rows: List[tuple] = []      # (name, t0_ns, t1_ns, tag)
        self.tag = None                  # the driver's current frame

    def wrap(self, name: str, fn: Callable, result_tag=None) -> Callable:
        if not self.on:
            return fn

        def timed(*a, **kw):
            t0 = time.perf_counter_ns()
            out = None
            try:
                out = fn(*a, **kw)
                return out
            finally:
                self.rows.append((name, t0, time.perf_counter_ns(),
                                  (self.tag, result_tag(out)
                                   if result_tag else None)))
        return timed

    def of(self, name: str) -> List[tuple]:
        return [r for r in self.rows if r[0] == name]


OUTSIDE = "between calls"


class SpanIndex:
    """The innermost span at a time, by lookup over rows (name, t0_ns,
    t1_ns, tag) that nest, as the rows of one thread do (the harness's and
    the program's together): rows sorted by start, each with the nearest
    earlier row that encloses it; a time's innermost row is found by
    bisection and a walk out through the enclosing rows. The label is the
    shortest row that holds the time, the first in row order among equals;
    a row of zero width holds no time."""

    def __init__(self, rows: List[tuple]):
        order = sorted(range(len(rows)),
                       key=lambda i: (rows[i][1], -rows[i][2], -i))
        self.rows = [rows[i] for i in order]
        self.starts = [r[1] for r in self.rows]
        self.parent: List[int] = []
        open_: List[int] = []
        for k, (_, t0, _, _) in enumerate(self.rows):
            while open_ and self.rows[open_[-1]][2] <= t0:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(k)

    def find(self, t_ns: int) -> int:
        """The sorted position of the innermost row holding ``t_ns``, or
        -1."""
        k = bisect.bisect_right(self.starts, t_ns) - 1
        while k >= 0 and not t_ns < self.rows[k][2]:
            k = self.parent[k]
        return k

    def innermost(self, t_ns: int) -> str:
        k = self.find(t_ns)
        return OUTSIDE if k < 0 else self.rows[k][0]


class Check:
    """The numbers compared against their limits; ``correct`` is all of
    them within."""

    def __init__(self):
        self.rows: List[tuple] = []      # (name, value, limit, kind)

    def at_most(self, name: str, value: float, limit: float):
        self.rows.append((name, float(value), float(limit), "<="))

    def at_least(self, name: str, value: float, limit: float):
        self.rows.append((name, float(value), float(limit), ">="))

    @property
    def correct(self) -> bool:
        if not self.rows:
            return False
        for _, v, lim, kind in self.rows:
            ok = v <= lim if kind == "<=" else v >= lim
            if not ok or v != v:
                return False
        return True

    def as_dict(self) -> Dict[str, dict]:
        return {n: {"value": v, "limit": lim, "pass": kind}
                for n, v, lim, kind in self.rows}

    def lines(self) -> List[str]:
        return [f"check {n}: {v!r} (limit {kind} {lim!r})"
                for n, v, lim, kind in self.rows]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def percentile(vals, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(vals, np.float64), q))


def slice_rates(ms, width_s: float = 5.0) -> List[float]:
    """Frames a second in consecutive ``width_s`` slices of a window of
    back-to-back frame times (a drift shows as a trend)."""
    out, acc, n = [], 0.0, 0
    for m in ms:
        acc += m / 1e3
        n += 1
        if acc >= width_s:
            out.append(n / acc)
            acc, n = 0.0, 0
    return out


def reservoir(rng, k: int):
    """A seeded reservoir sample of ``k`` items of a stream: call
    ``offer(i, make)`` for item i; ``make()`` builds what is kept."""
    kept: Dict[int, object] = {}

    def offer(i: int, make: Callable):
        if i < k:
            kept[i] = make()
            return
        j = int(rng.integers(0, i + 1))
        if j < k:
            kept.pop(sorted(kept)[j])
            kept[i] = make()

    return kept, offer
