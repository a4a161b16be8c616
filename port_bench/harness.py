"""The benchmark's registry and its result line.

Everything that belongs to one configuration, traffic mix, window loop,
per-layer metric or kernel count sits in a file of its own under this
folder, found by the name BENCHMARK.json gives it:

    configs/<config>.json     the scene, its render or fit settings, source
    workloads/<cell>.json     config, traffic, chips and the check's limits
    traffic/<mix>.json        the mix's parameters, and the loop it runs on
    loops/<loop>.py           a general window loop (render, fit, sharded)
    metrics/<metric>.py       the reader of one metric: UNIT, LAYER, read()
    counts/<kernel>.py        the frozen operation and byte count of a kernel
    peaks.json                the card's published peaks

A cell is added by adding files and entries: nothing here names a cell.
A cell whose files are here but that BENCHMARK.json does not list is run
by hand and by the tests, never by a check, and reports only setup_s.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a process that reports:
# the JAX package this program was ported from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "rays1bench_tpu")


def load_json(kind: str, name: str, root: pathlib.Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
    """The module in <kind>/<name>.py, loaded from its file (names may hold
    dots, as metric names do)."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_cells(root: pathlib.Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The workload with its configuration and traffic mix loaded:
    {"name", "chips", "limits", "config": {...}, "traffic": {...}}."""
    w = load_json("workloads", name, root)
    if w["name"] != name:
        raise ValueError(f"workloads/{name}.json names itself {w['name']}")
    return dict(w, config=load_json("configs", w["config"], root),
                traffic=load_json("traffic", w["traffic"], root))


def benchmark_file(root: pathlib.Path = ROOT) -> dict:
    with open(root.parent / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The names of the metrics a run of cell `name` reports: with trace,
    the per-layer metrics whose `workloads` hold it; without, its
    end-to-end ones (those without `workloads` in every cell)."""
    if trace:
        return [m["name"] for m in bench["per_layer"]
                if name in m["workloads"]]
    return [m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def read_metrics(names, result: dict, root: pathlib.Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in the loop's result; the others are left out."""
    out = {}
    for name in names:
        mod = load_module("metrics", name, root)
        value = mod.read(result, root)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def unread(names, metrics: dict) -> list:
    """The metrics of `names` that read_metrics found nothing for: on the
    card each is a fault of the run (a kernel renamed or taken off the
    path leaves its roofline nothing to read), not a metric to leave out."""
    return [n for n in names if n not in metrics]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def checks_text(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The last line of standard output; the numbers compared
    come last, under "checks"."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and none missing or not finite (shown as null)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        if v is not None and not math.isfinite(v):
            v = None
        checks[name] = {"value": v, "limit": limit}
        if v is None or not v <= limit:
            ok = False
    return ok, checks
