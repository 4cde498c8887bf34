"""What a run measures, read from data: ``BENCHMARK.json`` at the root of the
checkout, a configuration's file ``configs/<config>.json``, a cell's file
``workloads/<cell>.json`` (its traffic and the limits of its comparison)
and a metric's reader ``metrics/<metric>.py``. A later cell, configuration
or metric is a new file found by its name; no code names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> Dict[str, dict]:
    """``{"entry", "config", "cell"}``: the cell's entry in
    ``BENCHMARK.json``, its configuration's file and its own file, checked
    against each other."""
    bench = benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())
    own = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return {"entry": entry, "config": conf, "cell": own}


def metrics_of(name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, that list the cell or list none."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``: the metric's value, or
    ``None`` where the run holds nothing it can read."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
