"""Finds everything of a cell by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration and traffic; the
configuration's file, ``traffic/<traffic>.json``, ``workloads/<cell>.json``
(the cell's correctness limits and traced calls) and one
``metrics/<metric>.py`` reader per per-layer metric sit beside this file."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(entries, name):
    return [m for m in entries if name in m.get("workloads", [name])]


def reader(name: str):
    """The reader module of a per-layer metric."""
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> dict:
    manifest = manifest if manifest is not None else load(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "workloads" / f"{name}.json") as f:
        own = json.load(f)
    return {"name": name, "chips": entry["chips"], "config": config,
            "config_name": conf["name"], "traffic": traffic,
            "traffic_name": entry["traffic"], "limits": own["limits"],
            "trace_calls": own["trace_calls"],
            "end_to_end": _for_cell(manifest["end_to_end"], name),
            "per_layer": _for_cell(manifest["per_layer"], name)}
