"""Finds every piece of a cell by its name: the cell's entry in
``BENCHMARK.json`` names its configuration and its traffic mix,
``workloads/<cell>.json`` its loop, check and limits; ``configs/<config>.json``
and ``.py``, ``traffic/<traffic>.json``, ``loops/<loop>.py``,
``metrics/<metric>.py`` and ``roofline/<function>.py`` are loaded from the
benchmark's folder by those names. Adding a cell, a mix, a metric or a
roofline is adding files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]        # the benchmark's folder
REPO = ROOT.parent                                 # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file of the benchmark as a module (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_dyn.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(cell: str, bench: dict | None = None) -> dict:
    """The cell's ``BENCHMARK.json`` entry (name, config, traffic, chips,
    why) with its loop, check and limits from ``workloads/<cell>.json``."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    return {**load_json(ROOT / "workloads" / f"{cell}.json"), **entry}


def config(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def config_module(name: str):
    return load_module(ROOT / "configs" / f"{name}.py", f"configs.{name}")


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def loop_module(name: str):
    return load_module(ROOT / "loops" / f"{name}.py", f"loops.{name}")


def metric_module(name: str):
    return load_module(ROOT / "metrics" / f"{name}.py", f"metrics.{name}")


def roofline_module(name: str):
    return load_module(ROOT / "roofline" / f"{name}.py", f"roofline.{name}")


def cell_metrics(cell: str, bench: dict) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metric entries that this cell reports."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
