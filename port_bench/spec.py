"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix, the limits of its output check, and the
modules (drivers, per-layer metric readers, references, work counts) that
live one to a file under ``port_bench/``."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _read(CHECKOUT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"it has {[c['name'] for c in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return {**_read(CHECKOUT / entry["file"]), "name": name}
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return {**_read(HERE / "traffic" / f"{name}.json"), "name": name}


def limits(cell_name: str) -> Dict[str, float]:
    return _read(HERE / "limits" / f"{cell_name}.json")


def module(kind: str, name: str) -> ModuleType:
    """``port_bench/<kind>/<name>.py``, loaded by path: a metric's name may
    hold dots (``step_host_ms.train``), which an import cannot."""
    path = HERE / kind / f"{name}.py"
    key = f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing: {kind} {name!r} has no module")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it under ``workloads``, and those without that key."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
