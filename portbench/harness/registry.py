"""Finds the benchmark's parts by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations,
traffic mixes and metrics. Everything else is a file found by one of
those names, so a new cell, mix, driver or metric is a new file:

    <configs entry "file">          the configuration (sizes as run)
    portbench/traffic/<traffic>.json  a traffic mix; its "driver" names
                                      portbench/drivers/<driver>.py
    portbench/workloads/<cell>.json   the cell's correctness limits
    portbench/metrics/<metric>.py     a metric's reader; a name with a dot
                                      falls back to the part before it
                                      (`idle_share.lm_train` ->
                                      metrics/idle_share.py)
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]          # portbench/
CHECKOUT = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark as `BENCHMARK.json` describes it, with its files under
    `root` (portbench/ by default; tests pass a copy)."""

    def __init__(self, spec_path: Optional[Path] = None,
                 root: Optional[Path] = None):
        self.root = Path(root) if root else ROOT
        self.checkout = self.root.parent
        self.spec_path = (Path(spec_path) if spec_path
                          else self.checkout / "BENCHMARK.json")
        self.spec = _load_json(self.spec_path)
        self._modules: Dict[str, ModuleType] = {}

    # -- cells -----------------------------------------------------------
    def cells(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r}; have {self.cells()}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _load_json(self.checkout / c["file"])
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return _load_json(self.root / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _load_json(self.root / "workloads" / f"{cell}.json")

    def traffic_names(self) -> List[str]:
        return sorted(p.stem for p in (self.root / "traffic").glob("*.json"))

    def driver_names(self) -> List[str]:
        return sorted(p.stem for p in (self.root / "drivers").glob("*.py")
                      if not p.stem.startswith("_"))

    def driver(self, kind: str) -> ModuleType:
        return self._module(self.root / "drivers" / f"{kind}.py",
                            f"portbench_driver_{kind}")

    # -- metrics ---------------------------------------------------------
    def metric_path(self, name: str) -> Path:
        base = self.root / "metrics"
        whole = base / f"{name}.py"
        return whole if whole.is_file() else base / f"{name.split('.')[0]}.py"

    def metric(self, name: str) -> ModuleType:
        path = self.metric_path(name)
        return self._module(path, f"portbench_metric_{path.stem}")

    def metrics_for(self, cell: str, section: str) -> List[dict]:
        """The entries of `section` ("end_to_end" or "per_layer") that a
        run of `cell` reports: those without a "workloads" key, and those
        whose key lists the cell."""
        return [m for m in self.spec[section]
                if "workloads" not in m or cell in m["workloads"]]

    def _module(self, path: Path, key: str) -> ModuleType:
        if key not in self._modules:
            self._modules[key] = _load_module(path, key)
        return self._modules[key]
