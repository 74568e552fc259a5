"""Finding a cell's parts by name: ``workloads/<cell>.json``,
``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``drivers/<driver>.py`` and
``reference/<module>.py``.  Adding a cell, a mix or a metric adds files;
nothing here lists them."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    spec = _json("workloads", name)
    spec["name"] = name
    return spec


def config(name: str) -> dict:
    spec = _json("configs", name)
    spec["name"] = name
    return spec


def traffic(name: str) -> dict:
    spec = _json("traffic", name)
    spec["name"] = name
    return spec


def _module(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module(BENCH / "drivers" / f"{name}.py", f"bench_driver_{name}")


def reference(name: str) -> ModuleType:
    return _module(BENCH / "reference" / f"{name}.py",
                   f"bench_reference_{name}")


def metric(name: str) -> ModuleType:
    mod = _module(BENCH / "metrics" / f"{name}.py",
                  "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    mod.NAME = name
    return mod


def metric_names() -> List[str]:
    return sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py")
                  if not p.name.startswith("_"))


def metrics_for(driver_name: str) -> Dict[str, ModuleType]:
    """Every per-layer metric whose reader serves ``driver_name``."""
    out = {}
    for name in metric_names():
        mod = metric(name)
        if mod.DRIVER == driver_name:
            out[name] = mod
    return out
