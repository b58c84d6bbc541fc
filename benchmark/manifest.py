"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<name>.json``;
* a cell (workload): ``workloads/<name>.json``;
* a per-layer metric: ``metrics/<name>.py`` with ``read(ctx)``;
* a kernel's roofline: ``roofline/<kernel>.py`` with ``KERNELS`` and
  ``bound_s(ctx, launches)``.

Adding one is adding its file and its entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, name + ".json")
    with open(path) as f:
        data = json.load(f)
    data.setdefault("name", name)
    return data


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def _module(kind: str, name: str) -> ModuleType:
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def roofline(kernel: str) -> ModuleType:
    return _module("roofline", kernel)


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list:
    """The metric entries that cell ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads``
    only in the cells it lists."""
    entries = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]
