"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<name>.json``;
* a cell (workload): ``workloads/<name>.json``;
* a per-layer metric: ``metrics/<name>.py`` with ``read(ctx)``;
* a kernel's roofline: ``roofline/<kernel>.py`` with ``KERNELS`` and
  ``bound_s(ctx, launches)``;
* a met generator: ``mets/<name>.py``, named by a configuration's
  ``generator`` (``wind`` where it names none);
* a reference: ``references/<name>.py``, named by a configuration's
  ``reference`` (``plain`` where it names none);
* a driver: ``drivers/<name>.py``, named by a workload's ``driver``
  (``single`` where it names none).

Adding one is adding its file and, for a configuration, a cell or a
metric, its entry in ``BENCHMARK.json``.  README.md gives each kind's
contract.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: kind -> (the key of a configuration or workload that names its
#: module, the module where it names none)
NAMED_BY = {"mets": ("generator", "wind"),
            "references": ("reference", "plain"),
            "drivers": ("driver", "single")}


class RunError(RuntimeError):
    """A run that cannot give a result (printed, exit code 2)."""


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
    if not os.path.isfile(path):
        raise RunError(f"{kind}/{name}.py: no such file ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def roofline(kernel: str) -> ModuleType:
    return _module("roofline", kernel)


def name_of(kind: str, entry: dict) -> str:
    """The name of the ``kind`` module (``mets``, ``references``,
    ``drivers``) that a configuration or workload ``entry`` uses."""
    key, default = NAMED_BY[kind]
    return entry.get(key, default)


def met_generator(cfg: dict) -> ModuleType:
    return _module("mets", name_of("mets", cfg))


def reference(cfg: dict) -> ModuleType:
    return _module("references", name_of("references", cfg))


def driver(wl: dict) -> ModuleType:
    return _module("drivers", name_of("drivers", wl))


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list:
    """The metric entries that cell ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads``
    only in the cells it lists."""
    entries = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]
