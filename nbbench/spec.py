"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
Everything that belongs to one of them is a file of its own under this
folder, found by its name:

* a cell (one entry of ``workloads``): ``cells/<workload>.json``, its
  traffic parameters and its limits;
* a configuration: ``configs/<config>.json``;
* a metric: ``metrics/<metric>.py``, a module with ``read(ctx)``.

Adding a cell, a configuration or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    """The `workloads` entry `name`; KeyError naming the known ones."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def cell(name: str, base: str = HERE) -> dict:
    return load(os.path.join(base, "cells", f"{name}.json"))


def config(name: str, base: str = HERE) -> dict:
    return load(os.path.join(base, "configs", f"{name}.json"))


def metrics(bench: dict, section: str, workload_name: str) -> list[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    workload reports: those with no `workloads` key, and those that list
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or workload_name in m["workloads"]]


def reader(name: str, base: str = HERE):
    """The `read` function of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"nbbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
