"""Cells shrunk to sizes a CPU test holds, driving the same code: all-pairs
at 1,024 bodies, Barnes-Hut at 4,096 (grid depth 3, which the port's
auto depth also picks there, with ``--algo barnes-hut``: auto would take
all-pairs below 32,768 bodies, and ``--bh-traversal fused``: the CPU's
auto is the list path)."""

from __future__ import annotations

from nbbench import spec


def small(name: str):
    """(cell, config, extra CLI flags) of workload `name` at a CPU size."""
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    if config["force"] == "allpairs":
        return cell, {**config, "n": 1024}, ()
    return cell, {**config, "n": 4096, "ld": 3}, ("--algo", "barnes-hut",
                                                  "--bh-traversal", "fused")
