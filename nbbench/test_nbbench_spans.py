"""CPU tests of the readers of the port's spans: each on a synthetic span
table gives the value computed by hand, and None where its spans are
absent; on a traced CPU run of a Barnes-Hut cell they read the port's
recorder."""

import types

import pytest
import torch

from nbbench import run, spec
from nbbench.small import small

CPU = torch.device("cpu")
SPAN_METRICS = ["bh_sort_ms", "bh_grid_ms", "bh_groups_ms", "bh_rebuild_ms", "bh_resort_ms",
                "bh_probe_ms", "bh_host_syncs_per_step", "bh_host_sync_ms_per_step"]


def _row(count, host_s, device_s):
    return {"count": count, "host_s": host_s, "device_s": device_s}


# two 10-step jobs of a persistent cell: 2 probes, 22 evaluations, 4 resorts
TABLE = {
    "bh.probe": _row(2, 0.030, 0.018),
    "bh.sort": _row(24, 0.012, 0.0096),
    "bh.grid": _row(24, 0.006, 0.0072),
    "bh.groups": _row(24, 0.020, 0.0168),
    "bh.rebuild": _row(22, 0.015, 0.0264),
    "bh.resort": _row(4, 0.004, 0.0128),
    "integrate.step": _row(20, 0.150, 0.140),
    "host_sync.capacity.free_bytes": _row(24, 0.0024, 0.0),
    "host_sync.probe.stats": _row(4, 0.0016, 0.0),
    "host_sync.persistent.guard": _row(6, 0.0030, 0.0),
}
WANT = {
    "bh_sort_ms": 0.4,  # 9.6 ms over 24
    "bh_grid_ms": 0.3,
    "bh_groups_ms": 0.7,
    "bh_rebuild_ms": 1.2,
    "bh_resort_ms": 3.2,
    "bh_probe_ms": 9.0,
    "bh_host_syncs_per_step": 34 / 20,
    "bh_host_sync_ms_per_step": 1e3 * 0.0070 / 20,
}
# the span each reader cannot do without
NEEDS = {"bh_sort_ms": "bh.sort", "bh_grid_ms": "bh.grid", "bh_groups_ms": "bh.groups",
         "bh_rebuild_ms": "bh.rebuild", "bh_resort_ms": "bh.resort",
         "bh_probe_ms": "bh.probe", "bh_host_syncs_per_step": "integrate.step",
         "bh_host_sync_ms_per_step": "integrate.step"}


def _ctx(table):
    return types.SimpleNamespace(spans=table)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_synthetic_table(name):
    read = spec.reader(name)
    assert read(_ctx(TABLE)) == pytest.approx(WANT[name], rel=1e-12)
    without = {k: v for k, v in TABLE.items() if k != NEEDS[name]}
    assert read(_ctx(without)) is None
    assert read(_ctx({})) is None


@pytest.mark.parametrize("name", SPAN_METRICS[:6])
def test_device_times_need_the_card(name):
    """A table recorded on the CPU has no device seconds: no device metric."""
    cpu = {k: _row(v["count"], v["host_s"], None) for k, v in TABLE.items()}
    assert spec.reader(name)(_ctx(cpu)) is None


def test_no_host_sync_is_zero_a_step():
    steps_only = {"integrate.step": _row(10, 0.1, None)}
    assert spec.reader("bh_host_syncs_per_step")(_ctx(steps_only)) == 0.0
    assert spec.reader("bh_host_sync_ms_per_step")(_ctx(steps_only)) == 0.0


def test_entries_name_their_cells_and_layers():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in SPAN_METRICS}
    assert set(entries) == set(SPAN_METRICS)
    for m in entries.values():
        assert m["moves"] == "body_steps_per_s.bh" and m["better"] == "lower"
        assert set(m["workloads"]) <= {"bh1m-f32", "bh1m-f32-resort4"}


def test_traced_cpu_run_reads_the_ports_recorder():
    """A traced run of the persistent cell at a CPU size: the recorder holds
    the profiled jobs, so the host-sync readers read them (the device
    times stay None off the card)."""
    from nbody_tpu_torch.diag import timing

    timing.clear()
    cell, config, extra = small("bh1m-f32-resort4")
    bench = spec.benchmark()
    res = run.run_cell("bh1m-f32-resort4", 2**31 + 7, 0.1, True, CPU, bench=bench, cell=cell,
                       config=config, extra=extra)
    table = timing.summary()
    assert table["integrate.step"]["count"] == run.TRACE_JOBS * cell["steps_per_job"]
    assert table["bh.probe"]["count"] == run.TRACE_JOBS
    assert res["metrics"]["bh_host_syncs_per_step"]["value"] == pytest.approx(
        sum(v["count"] for k, v in table.items() if k.startswith("host_sync."))
        / table["integrate.step"]["count"])
    assert "bh_rebuild_ms" not in res["metrics"] and "bh_sort_ms" not in res["metrics"]
    timing.clear()
