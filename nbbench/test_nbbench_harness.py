"""CPU tests of the harness: generators, discovery, the end-to-end
arithmetic and the result line."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nbbench import gen, run, spec
from nbbench.small import small

CPU = torch.device("cpu")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_uniform_pool_is_seeded_and_repeatable(dtype):
    big = 2**31 + 12345
    a = gen.make_pool("uniform", 500, 3, big, dtype, CPU)
    b = gen.make_pool("uniform", 500, 3, big, dtype, CPU)
    c = gen.make_pool("uniform", 500, 3, big + 1, dtype, CPU)
    for (pa, va, ma), (pb, vb, mb) in zip(a, b):
        assert torch.equal(pa, pb) and torch.equal(va, vb) and torch.equal(ma, mb)
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])  # the pool's inputs differ
    pos, vel, mass = a[0]
    assert pos.dtype == gen.DTYPES[dtype] and pos.shape == (500, 3) and mass.shape == (500,)
    assert pos.abs().max() <= 2 and vel.abs().max() <= 1
    assert 0.04 <= mass.min() and mass.max() <= 1


def test_plummer_escapers_pool_is_seeded_and_repeatable():
    a = gen.make_pool("plummer_escapers", 300, 2, 7, "f32", CPU)
    b = gen.make_pool("plummer_escapers", 300, 2, 7, "f32", CPU)
    assert all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))
    r = a[0][0][:8].double().norm(dim=1)
    assert (r > 299).all() and (r < 1001).all()


def test_frozen_generators_match_the_ports_fixtures():
    from nbody_tpu_torch.utils import fixtures

    arr = gen.plummer_cloud(400, seed=5)
    np.testing.assert_array_equal(arr, fixtures.plummer_cloud(400, seed=5))
    np.testing.assert_array_equal(gen.with_escapers(arr), fixtures.with_escapers(arr))


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError, match="unknown distribution"):
        gen.make_pool("nope", 10, 1, 0, "f32", CPU)


def test_every_workload_and_metric_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        config = spec.config(w["config"])
        assert any(c["name"] == w["config"] and c["file"].endswith(f"{w['config']}.json")
                   for c in bench["configs"])
        assert config["name"] == w["config"]
        assert set(cell["limits"]) == {"pos_gap", "vel_gap"}
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert callable(spec.reader(m["name"]))


def test_a_cell_added_as_a_file_is_found(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(spec.cell("exh100k-f32"), name="exh100k-f32-pool8", pool=8)
    (base / "cells" / "exh100k-f32-pool8.json").write_text(json.dumps(new))
    (base / "metrics" / "twice_setup_s.py").write_text(
        "def read(ctx):\n    return 2 * ctx.setup_s\n")
    assert spec.cell("exh100k-f32-pool8", base=str(base))["pool"] == 8
    ctx = run.WindowCtx(durations=[1.0], window_s=1.0, setup_s=3.0, n=1, steps_per_job=1)
    assert spec.reader("twice_setup_s", base=str(base))(ctx) == 6.0
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in spec.metrics(bench, "per_layer", "y")] == ["a"]
    assert [m["name"] for m in spec.metrics(bench, "per_layer", "x")] == ["a", "b"]


def _window(durations, n=1000, steps=10):
    return run.WindowCtx(durations=durations, window_s=sum(durations), setup_s=1.0,
                         n=n, steps_per_job=steps)


def test_rate_is_all_the_work_over_all_the_window():
    rate = spec.reader("body_steps_per_s")
    steady = _window([0.1] * 100)
    stalled = _window([0.1] * 99 + [5.1])  # one job stalls 5 s
    assert rate(steady) == pytest.approx(1000 * 10 * 100 / 10.0)
    assert rate(stalled) == pytest.approx(1000 * 10 * 100 / 15.0)


@pytest.mark.parametrize("slow,want", [(5, 0.1), (6, 2.0), (1, 0.1)])
def test_p95_is_over_every_job_not_chunk_medians(slow, want):
    p95 = spec.reader("job_s_p95")
    d = [0.1] * (100 - slow) + [2.0] * slow
    assert p95(_window(d)) == want
    # a window with one stalled job: its tail is the stall where the job
    # lies in the top 5 %, whatever the medians of chunks of jobs say
    assert p95(_window([0.1] * 19 + [9.0])) == 0.1
    assert p95(_window([0.1] * 9 + [9.0])) == 9.0


def test_result_line_keys_on_the_cpu():
    cell, config, extra = small("exh100k-f32")
    bench = spec.benchmark()
    res = run.run_cell("exh100k-f32", 2**31 + 3, 0.2, False, CPU, bench=bench, cell=cell,
                       config=config, extra=extra)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.metrics(bench, "end_to_end", "exh100k-f32")}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["check"]) == {"pos_gap", "vel_gap"}
    json.dumps(res)


def test_traced_result_line_keys_on_the_cpu():
    cell, config, extra = small("exh100k-f32")
    bench = spec.benchmark()
    res = run.run_cell("exh100k-f32", 11, 0.1, True, CPU, bench=bench, cell=cell,
                       config=config, extra=extra)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "check"]
    assert res["attempted"] >= run.TRACE_JOBS + 1
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    names = {m["name"] for m in spec.metrics(bench, "per_layer", "exh100k-f32")}
    assert set(res["metrics"]) <= names  # the CPU runs no kernel: no roofline
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "exh100k-f32", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    import subprocess

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "nbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load(os.path.join(spec.ROOT, "BENCHMARK.json"))
    p = subprocess.run([*bench["command"], "--workload", "exh100k-f32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nbody_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert run.forbidden_modules() == ["jaxlib"]
