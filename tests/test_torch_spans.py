"""The port's spans and host-sync counts (nbody_tpu_torch/diag/timing.py)
under a ``torch.profiler``: a one-shot and a persistent Barnes-Hut job (the
start-up probe, then the run), an all-pairs run, the host-sync sites,
nothing recorded outside a profiler's active steps, and the spans in the
Chrome trace of ``timing.trace``.  The probe prices and evaluates
nothing: under ``bh.probe`` the set-up stages and ``bh.k6.price`` (on the
CPU the plain version's "pops" cut), never ``bh.k6.full`` or
``bh.scatter``.  An evaluation on the CPU runs K6's plain version, so its
pricing pass and order and the device times show only in the test marked
`cuda`, which runs the jobs on the card (this file imports nothing of JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m cuda
"""

import collections
import json
import types
from functools import partial

import pytest
import torch

from nbody_tpu_torch.core import capacity
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.diag import timing
from nbody_tpu_torch.integrate import leapfrog
from nbody_tpu_torch.integrate.leapfrog import simulate
from nbody_tpu_torch.ops import bh_fused
from nbody_tpu_torch.ops.bh_persistent import simulate_persistent
from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations
from nbody_tpu_torch.utils.fixtures import random_cloud

CPU = torch.device("cpu")
KW = dict(G=1.0, softening_sq=0.01, theta=0.5, group_size=256)
ONESHOT = ("bh.sort", "bh.grid", "bh.groups", "bh.k6.full", "bh.scatter")
PROBE = ("bh.sort", "bh.grid", "bh.groups", "bh.k6.price")  # one call each


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_recorder():
    timing.clear()
    yield
    timing.clear()


def _bodies(n, device, seed=1):
    c = torch.as_tensor(random_cloud(n, seed=seed), dtype=torch.float32, device=device)
    return c[:, :3].contiguous(), c[:, 3:6].contiguous(), c[:, 6].contiguous()


def _oneshot_job(pos, vel, mass, steps):
    """The CLI's one-shot fused job: the probe, then the KDK steps."""
    bh_fused.check_fused(pos, mass, **KW)
    return simulate(Bodies(pos, vel, mass), steps, 1e-4,
                    partial(bh_fused.barneshut_fused, **KW))


def _persistent_job(pos, vel, mass, steps):
    """The CLI's persistent job, a resort every 2 steps."""
    bh_fused.check_fused(pos, mass, **KW)
    return simulate_persistent(pos, vel, mass, steps, 1e-4, resort_every=2, **KW)


def _profiled(fn):
    """(summary, spans) of `fn()` run under a profiler of the CPU."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return timing.summary(), timing.RECORDER.spans()


def _counts(table):
    return {name: v["count"] for name, v in table.items()}


def _check_nesting(spans):
    """Every span lies inside its parent, in time, and shares its root."""
    by_id = {s[0]: s for s in spans}
    for sid, _, parent, root, t0, t1 in spans:
        assert t0 <= t1
        if parent is None:
            assert root == sid
        else:
            p = by_id[parent]
            assert p[4] <= t0 and t1 <= p[5] and root == p[3]
    return by_id


def _under(spans, root_name):
    """Counts by name of the spans under the one root span `root_name`."""
    (root,) = [s for s in spans if s[1] == root_name]
    return collections.Counter(s[1] for s in spans if s[3] == root[0] and s is not root)


def test_oneshot_job_records_each_stage_once_an_evaluation():
    pos, vel, mass = _bodies(3000, CPU)
    table, spans = _profiled(lambda: _oneshot_job(pos, vel, mass, steps=3))
    evals = 1 + 3  # the initial force, a force a step; the probe prices only
    counts = _counts(table)
    assert counts == {**{s: evals for s in ONESHOT}, "bh.sort": 1 + evals,
                      "bh.grid": 1 + evals, "bh.groups": 1 + evals, "bh.k6.price": 1,
                      "bh.probe": 1, "integrate.run": 1, "force.eval": 4,
                      "integrate.step": 3, "host_sync.probe.stats": 1}
    assert all(v["host_s"] > 0 and v["device_s"] is None for v in table.values())
    by_id = _check_nesting(spans)
    assert _under(spans, "bh.probe") == {**{s: 1 for s in PROBE},
                                         "host_sync.probe.stats": 1}
    assert _under(spans, "integrate.run") == {**{s: 4 for s in ONESHOT}, "force.eval": 4,
                                              "integrate.step": 3}
    for s in spans:
        if s[1] in ONESHOT and by_id[s[3]][1] == "integrate.run":
            assert by_id[s[2]][1] == "force.eval"


def test_persistent_job_rebuilds_every_evaluation_and_resorts():
    pos, vel, mass = _bodies(3000, CPU)
    table, spans = _profiled(lambda: _persistent_job(pos, vel, mass, steps=5))
    evals = 1 + 5  # prime, then a force a step
    assert _counts(table) == {
        **{s: 1 for s in PROBE}, "bh.k6.full": evals, "bh.probe": 1,
        "host_sync.probe.stats": 1, "integrate.run": 1, "bh.init_state": 1,
        "force.eval": evals, "bh.rebuild": evals, "integrate.step": 5, "bh.kick_drift": 10, "bh.resort": 2,  # after steps 2 and 4
        "host_sync.persistent.guard": 3, "host_sync.persistent.overflow": 1}
    by_id = _check_nesting(spans)
    assert _under(spans, "integrate.run") == {
        "bh.init_state": 1, "force.eval": evals, "bh.rebuild": evals, "bh.k6.full": evals,
        "integrate.step": 5, "bh.kick_drift": 10, "bh.resort": 2,
        "host_sync.persistent.guard": 3, "host_sync.persistent.overflow": 1}
    for s in spans:
        if s[1] in ("bh.rebuild", "bh.k6.full") and by_id[s[3]][1] == "integrate.run":
            assert by_id[s[2]][1] == "force.eval"


def test_allpairs_run_records_the_integrator_only():
    pos, vel, mass = _bodies(500, CPU)
    force = partial(exhaustive_accelerations, G=1.0, softening_sq=0.01)
    table, spans = _profiled(lambda: simulate(Bodies(pos, vel, mass), 3, 1e-4, force))
    # the run is the root; on the card its end fence adds host_sync.simulate.fence
    assert _counts(table) == {"integrate.run": 1, "force.eval": 4, "integrate.step": 3}
    _check_nesting(spans)


def test_host_sync_sites_of_the_card(monkeypatch):
    """The budget's query and the run's fence, which the CPU skips, with
    the card's calls replaced: one count each, none where no call is made."""
    monkeypatch.delenv("NBODY_HBM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (4096, 8192))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    card = types.SimpleNamespace(is_cuda=True, device="cuda")

    def sites():
        assert capacity.free_bytes(torch.device("cuda")) == 4096
        assert capacity.budget_bytes(torch.device("cuda")) == 3072
        assert capacity.free_bytes(CPU) is None
        leapfrog._fence(card)
        leapfrog._fence(torch.zeros(1))
        monkeypatch.setenv("NBODY_HBM_BYTES", "100")
        assert capacity.free_bytes(torch.device("cuda")) == 100  # no query

    table, _ = _profiled(sites)
    assert _counts(table) == {"host_sync.capacity.free_bytes": 2,
                              "host_sync.simulate.fence": 1}


def test_nothing_recorded_outside_the_profilers_active_steps():
    pos, vel, mass = _bodies(600, CPU)
    _oneshot_job(pos, vel, mass, steps=1)
    assert timing.summary() == {} and timing.RECORDER.spans() == []
    # the benchmark's window: one warm-up step, then the active ones
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU], schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(5):
            with timing.span("job"):
                pass
            prof.step()
    assert _counts(timing.summary()) == {"job": 2}


def test_trace_holds_the_spans_as_nested_user_annotations(tmp_path):
    pos, vel, mass = _bodies(600, CPU)
    with timing.trace(str(tmp_path)):
        _oneshot_job(pos, vel, mass, steps=1)
    spans = timing.RECORDER.spans()
    with open(tmp_path / timing.TRACE_FILE) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    events = collections.defaultdict(list)
    for e in sorted((e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        events[e["name"]].append(e)
    assert {k: len(v) for k, v in events.items()} == collections.Counter(s[1] for s in spans)
    # the recorder's k-th span of a name is the trace's k-th event of it
    seen, event_of = collections.Counter(), {}
    for s in sorted(spans, key=lambda s: s[4]):
        e = events[s[1]][seen[s[1]]]
        seen[s[1]] += 1
        event_of[s[0]] = e
        assert abs(e["ts"] * 1e3 + base - s[4]) < 0.5e6  # one clock, within 0.5 ms
    for sid, _, parent, _, _, _ in spans:
        if parent is not None:
            c, p = event_of[sid], event_of[parent]
            assert p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_report_lists_each_span_by_host_time():
    table = {"a": {"count": 2, "host_s": 0.001, "device_s": None},
             "b": {"count": 1, "host_s": 0.003, "device_s": 0.0025}}
    lines = timing.report(table).splitlines()
    assert lines[0].split() == ["span", "count", "host", "ms", "device", "ms"]
    assert lines[1].split() == ["b", "1", "3.000", "2.500"]
    assert lines[2].split() == ["a", "2", "1.000", "-"]
    assert timing.report({}) == "spans: none recorded"


@pytest.mark.cuda
def test_jobs_on_the_card_count_every_site_and_time_every_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pos, vel, mass = _bodies(20000, torch.device("cuda"))
    # build and warm the kernels; the one-shot set-up's layout is sized, and
    # its graphs captured, here, so the jobs below read no budget
    for job in (_oneshot_job, _persistent_job):
        job(pos, vel, mass, steps=1)
    table, spans = _profiled(lambda: _oneshot_job(pos, vel, mass, steps=3))
    k6 = {"bh.k6.price": 5, "bh.k6.order": 4, "bh.k6.full": 4}  # the probe prices only
    assert _counts(table) == {
        **{s: 4 for s in ONESHOT}, **{s: 5 for s in PROBE}, **k6, "bh.probe": 1,
        "integrate.run": 1, "force.eval": 4, "integrate.step": 3,
        "host_sync.probe.stats": 1, "host_sync.simulate.fence": 1}
    assert all(v["device_s"] is not None and v["device_s"] >= 0 for v in table.values())
    _check_nesting(spans)
    assert _under(spans, "bh.probe") == {**{s: 1 for s in PROBE},
                                         "host_sync.probe.stats": 1}
    timing.clear()
    table, spans = _profiled(lambda: _persistent_job(pos, vel, mass, steps=5))
    counts = _counts(table)
    assert counts["bh.rebuild"] == counts["force.eval"] == counts["bh.k6.price"] - 1 == 6
    assert counts["bh.resort"] == 2 and counts["host_sync.persistent.guard"] == 3
    assert counts["host_sync.persistent.overflow"] == 1
    assert counts["host_sync.persistent.fence"] == 1
    assert all(v["device_s"] is not None for v in table.values())
    _check_nesting(spans)
