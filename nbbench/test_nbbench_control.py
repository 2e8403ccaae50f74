"""The comparison that decides `correct`, shown to fail: the control (the
reference in the precision below the cell's, in the program's place) and
the faults a cell can have, each driving the rest of a run on the CPU at a
small size."""

import numpy as np
import pytest
import torch

from nbbench import check, control, run, spec
from nbbench.small import small

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_passes(name):
    cell, config, extra = small(name)
    prog, ctrl = control.readings(name, [101], [102, 103], CPU, cell=cell, config=config,
                                  extra=extra)
    lim = cell["limits"]
    assert all(prog[0][k] <= lim[k] for k in check.NUMBERS), prog
    for r in ctrl:
        assert any(r[k] > lim[k] for k in check.NUMBERS), r


def _unchanged(job):
    """A step that returns its state unchanged: the answer is the input."""
    def broken(pos, vel, mass):
        job(pos, vel, mass)
        return pos.cpu().numpy(), vel.cpu().numpy()
    return broken


def _half(job):
    """Half of the bodies left out of the sources, the sum taken over the
    rest times two (their mean times n)."""
    def broken(pos, vel, mass):
        keep = torch.arange(mass.shape[0], device=mass.device) % 2 == 0
        return job(pos, vel, torch.where(keep, 2 * mass, 0 * mass))
    return broken


def _altered(job):
    """An answer altered where it is produced: body 0 left where it began."""
    def broken(pos, vel, mass):
        p, v = job(pos, vel, mass)
        p = np.array(p)
        p[0] = pos[0].cpu().numpy()
        return p, v
    return broken


def _run(name, wrap=None):
    cell, config, extra = small(name)
    return run.run_cell(name, 2**31 + 99, 0.05, False, CPU, bench=spec.benchmark(),
                        cell=cell, config=config, extra=extra, wrap_job=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = _run(name, fault)
    assert res["correct"] is False, res["check"]
