"""The port's list-based Barnes-Hut path on clustered inputs, on the CPU,
with the plain version of K7: the twins of tests/test_bh_clustered.py,
with its inputs and bounds.

The flat traversal either gives bounded-error forces or reports a
capacity overflow through its stats, never a silently wrong result.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops.barneshut import barneshut_accelerations
from nbody_tpu_torch.ops.cuda_lists import eval_lists_reference
from test_bh_clustered import _exact, two_cluster_cloud


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain_k7_used_rows(pos_groups, lists, lengths, *, eps2):
    """The plain K7 on the rows up to the longest list only: the rows past
    it have G·m = 0 and add exact zeros, and the full capacity (16,384
    rows against the 6,094 that the 20,000-body lists use) costs 4x the
    time."""
    rows = int(lengths.max())
    return eval_lists_reference(pos_groups, lists[:, :rows], lengths, eps2=eps2)


@pytest.mark.parametrize("n", [2000, 20000])
def test_clustered_forces_or_overflow(n):
    pos_np, _, mass_np = two_cluster_cloud(n, seed=n)
    pos = torch.as_tensor(pos_np, dtype=torch.float32)
    mass = torch.as_tensor(mass_np, dtype=torch.float32)
    acc, stats = barneshut_accelerations(pos, mass, return_stats=True,
                                         group_forces=_plain_k7_used_rows)
    if stats.overflowed():
        return  # the fail-fast channel fired: check_capacities raises
    idx = np.random.default_rng(1).integers(0, n, 200)
    want = _exact(pos_np, mass_np, idx)
    got = acc.numpy()[idx]
    # The clusters (width 0.05) are small against the softening length
    # (eps = 0.1), so their own forces are softening-dominated.
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02


def test_coincident_bodies_do_not_nan():
    # one deep chain of a tree and zero-size group boxes: the softened
    # self-terms make every force exactly zero
    n = 512
    acc = barneshut_accelerations(torch.zeros((n, 3)), torch.ones(n)).numpy()
    assert np.isfinite(acc).all()
    np.testing.assert_allclose(acc, 0.0, atol=1e-5)


def test_single_body():
    acc = barneshut_accelerations(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([5.0]))
    np.testing.assert_allclose(acc.numpy(), 0.0, atol=1e-6)
