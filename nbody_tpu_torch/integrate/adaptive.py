"""Adaptive time stepping, a per-step dt from the acceleration scale —
counterpart of ``nbody_tpu/integrate/adaptive.py``.

The criterion is the standard softened-gravity one (GADGET's criterion 0):

    dt = sqrt(2 eta eps / |a|_max),   clipped to [dt_min, dt_max]

and the step is also clamped to the time left, (t_end - t), so the run
lands exactly on t_end: when a step takes the whole remainder, t snaps to
t_end instead of accumulating (near arrival t + dt can round back to t).

`t` and `dt` are 0-dim tensors in the state's dtype on the state's device,
as JAX carries them in its scan: an f32 run compares and snaps in f32, so
it takes the steps JAX takes.  The host compares against t_end at that
resolution (f32(t_end) < t_end would otherwise never be reached).

JAX runs fixed-length scans of K steps and, past t_end, dt = 0 identity
steps (static shapes).  Here a chunk of K steps stops at arrival instead:
the identity steps change nothing, so the steps taken, the landing time
and the frames are JAX's, without their force evaluations.  Arrival is
found without a host read a step: from a time t read on the host, no step
can arrive before (t_end - t) / (dt_max + ulp) - 2 further steps, so those
run unread, and only the last ~2 dt_max before t_end pay a read a step
(``run_chunk``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.diag.timing import spanned
from nbody_tpu_torch.integrate.leapfrog import ForceFn, _fence, evaluate


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def host_time(t: float, dtype: torch.dtype) -> float:
    """`t` rounded to the state's dtype, as a Python float."""
    return float(_np_dtype(dtype)(t))


def step_size(amax: torch.Tensor, t: torch.Tensor, t_end: torch.Tensor, *,
              two_eta_eps: torch.Tensor, dt_min: float, dt_max: float):
    """(dt, rem): the criterion's step from |a|_max clipped to [dt_min,
    dt_max] and to the remainder rem = max(t_end - t, 0), all 0-dim in the
    state's dtype (``adaptive.py:84-88``)."""
    dt = torch.sqrt(two_eta_eps / torch.clamp_min(amax, 1e-30))
    dt = torch.clamp(dt, dt_min, dt_max)
    rem = torch.clamp_min(t_end - t, 0.0)
    return torch.minimum(dt, rem), rem


def sure_steps(t: float, t_end: float, dt_max: float, dtype: torch.dtype) -> int:
    """Steps from time `t` that cannot arrive at `t_end`: a step advances t
    by at most dt_max (in the state's dtype) plus one rounding of t, and
    arrives only once t_end - t is within a step."""
    nd = _np_dtype(dtype)
    adv = float(nd(dt_max)) * (1.0 + 1e-6) + float(np.spacing(nd(max(abs(t), abs(t_end)))))
    left = t_end - t
    if not (left > 0 and math.isfinite(left)):
        return 0
    return max(0, int(left / adv) - 2)


def run_chunk(k: int, t_host: float, t_end_cmp: float, dt_max: float,
              dtype: torch.dtype, run: Callable[[int], torch.Tensor]) -> float:
    """Up to `k` adaptive steps from host time `t_host`, stopping at
    arrival: `run(s)` takes s steps and returns the device time after
    them.  Steps that cannot arrive run in one batch with one host read;
    within reach of t_end, a read a step.  Returns the host time at the
    end."""
    done = 0
    while done < k and t_host < t_end_cmp:
        s = min(k - done, max(1, sure_steps(t_host, t_end_cmp, dt_max, dtype)))
        t_host = float(run(s))
        done += s
    return t_host


def _amax(acc: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((acc * acc).sum(-1).max())


def adaptive_steps(
    bodies: Bodies,
    k_steps: int,
    t,
    t_end: float,
    force_fn: ForceFn,
    *,
    eta: float,
    eps: float,
    dt_min: float,
    dt_max: float,
    acc0: Optional[torch.Tensor] = None,
    with_history: bool = False,
):
    """One chunk of at most `k_steps` adaptive KDK steps starting at time
    `t` (a float or a 0-dim tensor), stopping at arrival (``run_chunk``):
    JAX's scan goes on with dt = 0 identity steps.  Returns (bodies', acc',
    t', (ts, dts)) — each step's end time and the dt it took, 0-dim tensors
    stacked — plus the (T, N, 3) post-drift history with `with_history`."""
    pos, vel, mass = bodies
    dtype, dev = pos.dtype, pos.device
    acc = evaluate(force_fn, pos, mass) if acc0 is None else acc0
    two_eta_eps = torch.tensor(2.0 * eta * eps, dtype=dtype, device=dev)
    t_end_t = torch.tensor(t_end, dtype=dtype, device=dev)
    t = torch.as_tensor(t, dtype=dtype).to(dev)
    ts, dts, hist = [], [], []
    st = [pos, vel, acc, t]

    def run(s: int) -> torch.Tensor:
        pos, vel, acc, t = st
        for _ in range(s):
            dt, rem = step_size(_amax(acc), t, t_end_t, two_eta_eps=two_eta_eps,
                                dt_min=dt_min, dt_max=dt_max)
            half = dt * 0.5
            vel = vel + acc * half
            pos = pos + vel * dt
            acc = evaluate(force_fn, pos, mass)
            vel = vel + acc * half
            t = torch.where(dt >= rem, t_end_t, t + dt)
            ts.append(t)
            dts.append(dt)
            if with_history:
                hist.append(pos)
        st[:] = [pos, vel, acc, t]
        return t

    run_chunk(k_steps, float(t), host_time(t_end, dtype), dt_max, dtype, run)
    pos, vel, acc, t = st
    out = Bodies(pos, vel, mass)
    steps = (torch.stack(ts), torch.stack(dts)) if ts else (t.new_empty(0), t.new_empty(0))
    if with_history:
        return out, acc, t, steps, (torch.stack(hist) if hist
                                    else pos.new_empty((0,) + pos.shape))
    return out, acc, t, steps


def check_adaptive(softening_sq: float, dt_max: float) -> float:
    """eps = sqrt(softening_sq), or ValueError where the criterion has no
    scale (``adaptive.py:125-128``)."""
    if softening_sq <= 0:
        raise ValueError("adaptive dt needs softening_sq > 0 (the eps scale)")
    if dt_max <= 0:
        raise ValueError("dt_max must be > 0")
    return math.sqrt(softening_sq)


def stagnated(t: float, t_end: float, dt_max: float) -> RuntimeError:
    return RuntimeError(
        f"adaptive dt stagnated at t = {t:g} (< t_end = {t_end:g}): dt_max "
        f"{dt_max:g} is below the f32 time resolution at this t — raise dt_max "
        "or rescale time")


@spanned("integrate.run")
def simulate_adaptive(
    bodies: Bodies,
    t_start: float,
    t_end: float,
    force_fn: ForceFn,
    *,
    eta: float = 0.025,
    softening_sq: float,
    dt_min: float = 0.0,
    dt_max: float,
    chunk_steps: int = 64,
    frame_writer: Optional[Callable[[np.ndarray], None]] = None,
    max_steps: int = 10_000_000,
):
    """Integrate from t_start to t_end with adaptive dt; returns (bodies,
    steps taken).  Frames follow the fixed-dt contract (the initial frame,
    then each chunk's post-drift rows), one row per real step (dt > 0).
    `max_steps` is checked between chunks, as JAX's; the stagnation guard
    raises where a chunk did not move t."""
    eps = check_adaptive(softening_sq, dt_max)
    if frame_writer is not None:
        frame_writer(bodies.pos.cpu().numpy()[None])
    dtype = bodies.pos.dtype
    t_end_cmp = host_time(t_end, dtype)
    t = torch.tensor(t_start, dtype=dtype, device=bodies.pos.device)
    t_host = float(t)
    acc = None
    taken = 0
    t_prev = float("-inf")
    while t_host < t_end_cmp and taken < max_steps:
        if t_host <= t_prev:
            raise stagnated(t_host, t_end, dt_max)
        t_prev = t_host
        out = adaptive_steps(bodies, chunk_steps, t, t_end, force_fn, eta=eta, eps=eps,
                             dt_min=dt_min, dt_max=dt_max, acc0=acc,
                             with_history=frame_writer is not None)
        bodies, acc, t, (_, dts) = out[:4]
        real = (dts > 0).cpu().numpy()
        if frame_writer is not None and real.any():
            frame_writer(out[4].cpu().numpy()[real])
        taken += int(real.sum())
        t_host = float(t)
    _fence(bodies.pos)
    return bodies, taken
