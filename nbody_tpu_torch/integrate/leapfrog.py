"""KDK leapfrog (velocity-Verlet) integration as a Python loop.

Counterpart of ``nbody_tpu/integrate/leapfrog.py``.  Step order matches the
reference `propagation` exactly (serial/exhaustive.c:192-255):

    a   = force(x)                  # once, before the loop   (:206)
    repeat n_steps times:           #                          (:218)
        v  += a * dt/2              # first half-kick          (:221-225)
        x  += v * dt                # drift                    (:228-231)
        a   = force(x)              # recompute                (:242)
        v  += a * dt/2              # second half-kick         (:245-249)

The JAX ``lax.scan`` becomes a loop over steps: PyTorch runs eagerly and
each step is a few elementwise ops around one force call.  ``simulate``
runs the steps in chunks and hands each chunk's positions to a writer
callback, the initial frame first; chunks end on checkpoint, progress and
(with frames) merge boundaries, as JAX's (``leapfrog.py:154-219``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.diag.timing import host_sync, span, spanned
from nbody_tpu_torch.ops.collisions import simulate_merging

ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (pos, mass) -> acc


def evaluate(force_fn: ForceFn, pos, mass):
    """One force evaluation, the span ``force.eval``."""
    with span("force.eval"):
        return force_fn(pos, mass)


def _one_step(pos, vel, acc, mass, dt, force_fn):
    half = dt * 0.5
    vel = vel + acc * half
    pos = pos + vel * dt
    acc = evaluate(force_fn, pos, mass)
    vel = vel + acc * half
    return pos, vel, acc


# Yoshida (1990) 4th-order symplectic coefficients: three KDK sub-steps
# with w1 = 1/(2 - 2^(1/3)), w0 = -2^(1/3) * w1.
_Y4_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y4_W0 = -(2.0 ** (1.0 / 3.0)) * _Y4_W1


def _one_step_yoshida4(pos, vel, acc, mass, dt, force_fn):
    """One 4th-order Yoshida step = KDK(w1 dt) . KDK(w0 dt) . KDK(w1 dt):
    3 force evaluations per step, O(dt^4) energy error.  The incoming `acc`
    is force(pos) exactly as in KDK, so chunked runs stay bit-identical."""
    for w in (_Y4_W1, _Y4_W0, _Y4_W1):
        sub = dt * w
        vel = vel + acc * (sub * 0.5)
        pos = pos + vel * sub
        acc = evaluate(force_fn, pos, mass)
        vel = vel + acc * (sub * 0.5)
    return pos, vel, acc


_STEPPERS = {"leapfrog": _one_step, "yoshida4": _one_step_yoshida4}


def leapfrog_steps(
    bodies: Bodies,
    n_steps: int,
    dt: float,
    force_fn: ForceFn,
    *,
    acc0: Optional[torch.Tensor] = None,
    with_history: bool = False,
    integrator: str = "leapfrog",
):
    """Advance `bodies` by `n_steps` steps.

    Returns (bodies', acc') and, if with_history, the (n_steps, N, 3) stack
    of post-drift positions (the rows the reference writes per step,
    serial/exhaustive.c:233-238).  `acc0` carries the force from a previous
    chunk so chunked runs are bit-identical to one long run; when None it
    is computed fresh (the reference's initial acceleration call, :206).
    """
    stepper = _STEPPERS[integrator]
    pos, vel, mass = bodies
    acc = evaluate(force_fn, pos, mass) if acc0 is None else acc0
    hist = []
    for _ in range(n_steps):
        with span("integrate.step"):
            pos, vel, acc = stepper(pos, vel, acc, mass, dt, force_fn)
        if with_history:
            hist.append(pos)
    out = Bodies(pos, vel, mass)
    if with_history:
        return out, acc, (torch.stack(hist) if hist else pos.new_empty((0,) + pos.shape))
    return out, acc


def _fence(t: torch.Tensor) -> None:
    """Wait for the device, so callers can time around `simulate`."""
    if t.is_cuda:
        with host_sync("simulate.fence"):
            torch.cuda.synchronize(t.device)


@spanned("integrate.run")
def simulate(
    bodies: Bodies,
    n_steps: int,
    dt: float,
    force_fn: ForceFn,
    *,
    frame_writer: Optional[Callable[[np.ndarray], None]] = None,
    chunk_steps: int = 64,
    checkpoint_every: int = 0,
    checkpoint_fn: Optional[Callable[[Bodies, int], None]] = None,
    integrator: str = "leapfrog",
    progress_every: int = 0,
    progress_fn: Optional[Callable[[int], None]] = None,
    merge_radius: float = 0.0,
    merge_every: int = 1,
    merge_report: Optional[Callable[[int], None]] = None,
    mass_update: Optional[Callable[[np.ndarray], None]] = None,
) -> Bodies:
    """Run a full simulation, optionally streaming trajectory frames.

    When `frame_writer` is given it first receives the initial frame (the
    reference writes the initial state before the loop,
    serial/exhaustive.c:208-216) and then one (T, N, 3) numpy chunk of
    post-drift positions per chunk of at most `chunk_steps` steps.
    `checkpoint_fn(bodies, step)` fires every `checkpoint_every` steps and
    `progress_fn(done)` every `progress_every` steps, after a device fence,
    so callers can report wall-clock heartbeats: chunks end on both.

    `merge_radius > 0` turns on inelastic merging every `merge_every`
    steps (``ops/collisions.py``; leapfrog only); `merge_report` receives
    the number of absorbed bodies at the end, and `mass_update` the running
    mass array after each chunk that merged.  With frames on, chunks also
    end on merge boundaries, so each chunk's frames share one mass column.
    """
    merging = merge_radius > 0
    if merging and integrator != "leapfrog":
        raise ValueError("merging supports the leapfrog integrator only")
    if frame_writer is not None:
        frame_writer(bodies.pos.cpu().numpy()[None])

    acc = None
    done = 0
    merged_total = 0
    chunked = frame_writer is not None or checkpoint_every > 0 or progress_every > 0
    while done < n_steps:
        t = min(chunk_steps, n_steps - done) if chunked else n_steps - done
        for every in (checkpoint_every, progress_every,
                      merge_every if merging and frame_writer is not None else 0):
            if every > 0:
                t = min(t, ((done // every) + 1) * every - done)
        if merging:
            out = simulate_merging(bodies, t, dt, force_fn, radius=merge_radius,
                                   merge_every=merge_every, acc0=acc, k0=done,
                                   with_history=frame_writer is not None)
            bodies, acc, merged = out[:3]
            if frame_writer is not None:
                frame_writer(out[3].cpu().numpy())
            merged_total += merged
            if merged and mass_update is not None:
                mass_update(bodies.mass.cpu().numpy())
        elif frame_writer is not None:
            bodies, acc, hist = leapfrog_steps(
                bodies, t, dt, force_fn, acc0=acc, with_history=True,
                integrator=integrator,
            )
            frame_writer(hist.cpu().numpy())
        else:
            bodies, acc = leapfrog_steps(
                bodies, t, dt, force_fn, acc0=acc, integrator=integrator
            )
        done += t
        if checkpoint_every > 0 and checkpoint_fn is not None and done % checkpoint_every == 0:
            checkpoint_fn(bodies, done)
        if progress_every > 0 and progress_fn is not None and done % progress_every == 0:
            _fence(bodies.pos)
            progress_fn(done)
    _fence(bodies.pos)
    if merging and merge_report is not None:
        merge_report(merged_total)
    return bodies
