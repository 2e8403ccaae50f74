"""Checkpoint / resume — counterpart of ``nbody_tpu/io/checkpoint.py``.

A checkpoint is the full (pos, vel, mass) state written in the *input* CSV
format (x, y, z, vx, vy, vz, mass; serial/exhaustive.c:130), each value in
its shortest exact decimal form, so any checkpoint is directly runnable as
a new simulation input, plus a JSON sidecar ``<path>.meta.json`` holding
``n_bodies`` and, where given, ``step`` and ``time``.  The files are
byte-compatible with the JAX package's: either package resumes the
other's checkpoint.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.io.csv import read_bodies
from nbody_tpu_torch.native import loader as _native


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def save_checkpoint(path: str | os.PathLike, bodies, *, step: int | None = None,
                    time: float | None = None) -> None:
    """Write `bodies` (a ``Bodies`` of tensors or of numpy arrays) to
    `path` and its sidecar.  The native writer streams the rows; without
    it each value goes through ``repr`` (the same digits where the
    shortest form is unique)."""
    path = os.fspath(path)
    arr = np.concatenate([_host(bodies.pos), _host(bodies.vel),
                          _host(bodies.mass)[:, None]], axis=1)
    lib = _native.get()
    if lib is None or not lib.write7(path, arr):
        with open(path, "w") as f:
            for row in arr:
                f.write(",".join(repr(float(v)) for v in row) + "\n")
    meta = {"n_bodies": int(arr.shape[0])}
    if step is not None:
        meta["step"] = int(step)
    if time is not None:
        meta["time"] = float(time)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str | os.PathLike):
    """(bodies array (N, 7) float64, sidecar dict, empty without one)."""
    path = os.fspath(path)
    arr = read_bodies(path)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return arr, meta


class CheckpointManager:
    """Rotating checkpoint writer with one background writer thread.

    Keeps the latest checkpoint at `path` and up to `keep - 1` older ones
    at `path.1`, `path.2`, ... (newest first), each with its sidecar.
    ``save`` pulls the state to the host (the one synchronous part: a
    device-to-host copy) and hands the file I/O to the writer thread, with
    at most one write in flight.  ``close`` (or leaving the ``with``
    block) waits for the last write."""

    def __init__(self, path: str | os.PathLike, *, keep: int = 1):
        self.path = os.fspath(path)
        self.keep = max(1, int(keep))
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def _rotate_and_write(self, host: Bodies, step: int, time: float) -> None:
        if self.keep > 1 and os.path.exists(self.path):
            for i in range(self.keep - 1, 0, -1):
                src = self.path if i == 1 else f"{self.path}.{i - 1}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i}")
                    if os.path.exists(src + ".meta.json"):
                        os.replace(src + ".meta.json", f"{self.path}.{i}.meta.json")
        save_checkpoint(self.path, host, step=step, time=time)

    def save(self, bodies: Bodies, *, step: int, time: float) -> None:
        host = Bodies(*(_host(t) for t in bodies))
        if self._pending is not None:
            self._pending.result()
        self._pending = self._pool.submit(self._rotate_and_write, host, step, time)

    def close(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
