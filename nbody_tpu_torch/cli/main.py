"""Command-line interface — counterpart of ``nbody_tpu/cli/main.py``, the
subset of the all-pairs run and the fused Barnes-Hut run.

Keeps the reference's positional contract
``input start_time end_time delta_time output`` (serial/exhaustive.c:33-38),
its run banner and wall-time report (serial/exhaustive.c:55-68), and the
JAX CLI's ``Pair interactions/sec`` line.

Routing:

* ``--algo exhaustive`` is all-pairs; ``--algo barnes-hut`` is Barnes-Hut;
  ``--algo auto`` takes Barnes-Hut above 32,768 bodies and exhaustive
  otherwise (cli/main.py:356-357).
* ``--backend cuda`` is the hand-written kernel and ``--backend torch``
  the plain PyTorch path: the counterparts of ``pallas`` (or
  ``pallas-df`` in f64) and ``jnp``.  ``auto`` takes ``cuda`` on the card
  and ``torch`` on the CPU.
* ``--bh-traversal`` picks the Barnes-Hut engine as cli/main.py:492-501:
  ``fused`` is the fused traversal (``ops/bh_fused.py``, K6, or its df
  mode in f64), ``flat`` and ``padded`` the list-based path
  (``ops/barneshut.py``, whose evaluator is K7, ``ops/cuda_lists.py``).
  ``auto`` is fused with ``cuda`` and flat with ``torch``, as JAX's auto
  is fused with ``pallas`` and flat with ``jnp``.
* The all-pairs kernels: K1 (``ops/cuda_exhaustive.py``) in f32, K4
  (``ops/cuda_fp64.py``) with ``--dtype f64``.  ``--backend torch`` takes
  the plain ``exhaustive_accelerations`` in JAX's ``auto`` mode (``mxu``
  above 2,048 bodies, as ``--backend jnp``); ``--backend torch --dtype
  f64`` takes the Barnes-Hut decision rules through the plain versions.
* ``--softening-per-body FILE`` (one ε per body, cli/main.py:372-400)
  runs all-pairs only, through K1 on the card or the plain path; with
  ``--dtype f64`` and the cuda backend it exits, as JAX's ``pallas-df``
  does, since K4 has no per-body mode.
* ``--bh-robust`` on the fused traversal is the exact outlier hybrid
  (``ops/bh_fused.py::barneshut_fused_robust``, or ``bh_fused_df``'s in
  f64): ``auto`` resolves to on where the full/robust border ratio is
  above 4 (cli/main.py:638-666), and above 32,768 bodies without
  ``--bh-ld`` the depth comes from ``ops/bh_autold.choose_ld_cached``
  (cli/main.py:668-699).  The tree goes through K6 (or its df mode) and
  the outliers' rectangle through K1 (or K4).
* ``--resort-every K`` on the fused traversal in f32 with the KDK
  integrator is the persistent Morton layout
  (``ops/bh_persistent.py::simulate_persistent``, cli/main.py:1091-1125):
  K6 every step on the stale partition, a resort every K steps, and with
  the robust hybrid its K1 rectangle.  Elsewhere it prints JAX's warning
  and the run goes on one-shot; on a list traversal ``--bh-robust`` does
  nothing in JAX either, and the port prints JAX's note.
* ``--timers`` prints the per-phase breakdown of one Barnes-Hut
  evaluation before the run (``diag/bh_phases.py``, cli/main.py:777-797),
  fused or flat; ``--trace DIR`` writes a ``torch.profiler`` trace of the
  run, with the port's spans and host syncs (``diag/timing.py``) in it,
  and prints their table (count, host ms, device ms) to stderr at the
  end; ``--devices`` prints the card and the run goes on; ``--debug-nans``
  stops the run at a non-finite position or force (exit 1);
  ``--progress K`` prints a heartbeat every K steps.  ``--block-i`` and
  ``--block-j`` are the Pallas all-pairs tile sizes: K1 picks its own tile
  and source split, so the port prints a note and ignores them.
* ``--checkpoint-every K`` writes the state every K steps in the input
  format with a ``.meta.json`` sidecar (``io/checkpoint.py``; rotation
  with ``--checkpoint-keep``), and ``--resume`` continues a checkpoint:
  start time and step from the sidecar, frames appended with the global
  frame numbering (cli/main.py:611-625, 884-931); an adaptive run's
  checkpoint holds the time it reached, not JAX's t0 + steps · dt_max.
  ``--adaptive-eta``
  runs adaptive dt (``integrate/adaptive.py``), ``--merge-radius`` /
  ``--merge-every`` inelastic merging (``ops/collisions.py``), one-shot or
  on the persistent layout; ``--block-tiers`` / ``--block-eta`` /
  ``--block-prefix`` the block time-step tiers of the persistent layout.
  The combinations JAX refuses exit as JAX's do (cli/main.py:958-977,
  1061-1065, 1146-1170).
* Barnes-Hut runs a startup capacity probe unless ``--no-capacity-check``:
  on the fused traversal ``check_fused``, the run's own layout and its
  evaluator's pricing pass (no forces); on the list traversal
  ``check_capacities``, one extra force evaluation; an overflow exits
  3 with the setting that fits; a terminal-resolution residual of the
  list path prints a warning and the run goes on (cli/main.py:771-775).
* ``--energy`` with the ``cuda`` backend at n >= 50,000 takes PE from the
  potential-energy kernel (K3, or K5 in f64) and KE from a torch sum (the
  JAX CLI's large-N path, cli/main.py:848-866); otherwise it takes
  ``get_energy``.
* ``--device cuda`` (the default) with no card exits non-zero; it never
  runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from functools import partial

import numpy as np

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.core.types import SimConfig

# --energy takes the PE kernel from this many bodies up (cli/main.py:854).
PE_KERNEL_MIN_N = 50_000
# --algo auto takes Barnes-Hut above this many bodies (cli/main.py:356-357).
BH_AUTO_MIN_N = 32_768


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody-torch",
        description="N-body simulator, PyTorch/CUDA port "
        "(reference CLI contract: input start end dt output)",
    )
    p.add_argument("input", help="input CSV: x, y, z, vx, vy, vz, mass per line")
    p.add_argument("start_time", type=float)
    p.add_argument("end_time", type=float)
    p.add_argument("delta_time", type=float)
    p.add_argument("output", help="trajectory CSV (id,x,y,z,mass per body per frame)")
    p.add_argument(
        "--algo",
        choices=["exhaustive", "barnes-hut", "auto"],
        default="exhaustive",
        help="force algorithm (auto: barnes-hut above 32k bodies)",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "torch", "cuda"],
        default="auto",
        help="force backend: cuda = hand-written kernel, torch = plain "
        "PyTorch (auto: cuda on the card, torch on the CPU)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    p.add_argument(
        "--integrator",
        choices=["leapfrog", "yoshida4"],
        default="leapfrog",
        help="leapfrog = reference 2nd-order KDK; yoshida4 = 4th-order "
        "symplectic (3 force evals/step)",
    )
    p.add_argument("--G", type=float, default=constants.BIG_G)
    p.add_argument("--theta", type=float, default=constants.THETA)
    p.add_argument("--softening2", type=float, default=constants.SOFTENING_SQ)
    p.add_argument(
        "--softening-per-body",
        metavar="FILE",
        default=None,
        help="per-body softening lengths eps_i, one per line (N lines); pairs "
        "soften with the symmetric mean (eps_i^2 + eps_j^2)/2.  Exhaustive "
        "algorithm only",
    )
    p.add_argument(
        "--no-output",
        action="store_true",
        help="skip trajectory writing (the reference's non--DRESULTS build)",
    )
    p.add_argument(
        "--write-every",
        type=int,
        default=1,
        help="write every k-th frame (reference writes every step)",
    )
    p.add_argument(
        "--energy",
        action="store_true",
        help="print KE/PE before and after and the relative energy drift",
    )
    p.add_argument("--chunk-steps", type=int, default=64,
                   help="steps per host-side output flush")
    p.add_argument(
        "--bh-traversal",
        choices=["auto", "fused", "flat", "padded"],
        default="auto",
        help="Barnes-Hut traversal engine (auto: fused with the cuda "
        "backend, flat with torch; flat and padded are the list-based "
        "path)",
    )
    p.add_argument(
        "--bh-robust",
        choices=["auto", "on", "off"],
        default="auto",
        help="exact outlier hybrid for the fused Barnes-Hut path: size the "
        "root cube ignoring the ~n/512 most distant bodies and add their "
        "pull with one exact (N, K) all-pairs rectangle (auto: on where the "
        "full/robust border ratio is above 4; the list traversals ignore "
        "it)",
    )
    p.add_argument("--bh-group-size", type=int, default=0,
                   help="Barnes-Hut bodies per traversal group (0 = auto: "
                   "1024 fused, the most its kernel takes; 256-2048 list)")
    p.add_argument("--bh-leaf-cap", type=int, default=0,
                   help="Barnes-Hut near-field leaf capacity (0 = auto: 64 "
                   "fused, 16-32 list)")
    p.add_argument("--bh-list-size", type=int, default=0,
                   help="list-based Barnes-Hut per-group source-list capacity "
                   "(0 = auto, 16384; capacity errors prescribe the value "
                   "that fits)")
    p.add_argument(
        "--bh-ld", type=int, default=0,
        help="Barnes-Hut dense-grid terminal level (0 = auto: ~16 "
        "bodies/cell capped at 6; at most 8)")
    p.add_argument(
        "--bh-keep-groups", type=int, default=0,
        help="fused Barnes-Hut group slot capacity (0 = device-memory "
        "auto, core/capacity.py; capacity errors prescribe the value that "
        "fits)")
    p.add_argument(
        "--bh-frontier-cap", type=int, default=0,
        help="fused Barnes-Hut BFS frontier cells per level (0 = auto; "
        "overflow errors prescribe the measured value needed)")
    p.add_argument(
        "--no-capacity-check",
        action="store_true",
        help="skip the Barnes-Hut startup capacity probe (fused: the layout "
        "and K6's pricing pass; list: one extra force evaluation)",
    )
    p.add_argument(
        "--resort-every", type=int, default=0, metavar="K",
        help="persistent Morton order: integrate in the fused kernel's "
        "group layout and resort only every K steps (fused Barnes-Hut, f32, "
        "KDK; elsewhere it is ignored with a warning; 0 = off)",
    )
    p.add_argument(
        "--timers", action="store_true",
        help="print a per-phase Barnes-Hut timing breakdown of one force "
        "evaluation before the run (fused: sort / grid / group / kernel / "
        "scatter; flat: sort+build+group / traverse / eval / scatter)",
    )
    p.add_argument(
        "--progress", type=int, default=0, metavar="K",
        help="print a heartbeat (step, s/step, ETA) every K steps; 0 = off",
    )
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="write a torch.profiler trace (Chrome format) of the run to DIR, and "
        "print the table of its spans to stderr",
    )
    p.add_argument(
        "--debug-nans", action="store_true",
        help="stop the run with an error at the first non-finite position or "
        "force (a host sync per force evaluation)",
    )
    p.add_argument(
        "--devices", action="store_true",
        help="print the device report (name, SMs, memory, power limit) and "
        "continue",
    )
    p.add_argument(
        "--block-tiers", type=int, default=1,
        help="tiered block time steps on the persistent path (needs --resort-every): "
        "per-group dt tiers dt/2^k, k < BLOCK_TIERS, reassigned from the acceleration "
        "scale at every resort, so only hot Morton groups pay fine steps "
        "(ops/bh_persistent.py kdk_block_steps)",
    )
    p.add_argument(
        "--block-eta", type=float, default=0.025,
        help="tier criterion accuracy: dt_k <= sqrt(2 eta eps / |a|max) per group "
        "(with --block-tiers)",
    )
    p.add_argument(
        "--block-prefix", action="store_true",
        help="with --block-tiers: evaluate each sub-step over a tier-sorted prefix of "
        "the groups instead of all groups with the others masked (same bits; masked "
        "is the default, as in the JAX package)",
    )
    p.add_argument(
        "--adaptive-eta", type=float, default=0.0,
        help="adaptive time stepping: dt = sqrt(2 eta eps / |a|_max) per step, clipped "
        "to the positional delta_time as dt_max (integrate/adaptive.py).  Needs "
        "--softening2 > 0 for the eps scale.  Leapfrog only; composes with "
        "--resort-every (the persistent layout)",
    )
    p.add_argument(
        "--merge-radius", type=float, default=0.0,
        help="contact distance for perfectly inelastic body mergers "
        "(ops/collisions.py).  Absorbed bodies continue as zero-mass tracers; mass and "
        "momentum are conserved.  Composes with --resort-every (the persistent layout "
        "rebuilds at merge boundaries)",
    )
    p.add_argument(
        "--merge-every", type=int, default=1,
        help="steps between merge passes (with --merge-radius); pick so bodies cannot "
        "cross the contact radius between passes",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="write a resumable (pos,vel,mass) checkpoint every k steps in the input "
        "CSV format, so a checkpoint is directly runnable",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="checkpoint file path (default: <output>.ckpt.csv)",
    )
    p.add_argument(
        "--checkpoint-keep", type=int, default=1,
        help="rotate checkpoints, keeping the last k (k > 1 keeps older ones at "
        "<path>.1, <path>.2, ...)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="treat INPUT as a checkpoint and continue its run: the start time comes "
        "from the .meta.json sidecar (the positional start_time is ignored) and frames "
        "append to OUTPUT if it already exists",
    )
    p.add_argument("--block-i", type=int, default=0,
                   help="Pallas all-pairs i-block size: K1 picks its own tile, "
                   "so this is ignored with a note")
    p.add_argument("--block-j", type=int, default=0,
                   help="Pallas all-pairs j-tile size: K1 picks its own tile "
                   "and source split, so this is ignored with a note")
    return p


def resolve_algo(algo: str, n: int) -> str:
    """``auto``: Barnes-Hut above BH_AUTO_MIN_N bodies, else exhaustive."""
    if algo == "auto":
        return "barnes-hut" if n > BH_AUTO_MIN_N else "exhaustive"
    return algo


def resolve_backend(backend: str, device: str) -> str:
    """The force backend a run takes; raises ValueError for combinations
    that have no path.  Both dtypes and both algorithms have kernels."""
    if backend == "auto":
        backend = "cuda" if device == "cuda" else "torch"
    if backend == "cuda" and device != "cuda":
        raise ValueError("--backend cuda needs --device cuda")
    return backend


def resolve_traversal(traversal: str, backend: str) -> str:
    """``auto``: the fused traversal with the cuda backend, flat with torch
    (JAX: fused with pallas, flat with jnp, cli/main.py:492-501)."""
    if traversal == "auto":
        return "fused" if backend == "cuda" else "flat"
    return traversal


def wants_persistent(args, algo: str, traversal: str) -> bool:
    """Whether JAX would run the persistent Morton layout: --resort-every on
    the fused Barnes-Hut path with the KDK integrator in f32
    (cli/main.py:937-946).  Elsewhere it warns and ignores the flag."""
    return (args.resort_every > 0 and algo == "barnes-hut" and traversal == "fused"
            and args.integrator == "leapfrog" and args.dtype != "f64")


def refused_bh_option(args, backend: str, traversal: str) -> str | None:
    """Why a Barnes-Hut run cannot go ahead as asked, or None."""
    from nbody_tpu_torch.ops.bh_fused import MAX_GROUP_SIZE as max_b
    from nbody_tpu_torch.ops.bh_fused import MAX_LD as max_ld

    if traversal != "fused":
        return None
    if not 0 <= args.bh_ld <= max_ld:
        return f"--bh-ld must be in [0, {max_ld}], got {args.bh_ld}"
    if args.bh_group_size < 0 or (backend == "cuda" and args.bh_group_size > max_b):
        return (f"--bh-group-size must be in [0, {max_b}] with the cuda "
                f"backend (one thread per body), got {args.bh_group_size}")
    return None


def robust_ratio(pos: np.ndarray) -> float:
    """Full/robust border ratio of cli/main.py:648-655: the root cube's
    half-width over the distance from the median that all but the
    max(128, n // 512) farthest bodies stay within (0 when n <= k)."""
    n = pos.shape[0]
    k = max(128, n // 512)
    if n <= k:
        return 0.0
    d = np.abs(pos - np.median(pos, axis=0)).max(axis=1)
    d_k = np.partition(d, n - k - 1)[n - k - 1]
    return float(np.abs(pos).max() / max(d_k, 1e-30))


def read_softening_per_body(path: str, n: int, algo: str, dtype: str,
                            backend: str) -> np.ndarray:
    """The per-body softening lengths of ``--softening-per-body`` (one per
    line, f64), or ValueError with JAX's message where the run cannot take
    them (cli/main.py:372-400): a tree algorithm, a count other than n, or
    f64 on the kernel backend (K4 has no per-body mode, as JAX's
    ``pallas-df`` has none)."""
    if algo != "exhaustive":
        raise ValueError(f"--softening-per-body requires --algo exhaustive (got algo="
                         f"{algo}); tree paths need per-node softening classes")
    if dtype == "f64" and backend == "cuda":
        raise ValueError("--softening-per-body has no fp64 kernel (K4 takes no per-body "
                         "softening, nor does JAX's pallas-df): use --backend torch for "
                         "f64 per-body softening")
    try:
        eps = np.loadtxt(path, dtype=np.float64).reshape(-1)
    except OSError as e:
        raise ValueError(f"--softening-per-body: {e}") from e
    if eps.shape[0] != n:
        raise ValueError(f"--softening-per-body: {eps.shape[0]} values for {n} bodies")
    return eps


def fused_kwargs(args) -> dict:
    """Knobs of the fused traversal from flags (0 = auto, omitted)."""
    flags = {"group_size": args.bh_group_size, "leaf_cap": args.bh_leaf_cap,
             "keep_groups": args.bh_keep_groups,
             "frontier_cap": args.bh_frontier_cap, "ld": args.bh_ld}
    return {k: v for k, v in flags.items() if v}


def list_kwargs(args) -> dict:
    """Knobs of the list-based path from flags (0 = auto, omitted), as
    cli/main.py:311-320 ``_bh_kwargs``."""
    flags = {"group_size": args.bh_group_size, "leaf_cap": args.bh_leaf_cap,
             "list_size": args.bh_list_size}
    return {k: v for k, v in flags.items() if v}


def build_force_fn(backend: str, G: float, softening_sq: float,
                   algo: str = "exhaustive", theta: float = constants.THETA,
                   bh_kw: dict | None = None, dtype: str = "f32",
                   traversal: str = "fused", robust: bool = False,
                   eps2_per_body=None):
    """The force function of a run; `traversal` is a resolved Barnes-Hut
    engine (fused, flat or padded), `robust` the resolved ``--bh-robust``
    of the fused traversal, `eps2_per_body` the all-pairs per-body ε²."""
    if algo == "barnes-hut" and traversal != "fused":
        from nbody_tpu_torch.ops import barneshut, cuda_lists

        if backend != "cuda":
            group_forces = barneshut.eval_lists_reference
        elif dtype == "f64":
            group_forces = cuda_lists.eval_lists_f64
        else:
            group_forces = cuda_lists.eval_lists
        return partial(barneshut.barneshut_accelerations, G=G, softening_sq=softening_sq,
                       theta=theta, traversal=traversal, group_forces=group_forces,
                       **(bh_kw or {}))
    if algo == "barnes-hut":
        from nbody_tpu_torch.ops import bh_fused, bh_fused_df
        from nbody_tpu_torch.ops.cuda_exhaustive import (
            cuda_rect_accelerations,
            rect_accelerations_reference,
        )
        from nbody_tpu_torch.ops.cuda_fp64 import cuda_rect_accelerations_f64

        if dtype == "f64":
            fn = (bh_fused_df.barneshut_fused_robust_df if robust
                  else bh_fused_df.barneshut_fused_df)
            kernel, plain = (bh_fused_df.fused_group_forces_df,
                             bh_fused_df.fused_group_forces_df_reference)
            rect = cuda_rect_accelerations_f64
        else:
            fn = bh_fused.barneshut_fused_robust if robust else bh_fused.barneshut_fused
            kernel, plain = bh_fused.fused_group_forces, bh_fused.fused_group_forces_reference
            rect = cuda_rect_accelerations
        kw = dict(bh_kw or {}, group_forces=kernel if backend == "cuda" else plain)
        if robust:  # the outliers' rectangle: K1 / K4, or their plain version
            kw["rect_forces"] = rect if backend == "cuda" else rect_accelerations_reference
        return partial(fn, G=G, softening_sq=softening_sq, theta=theta, **kw)
    per_body = {} if eps2_per_body is None else {"eps2_per_body": eps2_per_body}
    if backend == "cuda" and dtype == "f64":
        from nbody_tpu_torch.ops.cuda_fp64 import cuda_accelerations_f64

        if per_body:
            raise ValueError("K4 takes no per-body softening")
        return partial(cuda_accelerations_f64, G=G, softening_sq=softening_sq)
    if backend == "cuda":
        from nbody_tpu_torch.ops.cuda_exhaustive import cuda_accelerations

        return partial(cuda_accelerations, G=G, softening_sq=softening_sq, **per_body)
    from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations

    return partial(exhaustive_accelerations, G=G, softening_sq=softening_sq, **per_body)


def device_report(device) -> str:
    """The ``--devices`` report: for the card, its name, SMs, memory and
    power limit (nvidia-smi); for the CPU, torch's threads."""
    import torch

    if device.type != "cuda":
        return f"device cpu: {torch.get_num_threads()} torch threads"
    import subprocess

    lines = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        try:
            limit = subprocess.run(
                ["nvidia-smi", "-i", str(i), "--query-gpu=power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            limit = "not read (no nvidia-smi)"
        lines.append(f"device cuda:{i}: {props.name}, {props.multi_processor_count} SMs, "
                     f"{props.total_memory / 2**30:.1f} GiB, compute capability "
                     f"{props.major}.{props.minor}, power limit {limit}")
    return "\n".join(lines)


def finite_forces(force):
    """`force` with its positions and accelerations checked
    (``--debug-nans``): FloatingPointError at the first non-finite value."""
    import torch

    def fn(pos, mass):
        if not bool(torch.isfinite(pos).all()):
            raise FloatingPointError("non-finite position")
        acc = force(pos, mass)
        if not bool(torch.isfinite(acc).all()):
            raise FloatingPointError("non-finite force")
        return acc

    return fn


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.diag.energy import (
        cuda_potential_energy,
        energy_drift,
        get_energy,
    )
    from nbody_tpu_torch.integrate.leapfrog import simulate
    from nbody_tpu_torch.io.csv import read_bodies, write_frames
    from nbody_tpu_torch.ops.barneshut import CapacityError
    from nbody_tpu_torch.ops.cuda_fp64 import cuda_potential_energy_f64

    if args.device == "cuda" and not torch.cuda.is_available():
        print(
            "error: --device cuda but no CUDA device is available "
            "(use --device cpu for the plain CPU path)",
            file=sys.stderr,
        )
        return 2
    if args.delta_time == 0:
        print("error: delta_time must be nonzero", file=sys.stderr)
        return 2
    if args.devices:
        print(device_report(torch.device(args.device)))
    if args.block_i or args.block_j:
        print("note: --block-i/--block-j are the Pallas all-pairs tile sizes; K1 "
              "picks its own tile and source split (cuda_exhaustive.k1_split), so "
              "they are ignored", file=sys.stderr)

    t0 = args.start_time
    resume_step = 0
    try:
        if args.resume:
            # cli/main.py:611-625: start time and step from the sidecar
            from nbody_tpu_torch.io.checkpoint import load_checkpoint

            arr, meta = load_checkpoint(args.input)
            if "time" in meta:
                t0 = float(meta["time"])
            resume_step = int(meta.get("step", 0))
            print(f"Resuming from {args.input}: step {resume_step}, t = {t0:g}")
        else:
            arr = read_bodies(args.input)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    algo = resolve_algo(args.algo, arr.shape[0])
    try:
        backend = resolve_backend(args.backend, args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    traversal = resolve_traversal(args.bh_traversal, backend)
    robust = False
    if algo == "barnes-hut":
        why = refused_bh_option(args, backend, traversal)
        if why is not None:
            print(f"error: {why}", file=sys.stderr)
            return 2
        if args.bh_robust != "off":
            # --bh-robust auto resolves as cli/main.py:642-666
            ratio = robust_ratio(arr[:, 0:3])
            robust = args.bh_robust == "on" or ratio > 4.0
            if args.bh_robust == "auto" and robust:
                print("note: outlier-dominated bounding box detected (full/robust "
                      f"border ratio {ratio:.0f}); enabling --bh-robust on (exact "
                      "hybrid)", file=sys.stderr)
            if robust and traversal != "fused":
                # JAX's list path never reads the flag (cli/main.py:311-320)
                print(f"note: --bh-robust applies to the fused traversal only; "
                      f"--bh-traversal {traversal} runs without it", file=sys.stderr)
                robust = False
        if robust and not args.bh_ld and arr.shape[0] > BH_AUTO_MIN_N:
            # data-adaptive grid depth for the robust run (cli/main.py:668-699)
            from nbody_tpu_torch.ops.bh_autold import choose_ld_cached

            args.bh_ld, was_cached = choose_ld_cached(
                arr[:, 0:3], arr[:, 6], robust=True, theta=args.theta,
                leaf_cap=args.bh_leaf_cap or 64, group_size=args.bh_group_size or 1024,
                persistent=args.resort_every > 0,
            )
            print(f"note: data-adaptive grid depth picked --bh-ld {args.bh_ld} "
                  + ("(cached probe; " if was_cached else
                     "(measured-cost pricing of the Morton occupancy histogram; ")
                  + "override with --bh-ld)", file=sys.stderr)
    persistent = wants_persistent(args, algo, traversal)
    if args.resort_every > 0 and not persistent:
        # cli/main.py:935-957
        print("warning: --resort-every requires the fused Barnes-Hut path with "
              "the KDK integrator"
              + (" (and f32 state: the persistent layout is f32 — --dtype f64 "
                 "runs the one-shot df kernel per step)" if args.dtype == "f64" else "")
              + "; ignoring", file=sys.stderr)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    device = torch.device(args.device)
    eps2_per_body = None
    if args.softening_per_body:
        try:
            eps = read_softening_per_body(args.softening_per_body, arr.shape[0], algo,
                                          args.dtype, backend)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        eps2_per_body = torch.as_tensor(eps * eps, dtype=dtype, device=device)
    bodies = Bodies.from_numpy(arr, dtype=dtype, device=device)

    # Reference semantics: dt parsed as C float, n_steps truncated float div
    # (serial/exhaustive.c:50-52).
    dt = SimConfig.c_float(args.delta_time)
    n_steps = max(0, SimConfig.n_steps(t0, args.end_time, args.delta_time))
    listed = algo == "barnes-hut" and traversal != "fused"
    bh_kw = list_kwargs(args) if listed else fused_kwargs(args)
    force = build_force_fn(backend, args.G, args.softening2, algo, args.theta, bh_kw,
                           args.dtype, traversal, robust, eps2_per_body)
    backend_label = backend
    if algo == "barnes-hut":
        if not listed:
            backend_label = (f"{backend}/fused" + ("/robust" if robust else "")
                             + ("/persistent" if persistent else ""))
        if not args.no_capacity_check:
            # startup capacity probe through the run's own traversal and
            # evaluator (cli/main.py:728-775): fused, its layout and pricing
            # pass; listed, a force evaluation
            from nbody_tpu_torch.ops.barneshut import ResolutionError, check_capacities
            from nbody_tpu_torch.ops.bh_fused import check_fused

            probe = check_capacities if listed else partial(check_fused, robust=robust)
            try:
                probe(bodies.pos, bodies.mass, **force.keywords)
            except CapacityError as e:
                print(f"error: {e}", file=sys.stderr)
                return 3
            except ResolutionError as e:
                print(f"warning: {e}", file=sys.stderr)

    if args.timers and algo == "barnes-hut":
        # one evaluation split into its phases (cli/main.py:777-797)
        from nbody_tpu_torch.diag import bh_phases

        kw = dict(G=args.G, softening_sq=args.softening2, theta=args.theta,
                  group_forces=force.keywords["group_forces"])
        if listed:
            times = bh_phases.flat_phase_times(bodies.pos, bodies.mass, **kw, **bh_kw)
        else:
            times = bh_phases.fused_phase_times(
                bodies.pos, bodies.mass, **kw,
                **{k: v for k, v in bh_kw.items() if k in ("group_size", "leaf_cap")})
        print("Per-phase force-eval breakdown:")
        print(bh_phases.report(times))

    # Reference banner (serial/exhaustive.c:55-57), extended with our config.
    print(
        f"Start: {t0:f}, end: {args.end_time:f}, delta time: "
        f"{dt:f}, time steps: {n_steps}, ents: {bodies.n}, G: {args.G:g}"
    )
    print(
        f"Algorithm: {algo}, backend: {backend_label}, dtype: {args.dtype}, "
        f"device: {device}"
    )

    def measure_energy(b):
        if backend == "cuda" and b.n >= PE_KERNEL_MIN_N:
            ke = 0.5 * (b.mass * (b.vel * b.vel).sum(-1)).sum()
            pe_kernel = (cuda_potential_energy_f64 if args.dtype == "f64"
                         else cuda_potential_energy)
            pe = pe_kernel(b.pos, b.mass, G=args.G)
            return float(ke), float(pe)
        ke, pe = get_energy(b.pos, b.vel, b.mass, G=args.G)
        return float(ke), float(pe)

    if args.energy:
        ke0, pe0 = measure_energy(bodies)
        e0 = ke0 + pe0
        print(f"Initial energy: KE={ke0:.9g} PE={pe0:.9g} E={e0:.9g}")

    writer = mass_update = None
    if not args.no_output:
        # cli/main.py:884-916.  On --resume an existing trajectory file is
        # continued: frames append, keep the global frame numbering (the
        # --write-every stride), and skip the initial frame, which is the
        # interrupted run's last written one.
        resuming_output = (args.resume and os.path.exists(args.output)
                           and os.path.getsize(args.output) > 0)
        # merging runs push the running masses here, so later frames carry
        # them in their mass column
        mass_holder = {"m": bodies.mass.cpu().numpy().astype(np.float64)}
        stride = max(1, args.write_every)
        count = [resume_step if resuming_output else 0]  # global frame index
        skip = [1 if resuming_output else 0]

        def writer(chunk: np.ndarray) -> None:
            idx = count[0] + np.arange(chunk.shape[0])
            count[0] += chunk.shape[0]
            if skip[0]:
                k = min(skip[0], chunk.shape[0])
                chunk, idx = chunk[k:], idx[k:]
                skip[0] -= k
            sel = chunk[idx % stride == 0]
            if len(sel):
                write_frames(args.output, [sel], mass_holder["m"], append=True)

        def mass_update(m) -> None:
            mass_holder["m"] = np.asarray(m, dtype=np.float64)

        if not resuming_output:
            open(args.output, "w").close()

    checkpoint_fn = ckpt_mgr = None
    if args.checkpoint_every > 0:
        from nbody_tpu_torch.io.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(args.checkpoint or (args.output + ".ckpt.csv"),
                                     keep=args.checkpoint_keep)

        def checkpoint_fn(b, step, t=None):
            # the time of a step, t0 + step * dt (cli/main.py:918-931); the
            # adaptive run passes its own time t, where JAX's CLI writes
            # t0 + step * dt_max, a time the state has not reached
            ckpt_mgr.save(b, step=resume_step + step, time=t0 + step * dt if t is None else t)

    # JAX's refusals of the flags' combinations (cli/main.py:958-977)
    if args.block_tiers > 1 and not persistent:
        raise SystemExit("--block-tiers requires the unsharded persistent path "
                         "(--resort-every with the fused Barnes-Hut KDK integrator)")
    if args.merge_radius > 0 and persistent and args.block_tiers > 1:
        raise SystemExit("--merge-radius and --block-tiers cannot combine (a merge "
                         "invalidates the tier assignment mid-macro-step); pick one")
    if args.merge_radius > 0 and persistent and args.adaptive_eta > 0:
        raise SystemExit("--adaptive-eta and --merge-radius cannot combine yet")

    progress_fn = None
    if args.progress > 0:
        beat = {"last": time.perf_counter(), "done": 0}

        def progress_fn(done, note=""):
            # the heartbeat of cli/main.py:980-997
            now = time.perf_counter()
            sps = (now - beat["last"]) / max(1, done - beat["done"])
            beat["last"], beat["done"] = now, done
            extra = f"  [{note}]" if note else ""
            print(f"progress: step {done}/{n_steps} "
                  f"({100.0 * done / max(1, n_steps):.1f}%), {sps:.3g} s/step, "
                  f"ETA {sps * (n_steps - done):.0f} s{extra}", file=sys.stderr, flush=True)

    from nbody_tpu_torch.diag.timing import pairs_per_sec, report, trace

    merge_kw = {}
    if args.merge_radius > 0:
        merge_kw = dict(merge_radius=args.merge_radius, merge_every=max(1, args.merge_every),
                        merge_report=lambda k: print(f"Merged bodies: {k}"),
                        mass_update=mass_update)
    t_wall0 = time.perf_counter()
    try:
        with trace(args.trace):
            if persistent:
                bodies = run_persistent(args, bodies, n_steps, dt, t0, force.keywords,
                                        robust, writer, progress_fn, checkpoint_fn, merge_kw)
            elif args.adaptive_eta > 0:
                # cli/main.py:1143-1162
                from nbody_tpu_torch.integrate.adaptive import simulate_adaptive

                if args.integrator != "leapfrog":
                    raise SystemExit("--adaptive-eta requires an unsharded leapfrog run")
                if args.merge_radius > 0:
                    raise SystemExit("--adaptive-eta and --merge-radius cannot combine yet")
                bodies, taken = simulate_adaptive(
                    bodies, t0, args.end_time,
                    finite_forces(force) if args.debug_nans else force,
                    eta=args.adaptive_eta, softening_sq=args.softening2, dt_max=dt,
                    chunk_steps=args.chunk_steps, frame_writer=writer)
                print(f"Adaptive steps taken: {taken}")
            else:
                if args.merge_radius > 0 and args.integrator != "leapfrog":
                    raise SystemExit("--merge-radius requires an unsharded leapfrog run")
                bodies = simulate(
                    bodies, n_steps, dt, finite_forces(force) if args.debug_nans else force,
                    frame_writer=writer, chunk_steps=args.chunk_steps,
                    checkpoint_every=args.checkpoint_every, checkpoint_fn=checkpoint_fn,
                    integrator=args.integrator, progress_every=args.progress,
                    progress_fn=progress_fn, **merge_kw,
                )
        # before the last checkpoint write is waited for, as JAX's
        elapsed = time.perf_counter() - t_wall0
    except FloatingPointError as e:
        print(f"error: --debug-nans: {e}; stopping the run", file=sys.stderr)
        return 1
    except CapacityError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    except ValueError as e:
        # the persistent path's refusals exit 2 (cli/main.py:1126-1129);
        # elsewhere the adaptive criterion's refusals exit 1
        print(f"error: {e}", file=sys.stderr)
        return 2 if persistent and args.adaptive_eta <= 0 else 1
    finally:
        if ckpt_mgr is not None:
            ckpt_mgr.close()
    if args.trace:
        print(f"Spans of the run (--trace):\n{report()}", file=sys.stderr)

    print(f"Completed. Output file: {args.output}")
    print(f"Elapsed wall time: {elapsed:f} s")
    if algo == "exhaustive" and elapsed > 0 and n_steps > 0:
        print(f"Pair interactions/sec: {pairs_per_sec(bodies.n, n_steps, elapsed):.3e}")

    if args.energy:
        ke1, pe1 = measure_energy(bodies)
        e1 = ke1 + pe1
        print(f"Final energy:   KE={ke1:.9g} PE={pe1:.9g} E={e1:.9g}")
        print(f"Relative energy drift: {energy_drift(e1, e0):.3e}")

    return 0


def run_persistent(args, bodies, n_steps: int, dt: float, t0: float, force_kw: dict,
                   robust: bool, writer, progress_fn, checkpoint_fn, merge_kw: dict):
    """The persistent Morton layout's run (cli/main.py:1050-1141): with
    --adaptive-eta ``simulate_persistent_adaptive``, else
    ``simulate_persistent`` with checkpoints, merging and block tiers; the
    run's evaluators from `force_kw`, the fused force function's keywords:
    K6's wrapper, and K1's in robust mode, or their plain versions.
    Returns the final Bodies."""
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.ops.bh_fused import FRONTIER_CAP
    from nbody_tpu_torch.ops.bh_persistent import (
        simulate_persistent,
        simulate_persistent_adaptive,
    )

    kw = dict(G=args.G, softening_sq=args.softening2, theta=args.theta,
              resort_every=args.resort_every, group_size=args.bh_group_size or 1024,
              leaf_cap=args.bh_leaf_cap or 64,
              frontier_cap=args.bh_frontier_cap or FRONTIER_CAP, frame_writer=writer,
              checkpoint_every=args.checkpoint_every, checkpoint_fn=checkpoint_fn,
              progress_every=args.progress, progress_fn=progress_fn,
              robust_slots=max(128, bodies.n // 512) if robust else 0, ld=args.bh_ld,
              debug_nans=args.debug_nans,
              **{k: force_kw[k] for k in ("group_forces", "rect_forces") if k in force_kw})
    if args.adaptive_eta > 0:
        if args.block_tiers > 1:
            raise SystemExit("--adaptive-eta and --block-tiers both adjust dt; pick one")
        pos, vel, taken = simulate_persistent_adaptive(
            bodies.pos, bodies.vel, bodies.mass, t0, args.end_time, eta=args.adaptive_eta,
            dt_max=dt, **kw)
        print(f"Adaptive steps taken: {taken}")
        return Bodies(pos, vel, bodies.mass)
    out = simulate_persistent(
        bodies.pos, bodies.vel, bodies.mass, n_steps, dt, block_tiers=max(1, args.block_tiers),
        block_eta=args.block_eta, block_prefix=args.block_prefix, **merge_kw, **kw)
    mass = out[2].to(bodies.mass.dtype) if merge_kw else bodies.mass
    return Bodies(out[0].to(bodies.pos.dtype), out[1].to(bodies.vel.dtype), mass)


if __name__ == "__main__":
    sys.exit(main())
