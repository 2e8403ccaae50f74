"""The system under test: a job through the port's CLI path, minus file I/O.

``build`` resolves a cell's run as ``nbody_tpu_torch/cli/main.py``'s
``main`` resolves the same command line (the algorithm, the backend, the
traversal, ``--bh-robust``, the persistent layout, the force function of
``build_force_fn``), and returns a job: the CLI's start-up capacity probe
for Barnes-Hut (``check_fused`` or ``check_capacities``), the steps through
``simulate`` or ``run_persistent``, and the final positions and velocities
copied to the host.  Nothing here times or checks anything.

The command line is the configuration's ``algo`` and the cell's ``dtype``,
``resort_every`` and optional extra ``flags``, with G, theta and eps2 from
the configuration and ``--no-output``: the reference simulator's benchmark
runs write no trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


def argv(config: dict, cell: dict, extra: tuple[str, ...] = ()) -> list[str]:
    """The CLI command line of the cell's job (input and output unused)."""
    out = ["in.csv", "0", "1", repr(float(cell["dt"])), "out.csv", "--no-output",
           "--algo", config["algo"], "--dtype", cell["dtype"], "--G", repr(config["G"]),
           "--theta", repr(config["theta"]), "--softening2", repr(config["softening2"])]
    if cell.get("resort_every", 0):
        out += ["--resort-every", str(cell["resort_every"])]
    return out + list(cell.get("flags", [])) + list(extra)


@dataclass
class Program:
    job: Callable  # (pos, vel, mass) device tensors -> (pos, vel) host numpy arrays
    label: str  # the CLI's backend label, e.g. "cuda/fused/persistent"
    counters: Callable  # () -> dict of the port's launch counters


def build(config: dict, cell: dict, device, probe_input, extra: tuple[str, ...] = ()):
    """The cell's job on `device`.  `probe_input` (pos, vel, mass) is an
    input of the pool: ``--bh-robust auto`` is decided on it, as the CLI
    decides on the file it reads.  `extra` adds command-line flags (the
    CPU tests take ``--bh-traversal fused`` there, as the card's auto
    does)."""
    import torch

    from nbody_tpu_torch.cli import main as cli
    from nbody_tpu_torch.core.types import Bodies, SimConfig
    from nbody_tpu_torch.integrate.leapfrog import simulate
    from nbody_tpu_torch.ops import bh_fused, bh_fused_df, cuda_fp64
    from nbody_tpu_torch.ops.cuda_exhaustive import cuda_rect_accelerations

    args = cli.build_parser().parse_args(argv(config, cell, extra) + ["--device", device.type])
    n = probe_input[0].shape[0]
    algo = cli.resolve_algo(args.algo, n)
    backend = cli.resolve_backend(args.backend, args.device)
    traversal = cli.resolve_traversal(args.bh_traversal, backend)
    robust = False
    if algo == "barnes-hut":
        why = cli.refused_bh_option(args, backend, traversal)
        if why is not None:
            raise ValueError(why)
        if args.bh_robust != "off" and traversal == "fused":
            ratio = cli.robust_ratio(probe_input[0].double().cpu().numpy())
            robust = args.bh_robust == "on" or ratio > 4.0
        if robust and not args.bh_ld and n > cli.BH_AUTO_MIN_N:
            from nbody_tpu_torch.ops.bh_autold import choose_ld_cached

            args.bh_ld, _ = choose_ld_cached(
                probe_input[0].double().cpu().numpy(), probe_input[2].double().cpu().numpy(),
                robust=True, theta=args.theta, leaf_cap=args.bh_leaf_cap or 64,
                group_size=args.bh_group_size or 1024, persistent=args.resort_every > 0)
    persistent = cli.wants_persistent(args, algo, traversal)
    listed = algo == "barnes-hut" and traversal != "fused"
    bh_kw = cli.list_kwargs(args) if listed else cli.fused_kwargs(args)
    force = cli.build_force_fn(backend, args.G, args.softening2, algo, args.theta, bh_kw,
                               args.dtype, traversal, robust)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    dt = SimConfig.c_float(args.delta_time)
    steps = int(cell["steps_per_job"])
    probe = None
    if algo == "barnes-hut" and not args.no_capacity_check:
        from nbody_tpu_torch.ops.barneshut import check_capacities

        probe = check_capacities if listed else bh_fused.check_fused
        if not listed:
            probe = (lambda fn: lambda p, m, **kw: fn(p, m, robust=robust, **kw))(probe)
    if args.adaptive_eta > 0 or args.merge_radius > 0 or args.checkpoint_every > 0:
        raise ValueError("a job runs fixed steps with no merging and no checkpoints")

    def job(pos, vel, mass):
        bodies = Bodies(pos.to(dtype), vel.to(dtype), mass.to(dtype))
        if probe is not None:
            probe(bodies.pos, bodies.mass, **force.keywords)
        if persistent:
            out = cli.run_persistent(args, bodies, steps, dt, 0.0, force.keywords, robust,
                                     None, None, None, {})
        else:
            out = simulate(bodies, steps, dt, force, chunk_steps=args.chunk_steps,
                           integrator=args.integrator)
        return out.pos.cpu().numpy(), out.vel.cpu().numpy()

    def counters():
        return {
            "k1_launches": cuda_rect_accelerations.launches,
            "k4_launches": cuda_fp64.cuda_rect_accelerations_f64.launches,
            "k6_evaluations": (bh_fused.fused_group_forces.evaluations
                               + bh_fused_df.fused_group_forces_df.evaluations),
        }

    label = backend
    if algo == "barnes-hut" and not listed:
        label += "/fused" + ("/robust" if robust else "") + ("/persistent" if persistent else "")
    elif algo == "barnes-hut":
        label += f"/{traversal}"
    return Program(job=job, label=f"{algo} {label} {args.dtype}", counters=counters)
