"""The readings that a cell's limits are set from, on the card at the
cell's own size.

    python3 -m nbbench.control --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each seed of `--seeds` it draws the cell's pool as a run would, runs
the timed path's job (``program.py``) on the pool's first input and
compares the answer with the plain reference (``check.gaps``): the
program's readings, whose largest is the lower reading.  For each seed of
`--control-seeds` it runs the control in the program's place: the
reference itself computed in the precision below the cell's (TF32 for f32,
f32 for f64), compared with the reference the same way; the smallest of
these is the upper reading.  One JSON line per reading, then a summary.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nbbench import check, gen, program, reference, spec

CONTROL_MODE = {"f32": "tf32", "f64": "f32"}


def readings(name: str, seeds, control_seeds, device, *, cell=None, config=None, extra=()):
    """(program readings, control readings): lists of ``check.gaps`` dicts,
    each with its "seed"."""
    cell = cell or spec.cell(name)
    config = config or spec.config(cell["config"])
    mode = cell["dtype"]
    prog, ref_cache = None, {}
    prog_out, ctrl_out = [], []

    def inputs(seed):
        return gen.make_pool(cell["distribution"], config["n"], cell["pool"], seed,
                             cell["dtype"], device)[0]

    def ref(seed, x):
        if seed not in ref_cache:
            ref_cache[seed] = [t.double().cpu().numpy()
                               for t in reference.job(config, cell, *x, mode=mode)]
        return ref_cache[seed]

    for seed in seeds:
        x = inputs(seed)
        if prog is None:
            prog = program.build(config, cell, device, x, tuple(extra))
            prog.job(*x)  # warm-up
        out = prog.job(*x)
        start = [t.double().cpu().numpy() for t in x[:2]]
        t0 = time.perf_counter()
        r = ref(seed, x)
        prog_out.append({"seed": seed, **check.gaps(out, r, start),
                         "reference_s": time.perf_counter() - t0})
        print(json.dumps({"program": prog_out[-1]}), flush=True)
    for seed in control_seeds:
        x = inputs(seed)
        ctrl = [t.double().cpu().numpy()
                for t in reference.job(config, cell, *x, mode=CONTROL_MODE[mode])]
        start = [t.double().cpu().numpy() for t in x[:2]]
        ctrl_out.append({"seed": seed, **check.gaps(ctrl, ref(seed, x), start)})
        print(json.dumps({"control": ctrl_out[-1]}), flush=True)
    return prog_out, ctrl_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("nbbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    prog, ctrl = readings(args.workload, args.seeds, args.control_seeds,
                          torch.device("cuda", 0))
    summary = {k: {"program_max": max((r[k] for r in prog), default=None),
                   "control_min": min((r[k] for r in ctrl), default=None)}
               for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "card": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
