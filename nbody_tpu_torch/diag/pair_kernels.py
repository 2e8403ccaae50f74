"""K1, K2 and K7 timed on the card, through calls that the kernels' earlier
designs took as well, so the same file times an older checkout too (copy
it there and run it from that checkout's root):

    python -m nbody_tpu_torch.diag.pair_kernels [--splits]

Prints, each beside the card's name and power limit: K1
(``cuda_rect_accelerations``) on the 100k main-path bodies
(``tests/data/100k_bodies.csv``) and on the 100,003 x 4,099 and
1,000,000 x 1,953 rectangles of ``random_cloud``; K2 (the same call with
``use_mxu=True``) on the 100k bodies; the SM clock and power draw while
K1 and K2 run at 100k (nvidia-smi); and K7's f32 and fp64 entries
(``eval_lists``, ``eval_lists_f64``) on the lists that the flat traversal
builds for the 1M uniform cloud (``random_cloud(1M, seed 0)``), with
their real pairs.  Each time is the best of 5 after a warm-up, each call
queued behind a spin kernel (``fused_stages.best_ms``).  With
``--splits`` it also times K1 and both K7 entries at every forced number
of source slices a block (the wrappers' ``_split=``), and says so for an
entry whose checkout lacks it.  The last line is one JSON object {label:
ms}.  It runs on the card only: with no card it exits 1 and says why.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import torch

from nbody_tpu_torch.diag import fused_stages as fs
from nbody_tpu_torch.diag.fp64_kernels import CSV_100K, clock_and_power
from nbody_tpu_torch.io.csv import read_bodies
from nbody_tpu_torch.ops import barneshut, cuda_lists
from nbody_tpu_torch.ops.cuda_exhaustive import cuda_rect_accelerations
from nbody_tpu_torch.utils.fixtures import random_cloud

SPLITS = (1, 2, 4, 8)


def k1_shapes(device) -> dict:
    """{label: (pos_i, pos_j, mass_j)} of K1's timed shapes, f32."""
    arr = torch.as_tensor(read_bodies(CSV_100K), dtype=torch.float32, device=device)
    pos, mass = arr[:, :3].contiguous(), arr[:, 6].contiguous()
    c = torch.as_tensor(random_cloud(1_000_000, seed=0), dtype=torch.float32,
                        device=device)
    shapes = {"K1 100k x 100k": (pos, pos, mass)}
    for m, n in ((100_003, 4_099), (1_000_000, 1_953)):
        shapes[f"K1 {m} x {n}"] = (c[:m, :3].contiguous(), c[:n, :3].contiguous(),
                                   c[:n, 6].contiguous())
    return shapes


def lists_1m(device, dtype):
    """The flat traversal's group lists of the 1M uniform cloud in `dtype`,
    rebuilt with the list size it needs where the default is short."""
    c = torch.as_tensor(random_cloud(1_000_000, seed=0), dtype=dtype, device=device)
    pos, mass = c[:, :3].contiguous(), c[:, 6].contiguous()
    gl = barneshut.group_lists(pos, mass)
    need = int(gl.stats[0])
    if need > gl.lists.shape[1]:
        gl = barneshut.group_lists(pos, mass, list_size=need)
    return gl


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nbody_tpu_torch.diag.pair_kernels")
    ap.add_argument("--splits", action="store_true",
                    help="also time every forced number of source slices a block")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device; pair_kernels times the kernels on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = fs.card_line()
    print(f"checkout {os.getcwd()} [{card}]", flush=True)
    times: dict[str, float] = {}
    shapes = k1_shapes(dev)
    for label, rect in shapes.items():
        times[label] = fs.best_ms(lambda: cuda_rect_accelerations(*rect))
        print(f"{label}: {times[label]:.4f} ms [{card}]", flush=True)
        if args.splits:
            for split in SPLITS:
                key = f"{label} split {split}"
                times[key] = fs.best_ms(lambda: cuda_rect_accelerations(*rect,
                                                                         _split=split))
                print(f"  {key}: {times[key]:.4f} ms", flush=True)
    square = shapes["K1 100k x 100k"]
    times["K2 100k x 100k"] = fs.best_ms(lambda: cuda_rect_accelerations(*square,
                                                                         use_mxu=True))
    print(f"K2 100k x 100k: {times['K2 100k x 100k']:.4f} ms [{card}]", flush=True)
    for name, mxu in (("K1", False), ("K2", True)):
        load = clock_and_power(lambda: cuda_rect_accelerations(*square, use_mxu=mxu))
        print(f"{name} 100k x 100k running: SM clock, power draw {'; '.join(load)} "
              f"[{card}]")
    del shapes, square
    for dtype, name, wrap in ((torch.float32, "f32", cuda_lists.eval_lists),
                              (torch.float64, "fp64", cuda_lists.eval_lists_f64)):
        gl = lists_1m(dev, dtype)
        g, b, _ = gl.pg.shape
        pairs = float((gl.group_valid.sum(1).double() * gl.lengths.double()).sum())
        label = f"K7 {name} 1M"
        times[label] = fs.best_ms(lambda: wrap(gl.pg, gl.lists, gl.lengths, eps2=0.01))
        print(f"{label} ({g} group slots, B {b}, M {gl.lists.shape[1]}, real pairs "
              f"{pairs:.4e}): {times[label]:.4f} ms [{card}]", flush=True)
        if args.splits and "_split" not in inspect.signature(wrap).parameters:
            print(f"  {label}: this checkout's {wrap.__name__} has no _split", flush=True)
        elif args.splits:
            for split in SPLITS:
                key = f"{label} split {split}"
                times[key] = fs.best_ms(lambda: wrap(gl.pg, gl.lists, gl.lengths,
                                                     eps2=0.01, _split=split))
                print(f"  {key}: {times[key]:.4f} ms", flush=True)
        del gl
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
