"""K3 and K5, the potential-energy kernels, timed on the card, through
calls that their earlier designs took as well, so the same file times an
older checkout too (copy it there and run it from that checkout's root):

    python -m nbody_tpu_torch.diag.pe_kernels

Prints, each beside the card's name and power limit: K3
(``cuda_potential_energy``, f32) and K5 (``cuda_potential_energy_f64``)
on the 100k main-path bodies (``tests/data/100k_bodies.csv``) and on the
1M uniform cloud (``random_cloud(1M, seed 0)``), each the best of several
calls after a warm-up, each call queued behind a spin kernel
(``fused_stages.best_ms``); and the SM clock and power draw while each
runs at 100k (nvidia-smi).  The last line is one JSON object {label: ms}.
It runs on the card only: with no card it exits 1 and says why.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from nbody_tpu_torch.diag import fused_stages as fs
from nbody_tpu_torch.diag.energy import cuda_potential_energy
from nbody_tpu_torch.diag.fp64_kernels import CSV_100K, clock_and_power
from nbody_tpu_torch.io.csv import read_bodies
from nbody_tpu_torch.ops.cuda_fp64 import cuda_potential_energy_f64
from nbody_tpu_torch.utils.fixtures import random_cloud

KERNELS = {"K3": (torch.float32, cuda_potential_energy),
           "K5": (torch.float64, cuda_potential_energy_f64)}
REPS = {"100k": 5, "1M": 3}


def bodies(device, dtype) -> dict:
    """{label: (pos, mass)} of the timed inputs in `dtype`."""
    out = {}
    for label, arr in (("100k", read_bodies(CSV_100K)),
                       ("1M", random_cloud(1_000_000, seed=0))):
        t = torch.as_tensor(arr, dtype=dtype, device=device)
        out[label] = (t[:, :3].contiguous(), t[:, 6].contiguous())
    return out


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(prog="python -m nbody_tpu_torch.diag.pe_kernels").parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device; pe_kernels times the kernels on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = fs.card_line()
    print(f"checkout {os.getcwd()} [{card}]", flush=True)
    times: dict[str, float] = {}
    for name, (dtype, wrap) in KERNELS.items():
        inputs = bodies(dev, dtype)
        for label, (pos, mass) in inputs.items():
            key = f"{name} {label}"
            times[key] = fs.best_ms(lambda: wrap(pos, mass), REPS[label])
            print(f"{key}: {times[key]:.4f} ms [{card}]", flush=True)
        pos, mass = inputs["100k"]
        load = clock_and_power(lambda: wrap(pos, mass))
        print(f"{name} 100k running: SM clock, power draw {'; '.join(load)} [{card}]",
              flush=True)
        del inputs
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
