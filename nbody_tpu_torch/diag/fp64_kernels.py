"""K4 and K6's df mode timed on the card, through calls that the kernels'
earlier designs took as well, so the same file times an older checkout
too (copy it there and run it from that checkout's root):

    python -m nbody_tpu_torch.diag.fp64_kernels

Prints, each beside the card's name and power limit: K4
(``cuda_rect_accelerations_f64``) on the 100k main-path bodies
(``tests/data/100k_bodies.csv``) and on the 100,003 x 4,099 and
1,000,000 x 1,953 rectangles of ``random_cloud``, best of 5 after a
warm-up; the SM clock and power draw while K4 runs (nvidia-smi); and K6's
df mode on the 1M uniform cloud and on the robust input at ld 8
(``with_escapers(plummer_cloud(1M))``, the robust box): its real pairs and
heaviest group, the wrapper (``fused_group_forces_df``), and every stage
cut launched in slot order (``bh_fused.kernel_forces``).  Each timed call
is queued behind a spin kernel (``fused_stages.best_ms``).  It runs on the
card only: with no card it exits 1 and says why.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import torch

from nbody_tpu_torch.diag import fused_stages as fs
from nbody_tpu_torch.io.csv import read_bodies
from nbody_tpu_torch.ops import bh_fused, bh_fused_df
from nbody_tpu_torch.ops.cuda_fp64 import cuda_rect_accelerations_f64
from nbody_tpu_torch.utils.fixtures import plummer_cloud, random_cloud, with_escapers

CSV_100K = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "100k_bodies.csv")
CUTS = ("none", "pops", "stage", "stagefar", "stagenear", "dma", "full")
F64 = torch.float64


def clock_and_power(fn, samples: int = 5) -> list[str]:
    """nvidia-smi's SM clock and power draw, sampled every 0.25 s while
    `fn` runs over and over."""
    out: list[str] = []

    def sample():
        for _ in range(samples):
            time.sleep(0.25)
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60)
            out.append(r.stdout.strip())

    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        fn()
        torch.cuda.synchronize()
    return out


def df_inputs(device):
    """{label: (K6 arguments, keywords)} of one df evaluation of the 1M
    uniform cloud and of the robust input's tree half at ld 8."""
    c = torch.as_tensor(random_cloud(1_000_000, seed=0), dtype=F64, device=device)
    uniform = fs.k6_args(bh_fused.prepare_fused(c[:, :3].contiguous(), c[:, 6].contiguous()))
    arr = with_escapers(plummer_cloud(1_000_000, seed=0))
    pos = torch.as_tensor(arr[:, :3], dtype=F64, device=device)
    mass = torch.as_tensor(arr[:, 6], dtype=F64, device=device)
    center, border, out_idx = bh_fused.robust_box(pos)
    robust = fs.k6_args(bh_fused.prepare_fused(pos - center.to(F64),
                                               mass.index_fill(0, out_idx, 0.0), ld=8,
                                               border=border))
    return {"1M uniform": uniform, "robust ld 8": robust}


def main(argv: list[str] | None = None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("error: no CUDA device; fp64_kernels times the kernels on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = fs.card_line()
    arr = torch.as_tensor(read_bodies(CSV_100K), dtype=F64, device=dev)
    pos, mass = arr[:, :3].contiguous(), arr[:, 6].contiguous()
    c = torch.as_tensor(random_cloud(1_000_000, seed=0), device=dev)
    shapes = {"100k x 100k": (pos, pos, mass)}
    for m, n in ((100_003, 4_099), (1_000_000, 1_953)):
        shapes[f"{m} x {n}"] = (c[:m, :3].contiguous(), c[:n, :3].contiguous(),
                                c[:n, 6].contiguous())
    for label, args in shapes.items():
        ms = fs.best_ms(lambda: cuda_rect_accelerations_f64(*args))
        print(f"K4 {label}: {ms:.4f} ms [{card}]", flush=True)
    load = clock_and_power(lambda: cuda_rect_accelerations_f64(pos, pos, mass))
    print(f"K4 100k x 100k running: SM clock, power draw {'; '.join(load)} [{card}]")
    for label, (args, kw) in df_inputs(dev).items():
        _, stats = bh_fused_df.fused_group_forces_df(*args, **kw)
        gcount = args[2].long()
        work = stats[:, bh_fused.S_SRC].long() * gcount
        h = int(work.argmax())
        print(f"K6 df {label}: ld {kw['ld']}, {gcount.numel()} group slots, real pairs "
              f"{float(work.double().sum()):.4e}, heaviest group "
              f"{int(stats[h, bh_fused.S_SRC])} sources x {int(gcount[h])} bodies = "
              f"{float(work[h]):.4e} pairs", flush=True)
        wrapper = fs.best_ms(lambda: bh_fused_df.fused_group_forces_df(*args, **kw), 3)
        print(f"  the wrapper: {wrapper:.4f} ms [{card}]", flush=True)
        times = {cut: fs.best_ms(lambda: bh_fused.kernel_forces(F64, *args, **kw,
                                                                debug_mode=cut),
                                 3 if cut == "full" else 5) for cut in CUTS}
        print(fs.report(times, f"  stage cuts in slot order [{card}]"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
