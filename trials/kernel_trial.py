"""Trial builds of K7's f32 entry and of K2 on the card, each timed in turns
against its earlier body.  From the root of the repo:

    python -m trials.kernel_trial --parent DIR

DIR is a checkout of the tree before the redesign (``git archive`` of it,
unpacked): its ``csrc/group_lists.cu`` holds K7 f32's earlier body (one
thread a slot, no split) and its ``csrc/allpairs_mma.cu`` K2's.  Each build
compiles one source alone with nvcc for sm_90a into a library of its own
under ``nbody_tpu_torch/_build/trial/``, with the constants that ``BUILDS``
names rewritten (``kTileF32`` is K7's f32 tile alone, the fp64 entry
keeping its own); ``allpairs_wgmma.cu`` beside this script is K2 with its
product on wgmma, and ``tf32_probe.cu`` the probe below: the port builds
neither.  It prints, each beside the card's
name and power limit:

* ptxas's registers and spills of every build, and the SASS a pair of its
  hot loop (``nbody_tpu_torch/diag/sass.py``);
* the TF32 probe: what the tensor cores make of an f32 operand whose bits
  below TF32's mantissa are set, and whether CUTLASS's headers (``--cutlass``)
  hold a register-sourced TF32 wgmma atom;
* K7 f32: every build at S = 1, 2, 4 and 8 list slices a block (the
  earlier body at its one shape) on the flat traversal's lists of the 1M
  uniform cloud (``random_cloud(1M, seed 0)``) and of the 100k main-path
  bodies (``tests/data/100k_bodies.csv``), each held to K1's bound against
  the plain version;
* K2: every build on the 100k bodies, against its plain version and K1's
  (the displacement form), and on that cloud offset by (8, -8, 8) from the
  origin against K1's plain version, K1's bound in each;
* the times: the best of 5 after a warm-up, each call behind a spin kernel
  (``fused_stages.best_ms``), over the builds in order and then in reverse
  (the wgmma build last, after the checks of the others, with the shipped
  K2 beside it: K2, wgmma, wgmma, K2).

The last line is one JSON object {label: ms}.  It runs on the card only:
with no card it exits 1 and says why.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from nbody_tpu_torch.diag import fused_stages as fs
from nbody_tpu_torch.diag import sass as sa
from nbody_tpu_torch.io.csv import read_bodies
from nbody_tpu_torch.ops import _cuda, barneshut, cuda_lists
from nbody_tpu_torch.ops.cuda_exhaustive import (
    rect_accelerations_mxu_reference,
    rect_accelerations_reference,
)
from nbody_tpu_torch.utils.fixtures import random_cloud

HERE = os.path.dirname(os.path.abspath(__file__))
CSV_100K = os.path.join(os.path.dirname(HERE), "tests", "data", "100k_bodies.csv")
TRIAL_DIR = os.path.join(_cuda.BUILD_DIR, "trial")
SPLITS = (1, 2, 4, 8)
OFFSET = (8.0, -8.0, 8.0)
ATOL_REL, RTOL = 2e-5, 2e-4  # K1's bound (tests/test_pallas.py:25)

# (label, kernel, source: "csrc", "parent" or "here", its file, constants)
BUILDS = [
    ("K7 f32 earlier body", "k7_old", "parent", "group_lists.cu", {}),
    ("K7 f32", "k7", "csrc", "group_lists.cu", {}),
    ("K7 f32 tile 256", "k7", "csrc", "group_lists.cu", {"kTileF32": 256}),
    ("K7 f32 tile 1024", "k7", "csrc", "group_lists.cu", {"kTileF32": 1024}),
    ("K7 f32 tile 2048", "k7", "csrc", "group_lists.cu", {"kTileF32": 2048}),
    ("K2 earlier body", "k2", "parent", "allpairs_mma.cu", {}),
    ("K2", "k2", "csrc", "allpairs_mma.cu", {}),
    ("K2 chain 1", "k2", "csrc", "allpairs_mma.cu", {"kChain": 1}),
    ("K2 chain 64", "k2", "csrc", "allpairs_mma.cu", {"kChain": 64}),
    ("K2 tile 256", "k2", "csrc", "allpairs_mma.cu", {"kTile": 256}),
    ("K2 2 m-tiles, 8 warps", "k2", "csrc", "allpairs_mma.cu", {"kMT": 2, "kWarps": 8}),
    ("K2 1 m-tile, 8 warps", "k2", "csrc", "allpairs_mma.cu", {"kMT": 1, "kWarps": 8}),
    ("K2 wgmma", "wgmma", "here", "allpairs_wgmma.cu", {}),
    ("TF32 probe", "probe", "here", "tf32_probe.cu", {}),
]


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


def variant(path: str, consts: dict) -> str:
    """The source at `path` with each `constexpr int NAME = value;` of
    `consts` set to its value."""
    with open(path) as f:
        src = f.read()
    for name, value in consts.items():
        src, hits = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", src)
        if hits != 1:
            raise ValueError(f"{path}: no single constant {name}")
    return src


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each kind's entry point and its C signature
ENTRIES = {
    "k7_old": ("nbody_group_lists_f32", [_P, _P, _P, _I, _I, _I, _F, _P, _P]),
    "k7": ("nbody_group_lists_f32", [_P, _P, _P, _I, _I, _I, _F, _I, _P, _P]),
    "k2": ("nbody_allpairs_mma_f32", [_P, _P, _P, _P, _P, _F, _I, _I, _P, _P]),
    "wgmma": ("nbody_allpairs_wgmma_f32", [_P, _P, _P, _F, _I, _I, _P, _P]),
    "probe": ("nbody_tf32_probe", [_P]),
}


def load(so: str, kind: str):
    """The library at `so` with its kind's entry point declared."""
    lib = ctypes.CDLL(so)
    name, argtypes = ENTRIES[kind]
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = _I, argtypes
    return lib


def build_all(parent: str) -> tuple[str, dict]:
    """Compile every build at once; returns (nvcc, {label: (CDLL or None,
    nvcc's log)})."""
    nvcc = _cuda.find_nvcc()
    os.makedirs(TRIAL_DIR, exist_ok=True)
    dirs = {"csrc": _cuda.CSRC_DIR, "parent": os.path.join(parent, "nbody_tpu_torch", "csrc"),
            "here": HERE}
    procs = {}
    for k, (label, kind, where, name, consts) in enumerate(BUILDS):
        src = os.path.join(TRIAL_DIR, f"b{k}.cu")
        with open(src, "w") as f:
            f.write(variant(os.path.join(dirs[where], name), consts))
        so = os.path.join(TRIAL_DIR, f"b{k}.so")
        procs[label] = (so, kind, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I", dirs[where],
             "-I", _cuda.CSRC_DIR, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (so, kind, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        out[label] = (load(so, kind) if proc.returncode == 0 else None, log)
    return nvcc, out


def report_build(nvcc: str, label: str, lib, log: str, so: str) -> None:
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "error" in ln or "arning" in ln]
    print(f"{label}: {'built' if lib else 'FAILED'}; " + " | ".join(regs), flush=True)
    text = sa.cuobjdump_sass(nvcc, so) if lib else None
    for fn, instrs in sa.kernels(text or "").items():
        loop = sa.hot_loop(instrs, "MUFU.RSQ")
        if loop:
            print(f"  {fn}: hot loop per MUFU.RSQ: fp32 {sa.per(loop, 'MUFU.RSQ', sa.FP32):.2f}, "
                  f"all issued {sa.per(loop, 'MUFU.RSQ', None):.2f} ("
                  + ", ".join(f"{k} {v / loop['MUFU.RSQ']:.2f}" for k, v in loop.most_common(10))
                  + ")")


def probe(lib, cutlass: str) -> None:
    out = torch.zeros(2, device="cuda")
    err = lib.nbody_tf32_probe(out.data_ptr())
    torch.cuda.synchronize()
    got, a = out.tolist()
    kind = {1.0: "drops the low 13 bits", 1.0 + 2**-10: "rounds to TF32"}.get(
        got, "reads more than TF32" if got == a else "?")
    print(f"TF32 probe (err {err}): mma.sync of {a!r} x 1 gives {got!r}: the tensor cores "
          f"{kind}", flush=True)
    header = os.path.join(cutlass, "cute", "arch", "mma_sm90_gmma.hpp")
    if not os.path.isfile(header):
        print(f"CUTLASS: {header} not found")
        return
    with open(header) as f:
        text = f.read()
    atoms = re.findall(r"struct (\w*64x8x8_F32TF32TF32\w*)", text)
    print(f"CUTLASS {header}: TF32 m64n8k8 atoms {atoms}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trials.kernel_trial")
    ap.add_argument("--parent", required=True, help="checkout of the tree before")
    ap.add_argument("--cutlass", default="/usr/local/cutlass/include")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device; kernel_trial times the kernels on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = fs.card_line()
    print(f"kernel trial [{card}]", flush=True)
    nvcc, libs = build_all(os.path.abspath(args.parent))
    for k, (label, *_rest) in enumerate(BUILDS):
        report_build(nvcc, label, *libs[label], os.path.join(TRIAL_DIR, f"b{k}.so"))
    if libs["TF32 probe"][0] is not None:
        probe(libs["TF32 probe"][0], args.cutlass)
    stream = torch.cuda.current_stream().cuda_stream
    times: dict[str, float] = {}

    # K7 f32
    arr = torch.as_tensor(read_bodies(CSV_100K), dtype=torch.float32, device=dev)
    pos, mass = arr[:, :3].contiguous(), arr[:, 6].contiguous()
    inputs = {"1M": lists_1m(dev, torch.float32),
              "100k": barneshut.group_lists(pos, mass)}
    k7 = [(label, libs[label][0], kind) for label, kind, *_ in BUILDS
          if kind in ("k7", "k7_old") and libs[label][0] is not None]

    def k7_call(lib, kind, gl, split):
        g, b, _ = gl.pg.shape
        out = torch.empty_like(gl.pg)
        extra = [] if kind == "k7_old" else [split]
        err = lib.nbody_group_lists_f32(gl.pg.data_ptr(), gl.lists.data_ptr(),
                                        gl.lengths.data_ptr(), g, b, gl.lists.shape[1], 0.01,
                                        *extra, out.data_ptr(), stream)
        return err, out

    for name, gl in inputs.items():
        want = cuda_lists.eval_lists_reference(gl.pg, gl.lists, gl.lengths, eps2=0.01)
        scale = want.abs().max().item()
        g, b, _ = gl.pg.shape
        print(f"K7 f32 on the {name} lists: {g} group slots, B {b}, M {gl.lists.shape[1]}",
              flush=True)
        for label, lib, kind in k7:
            for split in ((None,) if kind == "k7_old" else SPLITS):
                err, got = k7_call(lib, kind, gl, split)
                torch.cuda.synchronize()
                d = (got - want).abs()
                ok = err == 0 and bool((d <= ATOL_REL * scale + RTOL * want.abs()).all())
                print(f"  {label} S {split}: launch {err}, max |err| / scale "
                      f"{d.max().item() / scale:.3e}, within K1's bound {ok}", flush=True)
        for rnd, order in enumerate((k7, k7[::-1])):
            for label, lib, kind in order:
                for split in ((None,) if kind == "k7_old" else SPLITS):
                    key = f"K7 f32 {name} {label} S {split} round {rnd}"
                    times[key] = fs.best_ms(lambda: k7_call(lib, kind, gl, split))
                    print(f"  {key}: {times[key]:.4f} ms [{card}]", flush=True)
        del want
    del inputs

    # K2
    gm = mass * 1.0
    off = (pos + torch.tensor(OFFSET, device=dev)).contiguous()

    def k2_call(lib, kind, p):
        out = torch.empty_like(p)
        n = p.shape[0]
        if kind == "wgmma":
            err = lib.nbody_allpairs_wgmma_f32(p.data_ptr(), p.data_ptr(), gm.data_ptr(), 0.01,
                                               n, n, out.data_ptr(), stream)
        else:
            err = lib.nbody_allpairs_mma_f32(p.data_ptr(), p.data_ptr(), gm.data_ptr(), None,
                                             None, 0.01, n, n, out.data_ptr(), stream)
        return err, out

    refs = {"plain": rect_accelerations_mxu_reference(pos, pos, mass),
            "K1 plain": rect_accelerations_reference(pos, pos, mass),
            "offset K1 plain": rect_accelerations_reference(off, off, mass)}

    def k2_check(label, lib, kind) -> bool:
        oks = []
        for ref, p in (("plain", pos), ("K1 plain", pos), ("offset K1 plain", off)):
            err, got = k2_call(lib, kind, p)
            torch.cuda.synchronize()
            want = refs[ref]
            scale = want.abs().max().item()
            d = (got - want).abs()
            ok = err == 0 and bool((d <= ATOL_REL * scale + RTOL * want.abs()).all())
            again = k2_call(lib, kind, p)[1]
            oks.append(ok)
            print(f"  {label} against {ref}: launch {err}, max |err| / scale "
                  f"{d.max().item() / scale:.3e}, within K1's bound {ok}, rerun bit-identical "
                  f"{torch.equal(again, got)}", flush=True)
        return all(oks)

    print(f"K2 on the 100k bodies ({pos.shape[0]} x {pos.shape[0]})", flush=True)
    k2 = [(label, libs[label][0], kind) for label, kind, *_ in BUILDS
          if kind == "k2" and libs[label][0] is not None]
    for label, lib, kind in k2:
        k2_check(label, lib, kind)
    for rnd, order in enumerate((k2, k2[::-1])):
        for label, lib, kind in order:
            key = f"{label} 100k round {rnd}"
            times[key] = fs.best_ms(lambda: k2_call(lib, kind, pos))
            print(f"  {key}: {times[key]:.4f} ms [{card}]", flush=True)
    wg = libs["K2 wgmma"][0]
    if wg is not None and k2_check("K2 wgmma", wg, "wgmma"):
        shipped = libs["K2"][0]
        for rnd, (label, lib, kind) in enumerate((("K2", shipped, "k2"), ("K2 wgmma", wg, "wgmma"),
                                                  ("K2 wgmma", wg, "wgmma"), ("K2", shipped, "k2"))):
            key = f"{label} 100k beside wgmma, turn {rnd}"
            times[key] = fs.best_ms(lambda: k2_call(lib, kind, pos))
            print(f"  {key}: {times[key]:.4f} ms [{card}]", flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
