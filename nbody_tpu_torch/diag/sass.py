"""Instruction counts of the kernels' SASS, from ``cuobjdump -sass``.

Every pair evaluation of the pair kernels takes exactly one reciprocal
square root (MUFU.RSQ in f32, MUFU.RSQ64H in fp64), so the count of an
instruction over the count of that rsqrt is its count a pair.  Over a
kernel's whole SASS that ratio also holds the few instructions outside its
pair loops; over its hot loop, the innermost loop that holds the rsqrt,
it is what the card issues a pair in the steady state.
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump_sass(nvcc: str, so_path: str) -> str | None:
    """``cuobjdump -sass`` of the library at `so_path`, with the cuobjdump
    beside `nvcc`; None where there is none."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        return None
    return subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def _key(op: str) -> str:
    """The counted name: MUFU.* in full, others without their modifiers."""
    return op if op.startswith("MUFU.") else op.split(".")[0]


def kernels(sass: str) -> dict[str, list[tuple[int, str, int | None]]]:
    """{kernel (mangled name): [(address, opcode, target of a backward
    branch or None)]}."""
    out: dict[str, list] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = []
            continue
        m = _INSTR.search(line) if fn else None
        if m:
            addr, op = int(m.group(1), 16), m.group(2)
            target = None
            if op.startswith("BRA"):
                t = _TARGET.search(m.group(3))
                if t and int(t.group(1), 16) <= addr:
                    target = int(t.group(1), 16)
            out[fn].append((addr, op, target))
    return out


def whole(instrs) -> Counter:
    """Every instruction of one kernel, by counted name."""
    return Counter(_key(op) for _, op, _ in instrs)


def hot_loop(instrs, op: str) -> Counter:
    """The instructions of the hot loop: of the innermost loops (a range
    from a backward branch's target to the branch, holding no other), the
    one with the most `op` (an unrolled body over its remainder loop);
    empty where no loop holds `op`."""
    loops = [(target, addr) for addr, _, target in instrs if target is not None]
    best, most = Counter(), 0
    for lo, hi in loops:
        if any(lo <= lo2 and hi2 < hi for lo2, hi2 in loops if (lo2, hi2) != (lo, hi)):
            continue
        body = Counter(_key(o) for a, o, _ in instrs if lo <= a <= hi)
        if body[op] > most:
            best, most = body, body[op]
    return best


def per(c: Counter, op: str, names) -> float:
    """Instructions `names` (all of them where None) per `op` in `c`."""
    n = sum(c.values()) if names is None else sum(c[k] for k in names)
    return n / c[op]


FP32 = ("FADD", "FMUL", "FFMA")
FP64 = ("DADD", "DMUL", "DFMA")
