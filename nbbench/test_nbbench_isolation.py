"""What the benchmark loads: no JAX and no JAX package anywhere, and
nothing of the program in the reference.  Top-level module names are
compared whole: ``nbody_tpu_torch`` is the port, not ``nbody_tpu``."""

import ast
import json
import os
import subprocess
import sys

from nbbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_readers_load_no_jax():
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in spec.benchmark()[s]]
    top = _loaded("import nbbench.run, nbbench.control, nbbench.trace\n"
                  "from nbbench import spec\n"
                  f"[spec.reader(m) for m in {names!r}]")
    assert not top & FORBIDDEN


def test_a_run_through_the_port_loads_no_jax():
    """A whole CPU run of a shrunk cell: what the port imports counts too."""
    top = _loaded("import torch\nfrom nbbench import run, spec\nfrom nbbench.small import small\n"
                  "cell, config, extra = small('bh1m-f32-resort4')\n"
                  "run.run_cell('bh1m-f32-resort4', 5, 0.05, False, torch.device('cpu'), "
                  "bench=spec.benchmark(), cell=cell, config=config, extra=extra)")
    assert "nbody_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import nbbench.reference, nbbench.check, nbbench.gen")
    assert not top & (FORBIDDEN | {"nbody_tpu_torch"})


def test_no_source_imports_jax():
    """Every import statement under nbbench/; the reference, the check and
    the generators import nothing of the program either."""
    apart = {"reference.py", "check.py", "gen.py"}
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    tops.add(node.module.split(".")[0])
            assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
            if f in apart:
                assert "nbody_tpu_torch" not in tops, f
