"""The PyTorch port imports without jax, triton or the JAX package,
importing it builds no kernel, and it opens no file of the JAX package."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "nbody_tpu_torch", "_build")
CHECK = (
    "import sys; bad = {'jax', 'triton', 'nbody_tpu'} & set(sys.modules); "
    "bad |= {m for m in sys.modules if m.startswith(('jax.', 'nbody_tpu.'))}; "
    "assert not bad, sorted(bad)"
)


def _run(code: str) -> None:
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _kernel_libs() -> set:
    if not os.path.isdir(BUILD):
        return set()
    return {f for f in os.listdir(BUILD) if f.startswith("kernels-")}


def test_package_import_and_lazy_exports():
    _run("import nbody_tpu_torch; nbody_tpu_torch.Bodies; "
         "nbody_tpu_torch.cuda_accelerations; "
         "nbody_tpu_torch.barneshut_accelerations; " + CHECK)


def test_every_module_imports_clean_and_builds_nothing():
    before = _kernel_libs()
    _run(
        "import nbody_tpu_torch.cli.main, nbody_tpu_torch.ops.cuda_exhaustive, "
        "nbody_tpu_torch.ops._cuda, nbody_tpu_torch.diag.energy, "
        "nbody_tpu_torch.ops.bh_fused, nbody_tpu_torch.ops.bh_grid, "
        "nbody_tpu_torch.ops.bh_fused_df, nbody_tpu_torch.ops.cuda_fp64, "
        "nbody_tpu_torch.ops.morton, nbody_tpu_torch.ops.barneshut, "
        "nbody_tpu_torch.core.capacity, nbody_tpu_torch.utils.fixtures, "
        "nbody_tpu_torch.integrate.leapfrog, nbody_tpu_torch.io.csv, "
        "nbody_tpu_torch.ops.bh_tree, nbody_tpu_torch.ops.bh_traverse, "
        "nbody_tpu_torch.ops.bh_traverse_flat, nbody_tpu_torch.ops.cuda_lists, "
        "nbody_tpu_torch.diag.treedump, nbody_tpu_torch.ops.bh_autold, "
        "nbody_tpu_torch.diag.fused_stages, nbody_tpu_torch.diag.fp64_kernels, "
        "nbody_tpu_torch.diag.pair_kernels, nbody_tpu_torch.diag.pe_kernels, "
        "nbody_tpu_torch.diag.sass, nbody_tpu_torch.ops.bh_persistent, "
        "nbody_tpu_torch.diag.timing, nbody_tpu_torch.diag.bh_phases, "
        "nbody_tpu_torch.io.checkpoint, nbody_tpu_torch.ops.collisions, "
        "nbody_tpu_torch.integrate.adaptive, "
        "nbody_tpu_torch.__main__; " + CHECK
    )
    assert _kernel_libs() == before


def _path_literals(source: str) -> list:
    """(line, text) of the string literals of `source` that name the JAX
    package as a path ("nbody_tpu" alone, or "nbody_tpu/" within), other
    than docstrings and the values of "replaces" keys (the labels of the
    TPU kernels a CUDA kernel replaces)."""
    tree = ast.parse(source)
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                skip.add(id(body[0].value))
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    skip.update(id(sub) for sub in ast.walk(v))
    return [(n.lineno, n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in skip
            and (n.value == "nbody_tpu" or "nbody_tpu/" in n.value)]


def test_no_source_names_a_path_of_the_jax_package():
    """No module of nbody_tpu_torch and no line of chip_smoke.py builds a
    path under nbody_tpu/; the scan finds the loader's former one."""
    pkg = os.path.join(REPO, "nbody_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    found = {f: _path_literals(open(f).read()) for f in files}
    assert not {f: hits for f, hits in found.items() if hits}
    former = '_SRC = os.path.join(os.path.dirname(_PKG), "nbody_tpu", "native", "fastcsv.cpp")'
    assert _path_literals(former) == [(1, "nbody_tpu")]


def test_a_run_opens_no_file_of_the_jax_package(tmp_path):
    """A CLI run that builds the native library, writes frames and a
    checkpoint and resumes from it, under an audit hook: no file under
    nbody_tpu/ is opened and no library there loaded."""
    jax_pkg = os.path.join(REPO, "nbody_tpu") + os.sep
    out, ck = tmp_path / "o.csv", tmp_path / "c.csv"
    code = (
        "import os, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen') and args and isinstance(args[0], (str, bytes)):\n"
        "        seen.append(os.path.abspath(os.fsdecode(args[0])))\n"
        "sys.addaudithook(hook)\n"
        "from nbody_tpu_torch.cli.main import main\n"
        f"argv = ['tests/data/10_bodies.csv', '0', '0.2', '0.1', {str(out)!r}, '--device', 'cpu']\n"
        f"assert main(argv + ['--checkpoint-every', '1', '--checkpoint', {str(ck)!r}]) == 0\n"
        f"argv[0] = {str(ck)!r}\n"
        "assert main(argv + ['--resume']) == 0\n"
        f"bad = [p for p in seen if p.startswith({jax_pkg!r})]\n"
        "assert not bad, bad\n"
        "assert any(p.endswith('fastcsv.cpp') for p in seen) or any('fastcsv-' in p for p in seen)\n"
    )
    _run(code)
