"""The PyTorch port imports without jax, triton or the JAX package, and
importing it builds no kernel."""

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
        "nbody_tpu_torch.__main__; " + CHECK
    )
    assert _kernel_libs() == before
