"""The port's kernel build layer (nbody_tpu_torch/ops/_cuda.py) raises on
every failure: no nvcc, a compile error, a launcher's CUDA error."""

import os
import types

import pytest

from nbody_tpu_torch.ops import _cuda


def _no_cached_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))


def test_sources_are_the_two_kernels():
    """The build takes every kernel source: all-pairs and potential energy
    in f32 (the first slice) and fp64, the tensor-core all-pairs kernel, the
    fused Barnes-Hut kernel and the group x interaction-list kernel."""
    names = [os.path.basename(s) for s in _cuda.sources()]
    assert names == ["allpairs.cu", "allpairs_f64.cu", "allpairs_mma.cu", "bh_fused.cu",
                     "group_lists.cu", "potential.cu", "potential_f64.cu"]


def test_headers_are_hashed_not_compiled(monkeypatch, tmp_path):
    """A header the kernels include is not compiled on its own, but a change
    to it names a new library, so a stale build is never loaded."""
    assert [os.path.basename(h) for h in _cuda.headers()] == [
        "pair_f32.cuh", "pair_f64.cuh", "pe_triangle.cuh", "rsqrt.cuh", "split_sum.cuh"]
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", str(tmp_path))
    assert [os.path.basename(s) for s in _cuda.sources()] == ["k.cu"]
    before = _cuda.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _cuda.library_path() != before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc in /usr/local/cuda/bin")
    _no_cached_library(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_cuda.CudaKernelError, match="nvcc not found"):
        _cuda._build()


def test_compile_error_raises_with_the_log(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'allpairs.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    _no_cached_library(monkeypatch, tmp_path)
    monkeypatch.setattr(_cuda, "find_nvcc", lambda: str(fake))
    with pytest.raises(_cuda.CudaKernelError, match="exit 2") as e:
        _cuda._build()
    assert "error: broken" in str(e.value)
    assert os.listdir(tmp_path / "build") == []


def test_launcher_error_raises():
    k = object.__new__(_cuda.Kernels)
    k.lib = types.SimpleNamespace(
        nbody_cuda_error_string=lambda err: b"invalid configuration argument"
    )
    k.check(0, "allpairs kernel")  # success is silent
    with pytest.raises(_cuda.CudaKernelError, match="CUDA error 9"):
        k.check(9, "allpairs kernel")


def test_sm90a_target():
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_k6_f32_hot_loop_on_k1_budget():
    """K6 f32's pair loop (bh_fused_warp_kernel<6>, the production cut)
    issues K1's pair term: in its hot loop at most 12.5 fp32 instructions a
    MUFU.RSQ (12 a pair and the loop's share of the rest), and no FSETP,
    which CUDA's rsqrtf brings with its scaling for subnormal inputs.  Needs
    the card's toolkit (nvcc and cuobjdump beside it), not the card."""
    from nbody_tpu_torch.diag import sass

    try:
        nvcc = _cuda.find_nvcc()
    except _cuda.CudaKernelError:
        pytest.skip("nvcc is needed to build the kernels")
    text = sass.cuobjdump_sass(nvcc, _cuda.library().path)
    if text is None:
        pytest.skip("cuobjdump is needed beside nvcc to read the SASS")
    (instrs,) = [i for fn, i in sass.kernels(text).items()
                 if "bh_fused_warp_kernelILi6E" in fn]
    loop = sass.hot_loop(instrs, "MUFU.RSQ")
    assert loop["MUFU.RSQ"] >= 2  # the loop serves a thread's two bodies
    assert sass.per(loop, "MUFU.RSQ", sass.FP32) <= 12.5
    assert loop["FSETP"] == 0
