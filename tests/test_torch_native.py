"""The kernel builder's host logic (ops/_native.py): where the library goes,
when it is rebuilt, and what happens without a CUDA toolkit. Building and
launching need nvcc and a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import shutil

import pytest

from speechrecognition_torch.ops import _native


def test_library_path_is_keyed_by_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_native.CSRC, csrc)
    monkeypatch.setattr(_native, "CSRC", csrc)
    first = _native.library_path()
    assert first.parent == _native.BUILD_DIR
    assert first.name.startswith("libsr_kernels_") and first.suffix == ".so"
    assert _native.library_path() == first
    src = csrc / "decode_scan.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _native.library_path() != first


def test_sources_are_the_two_kernels():
    assert [p.name for p in _native._sources()] == ["decode_scan.cu", "mahalanobis.cu"]
    assert "sm_90a" in " ".join(_native.NVCC_FLAGS)
    assert set(_native.SIGNATURES) == {"sr_mahalanobis_scores", "sr_decode_scan",
                                       "sr_error_string"}


def test_missing_toolkit_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native._nvcc()
