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
    """The kernel sources (A mahalanobis, B decode_scan in f32 and f64, C
    am_scores_df, D decode_scan_df) and the shared double-float header."""
    assert [p.name for p in _native._sources()] == [
        "am_scores_df.cu", "decode_scan.cu", "decode_scan_df.cu", "mahalanobis.cu", "df.cuh"]
    assert "sm_90a" in " ".join(_native.NVCC_FLAGS)
    assert "--fmad=false" not in _native.NVCC_FLAGS
    assert set(_native.SIGNATURES) == {
        "sr_mahalanobis_scores", "sr_decode_scan", "sr_decode_scan_f64", "sr_am_scores_df",
        "sr_decode_scan_df", "sr_error_string"}


def test_header_edit_rebuilds(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_native.CSRC, csrc)
    monkeypatch.setattr(_native, "CSRC", csrc)
    first = _native.library_path()
    hdr = csrc / "df.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _native.library_path() != first


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per source, started together, then one link; the objects are
    removed and a failing source names itself."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_nvcc", lambda: "nvcc")
    calls = []

    def fake_run_all(cmds):
        calls.append(cmds)
        for c in cmds:
            out = c[c.index("-o") + 1]
            with open(out, "w") as f:
                f.write("x")
        return [(0, "ptxas info    : Used 1 registers\n")] * len(cmds)

    monkeypatch.setattr(_native, "_run_all", fake_run_all)
    out = tmp_path / "libsr_kernels_test.so"
    _native._build(out)
    compiles, (link,) = calls
    assert [c[-1].rsplit("/", 1)[-1] for c in compiles] == [
        "am_scores_df.cu", "decode_scan.cu", "decode_scan_df.cu", "mahalanobis.cu"]
    assert all("-c" in c and "-shared" not in c for c in compiles)
    assert "-shared" in link and out.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]
    assert "ptxas info" in _native.build_log

    def failing(cmds):
        return [(1 if "decode_scan_df.cu" in c[-1] else 0, "error here") for c in cmds]

    monkeypatch.setattr(_native, "_run_all", failing)
    with pytest.raises(RuntimeError, match="decode_scan_df.cu"):
        _native._build(tmp_path / "libsr_kernels_fail.so")


def test_missing_toolkit_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native._nvcc()
