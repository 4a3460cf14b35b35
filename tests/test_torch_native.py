"""The kernel builder's host logic (ops/_native.py): where the library goes,
when it is rebuilt, and what happens without a CUDA toolkit. Building and
launching need nvcc and a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import ctypes
import re
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


SOURCES = ["align_backtrack.cu", "align_scan.cu", "align_scan_df.cu", "am_scores_df.cu",
           "decode_scan.cu", "decode_scan_bigram.cu", "decode_scan_df.cu", "em_pass_df.cu",
           "forward_backward.cu", "linear_lvcsr_scan.cu", "linear_traceback.cu",
           "mahalanobis.cu", "quantized_scores.cu", "tree_scan.cu", "wcts_scan.cu",
           "wcts_shard_step.cu"]


def test_sources_are_the_eight_kernels_and_the_header():
    """The kernel sources (A mahalanobis, unfused and with the per-mixture
    minimum fused, B decode_scan in f32 and f64, C
    am_scores_df, D decode_scan_df, E align_scan in f32 and f64, F
    align_scan_df, G align_backtrack, H em_pass_df, I tree_scan, J
    decode_scan_bigram, K wcts_scan, L forward_backward, M linear_lvcsr_scan, N
    linear_traceback, O quantized_scores, P wcts_shard_step with its two
    launches' entries), the shared double-float header, the
    histogram header, the scans' order-key header and the search tier's
    block helpers; the scans' instance, residency and scratch queries
    (kernels M and O among them since their redesigns: M's instance, O's
    tile, scratch and residency). Kernel N keeps its one entry,
    sr_linear_traceback, whose first_design argument chooses between its
    warp design and its first design; it has no query."""
    assert [p.name for p in _native._sources()] == SOURCES + ["df.cuh", "histogram.cuh",
                                                              "keys.cuh", "search.cuh"]
    assert "sm_90a" in " ".join(_native.NVCC_FLAGS)
    assert "--fmad=false" not in _native.NVCC_FLAGS
    assert set(_native.SIGNATURES) == {
        "sr_mahalanobis_scores", "sr_mahalanobis_min", "sr_decode_scan", "sr_decode_scan_f64",
        "sr_decode_scan_instance", "sr_decode_scan_residency", "sr_am_scores_df",
        "sr_decode_scan_df", "sr_decode_scan_df_instance", "sr_decode_scan_df_threads",
        "sr_decode_scan_df_residency", "sr_decode_scan_df_scratch",
        "sr_align_fwd", "sr_align_fwd_f64", "sr_align_fwd_warps", "sr_align_fwd_positions",
        "sr_align_fwd_df",
        "sr_align_fwd_df_warps", "sr_align_fwd_df_positions", "sr_align_fwd_df_scratch",
        "sr_align_backtrack", "sr_align_backtrack_tile",
        "sr_em_pass_df",
        "sr_em_pass_df_scratch", "sr_tree_scan", "sr_tree_scan_scratch",
        "sr_tree_scan_instance", "sr_tree_scan_residency",
        "sr_decode_scan_bigram", "sr_decode_scan_bigram_scratch",
        "sr_decode_scan_bigram_instance", "sr_decode_scan_bigram_residency", "sr_wcts_scan",
        "sr_wcts_scan_scratch", "sr_wcts_scan_instance", "sr_wcts_scan_residency",
        "sr_forward_backward", "sr_forward_backward_chain", "sr_forward_backward_instance",
        "sr_forward_backward_warps", "sr_forward_backward_residency", "sr_linear_scan", "sr_linear_scan_scratch",
        "sr_linear_scan_instance", "sr_linear_scan_residency", "sr_linear_traceback",
        "sr_quantized_scores", "sr_quantized_scores_tile", "sr_quantized_scores_scratch",
        "sr_quantized_scores_residency", "sr_wcts_shard_entries", "sr_wcts_shard_ends",
        "sr_wcts_shard_instance", "sr_wcts_shard_residency",
        "sr_error_string"}


def c_entry_points():
    """name → (parameter declarations, result type) of every extern "C"
    function in csrc/*.cu."""
    found = {}
    for src in sorted(_native.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" ([\w ]+?\*?) *(sr_\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(2)] = ([p.strip() for p in m.group(3).split(",")], m.group(1).strip())
    return found


def ctype_of(decl: str):
    if "*" in decl:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
            "long": ctypes.c_longlong}[decl.split()[0]]


def test_every_entry_point_has_its_signature():
    """Every C entry point of every source is bound, with one ctypes type per
    parameter that matches its declaration (a pointer, int, float or
    double passed as another type would be cut or misread silently)."""
    found = c_entry_points()
    assert set(found) == set(_native.SIGNATURES)
    for name, (params, result) in found.items():
        argtypes, restype = _native.SIGNATURES[name]
        assert list(argtypes) == [ctype_of(p) for p in params], name
        assert restype == (ctypes.c_char_p if result == "const char*" else ctypes.c_int), name


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
    assert [c[-1].rsplit("/", 1)[-1] for c in compiles] == SOURCES
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
