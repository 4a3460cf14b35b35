"""The port's native corpus loader (speechrecognition_torch/native/): its
features and offsets are bit-equal to the pure-Python path and to the JAX
package's native loader on the demo corpus, it builds under build/native/
at the repository root (never into the JAX package), and a failed build, a
bad normalization or an unreadable file raises instead of falling back."""

from pathlib import Path

import numpy as np
import pytest

import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.lexicon as jlex
from speechrecognition_tpu.native.loader import native_available

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.lexicon as tlex
from speechrecognition_torch.native import loader

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


def read(pkg_corpus, pkg_front, lexicon, desc=None, normalized=True, **kw):
    desc = desc or pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    norm = str(FIX / "normalization-demo.bin") if normalized else None
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(), normalization_path=norm, **kw)


def assert_same(a, b):
    np.testing.assert_array_equal(a.feature_offsets, b.feature_offsets)
    assert a.features.dtype == b.features.dtype == np.float32
    np.testing.assert_array_equal(a.features.view(np.int32), b.features.view(np.int32))


@pytest.mark.parametrize("normalized", [True, False])
def test_native_equals_the_python_path(normalized):
    lex = tlex.build_sietill_lexicon()
    nat = read(tcorpus, tfront, lex, normalized=normalized)
    py = read(tcorpus, tfront, lex, normalized=normalized, use_native=False)
    assert nat.num_segments == 35
    assert_same(nat, py)


@pytest.mark.parametrize("normalized", [True, False])
def test_native_equals_the_jax_native_loader(normalized):
    if not native_available():      # the reference package's own build
        pytest.skip("the JAX package's native loader does not build here")
    nat = read(tcorpus, tfront, tlex.build_sietill_lexicon(), normalized=normalized)
    ref = read(jcorpus, jfront, jlex.build_sietill_lexicon(), normalized=normalized,
               use_native=True)
    assert_same(nat, ref)


def test_library_lands_under_build():
    lib = loader.library_path()
    loader.load()
    assert lib.exists()
    assert lib.parent == REPO / "build" / "native"
    assert not list((REPO / "speechrecognition_torch").rglob("*.so"))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "corpus_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SRC", broken)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        read(tcorpus, tfront, tlex.build_sietill_lexicon())
    assert not list((tmp_path / "build").glob("*.so*"))
    monkeypatch.setattr(loader, "CXX_FLAGS", ("-O2",))
    monkeypatch.setenv("PATH", str(tmp_path))          # no g++ on the path
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        loader.load()


def test_a_missing_file_raises():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    desc.segments[3].name = "no-such-segment"
    with pytest.raises((RuntimeError, FileNotFoundError)):
        read(tcorpus, tfront, lex, desc=desc)


def test_a_bad_normalization_raises():
    with pytest.raises(ValueError, match="normalization"):
        loader.load_corpus_native([str(FIX / "demo_features" / "ac_fu_dr.08.mm2")], np.zeros(3),
                                  np.ones(3), 12, 12, 1, 3, True)
