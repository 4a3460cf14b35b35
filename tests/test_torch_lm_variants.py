"""The port's lm/ngram.py, lm/variants.py and sprint/bliss.py against the JAX
package's, on the same inputs.

One case for each test of tests/test_lm_variants.py (Zerogram, FsaLM,
ClassMapping, ClassLM), held bit-equal by ``run_both``
(tests/torch_flf_tables.py); the count LM (``Vocabulary``, ``CountLM``) on
the demo transcripts and on a seeded text corpus; and the Bliss readers on a
small lexicon and corpus. The port's ``CountLM(order=2)`` rebuilds
tests/fixtures/demo_bigram_lm.json exactly (``demo_bigram_lm``), the LM that
the search tier's tests and chip_smoke.py read.
"""

import math

import numpy as np
import pytest

from torch_flf_tables import FIXTURES, LM_MODULES, outcome, run_both

# -- tests/test_lm_variants.py -------------------------------------------------


def zerogram_uniform(P, root):
    lm = P.Zerogram(12)
    tab = lm.score_table([[0], [1]], [0, 1, 2])
    assert lm.score(3) == pytest.approx(math.log(12)) and tab.shape == (2, 3)
    return lm.score(3), tab, P.Zerogram(1).score(0)


def grammar(P):
    return P.Automaton.build(4, [(0, 1, 0, 0.5), (0, 3, P.EPS, 1.0), (3, 2, 2, 2.0),
                                 (1, 2, 1, 0.25)], final={2: 0.125})


def fsa_lm_direct_and_epsilon_paths(P, root):
    lm = P.FsaLM(grammar(P))
    h = lm.start_history()
    h1 = lm.extended_history(h, 0)
    h2 = lm.extended_history(h1, 1)
    bad = lm.extended_history(h, 1)
    assert lm.score(2, h) == pytest.approx(3.0) and bad == P.INVALID_HISTORY
    return (h, [lm.score(w, h) for w in range(3)], h1, lm.score(1, h1), h2,
            lm.sentence_end_score(h2), bad, lm.score(0, bad), lm.extended_history(bad, 0),
            [lm.sentence_score(s) for s in ([0, 1], [2], [1], [], [0, 1, 2])],
            lm.score_table([0, 1], [0, 1, 2]))


def write_classes(root, text):
    path = str(root / "classes")
    with open(path, "w") as f:
        f.write(text)
    return path


def class_mapping_load_normalize(P, root):
    path = write_classes(root, "# comment line\none DIGIT 3\ntwo DIGIT 1\n"
                               "; another comment\nhello GREET\n")
    m = P.ClassMapping.load(path, ["one", "two", "hello", "stray"])
    assert m.emission[0] == pytest.approx(-math.log(0.75))
    assert m.classes[int(m.class_of[3])] == "stray"
    return m


def class_lm_combines_emission_and_class_score(P, root):
    path = write_classes(root, "one DIGIT 1\ntwo DIGIT 1\nhello GREET\n")
    m = P.ClassMapping.load(path, ["one", "two", "hello"])
    lm = P.ClassLM(m, P.Zerogram(len(m.classes)), emission_scale=2.0)
    expect = 2.0 * (-math.log(0.5)) + math.log(len(m.classes))
    assert lm.score(0, [2]) == pytest.approx(expect)
    return m, lm.score(0, [2]), lm.score_table([[2], [0]], [0, 1, 2])


def class_lm_over_fsa_lm(P, root):
    """A class LM whose class model is an FSA grammar over the classes."""
    path = write_classes(root, "a C0 2\nb C0 1\nc C1\nd C2 5\ne C2 5\n")
    m = P.ClassMapping.load(path, ["a", "b", "c", "d", "e"])
    lm = P.ClassLM(m, P.FsaLM(grammar(P)), emission_scale=0.5)
    return [lm.score(w, [0]) for w in range(5)], lm.score_table([[0], [1], [2], [3]], range(5))


LM_CASES = [zerogram_uniform, fsa_lm_direct_and_epsilon_paths, class_mapping_load_normalize,
            class_lm_combines_emission_and_class_score, class_lm_over_fsa_lm]


@pytest.mark.parametrize("case", LM_CASES, ids=[c.__name__ for c in LM_CASES])
def test_lm_variant_matches_jax(case, tmp_path):
    run_both(case, tmp_path, LM_MODULES)


@pytest.mark.parametrize("seed", range(4))
def test_fsa_lm_on_random_grammar_matches_jax(seed, tmp_path):
    """FsaLM on a seeded grammar with epsilon arcs (forward only: an epsilon
    cycle loops for ever, as in the reference): every score, extended
    history and sentence score of a few random sentences."""
    def case(P, root):
        rng = np.random.default_rng(seed)
        arcs = []
        for _ in range(16):
            s = int(rng.integers(5))
            w = float(np.round(rng.random() * 3, 3))
            if rng.random() < 0.2:
                arcs.append((s, int(rng.integers(s + 1, 6)), -1, w))
            else:
                arcs.append((s, int(rng.integers(6)), int(rng.integers(4)), w))
        lm = P.FsaLM(P.Automaton.build(6, arcs, {5: 0.5, 2: 1.25}))
        sents = [rng.integers(4, size=rng.integers(0, 5)).tolist() for _ in range(6)]
        hists = list(range(6)) + [P.INVALID_HISTORY]
        return ([[outcome(lm.score, w, h) for w in range(4)] for h in hists],
                [[outcome(lm.extended_history, h, w) for w in range(4)] for h in hists],
                [outcome(lm.sentence_score, s) for s in sents],
                outcome(lm.score_table, hists, range(4)))
    run_both(case, tmp_path, LM_MODULES)


# -- the count LM (lm/ngram.py) ------------------------------------------------

def demo_orths_text():
    """The demo transcripts, as words (tests/fixtures/demo_corpus.json)."""
    import json
    with open(FIXTURES / "demo_corpus.json") as f:
        return [s["orth"].split() for s in json.load(f)["segments"]]


def demo_bigram_lm(which):
    """tests/test_wcts.py's demo bigram LM (CountLM(order=2) on the demo
    transcripts, scale 8, silence free) built with one package's lexicon and
    CountLM."""
    import importlib
    root = {"jax": "speechrecognition_tpu", "port": "speechrecognition_torch"}[which]
    lexicon = importlib.import_module(f"{root}.lexicon").build_sietill_lexicon()
    ngram = importlib.import_module(f"{root}.lm.ngram")
    desc = importlib.import_module(f"{root}.corpus").CorpusDescription.read(
        str(FIXTURES / "demo_corpus.json"), lexicon)
    lm_model = ngram.CountLM(order=2)
    for seg in desc.segments:
        lm_model.add_sentence([lexicon.orth[w] for w in seg.orth], grow_vocab=True)
    lm_model.estimate_discounts()
    W, sil, scale = lexicon.num_words, lexicon.silence_idx, 8.0
    ids = [lm_model.vocabulary.index(lexicon.orth[w]) for w in range(W)]
    lm = np.zeros((W, W))
    for v in range(W):
        for w in range(W):
            if v != sil and w != sil:
                lm[v, w] = scale * lm_model.score(ids[w], [ids[v]])
    lm[:, sil] = 0.0
    lm_start = np.zeros(W)
    for w in range(W):
        if w != sil:
            lm_start[w] = scale * lm_model.score(ids[w], [lm_model.vocabulary.start])
            lm[sil, w] = scale * lm_model.score(ids[w], [])
    return lm, lm_start


def test_port_count_lm_rebuilds_the_demo_bigram_lm():
    import json
    with open(FIXTURES / "demo_bigram_lm.json") as f:
        d = json.load(f)
    lm, lm_start = demo_bigram_lm("port")
    assert np.array_equal(lm, np.asarray(d["lm"])) and lm.shape == (12, 12)
    assert np.array_equal(lm_start, np.asarray(d["lm_start"]))
    want_lm, want_start = demo_bigram_lm("jax")
    assert lm.tobytes() == want_lm.tobytes() and lm_start.tobytes() == want_start.tobytes()


@pytest.mark.parametrize("order", [1, 2, 3])
def test_count_lm_matches_jax(order, tmp_path):
    """Vocabulary and CountLM on the demo transcripts and a seeded corpus
    file: vocabulary, discounts, probabilities, score matrices, perplexity
    and OOV rate (an error the reference code raises, such as the log of a
    zero probability, is compared as an outcome)."""
    def case(P, root):
        rng = np.random.default_rng(order)
        words = ["eins", "zwei", "drei", "vier", "fuenf", "sechs"]
        train = root / "train.txt"
        train.write_text("\n".join(" ".join(rng.choice(words, rng.integers(1, 8)))
                                   for _ in range(40)) + "\n")
        test = root / "test.txt"
        test.write_text("eins zwei sieben\ndrei drei\n\nacht eins\n")
        vocab_file = root / "vocab.txt"
        vocab_file.write_text("\n".join(words[:4]) + "\n")
        lm = P.CountLM(order=order)
        for s in demo_orths_text():
            lm.add_sentence(s, grow_vocab=True)
        lm.train(str(train))
        lm.estimate_discounts()
        fixed = P.CountLM(order=order, vocabulary=P.Vocabulary(str(vocab_file)))
        fixed.train(str(train), grow_vocab=False)
        fixed.estimate_discounts()
        V = lm.vocabulary
        hists = [[], [V.start], [V.index("eins")], [V.index("zwei"), V.index("drei")],
                 [V.unk]]
        return (V.size(), [V.symbol(i) for i in range(V.size())], V.start, V.end, V.unk,
                lm.discounts, [[outcome(lm.prob, w, h) for w in range(V.size())] for h in hists],
                [[outcome(lm.score, w, h) for w in range(V.size())] for h in hists],
                outcome(lm.score_matrix, hists, list(range(V.size()))),
                outcome(lm.perplexity, str(test)), lm.oov_rate, fixed.vocabulary.size(),
                fixed.discounts, outcome(fixed.perplexity, str(test)), fixed.oov_rate)
    run_both(case, tmp_path, LM_MODULES)


# -- sprint/bliss.py -----------------------------------------------------------

BLISS_LEXICON = """<?xml version="1.0" encoding="utf-8"?>
<lexicon>
  <phoneme-inventory>
    <phoneme><symbol>si</symbol></phoneme>
    <phoneme><symbol>ai</symbol></phoneme>
    <phoneme><symbol>n</symbol></phoneme>
    <phoneme><symbol>s</symbol></phoneme>
    <phoneme><symbol>ts</symbol></phoneme>
    <phoneme><symbol>v</symbol></phoneme>
  </phoneme-inventory>
  <lemma special="silence"><orth>[silence]</orth><phon>si</phon></lemma>
  <lemma><orth>eins</orth><orth>EINS</orth><phon>ai n s</phon><phon>ai n</phon></lemma>
  <lemma><orth>zwei</orth><phon>ts v ai</phon></lemma>
  <lemma special="unknown"><orth>[unknown]</orth></lemma>
</lexicon>
"""

BLISS_CORPUS = """<?xml version="1.0" encoding="utf-8"?>
<corpus name="toy">
  <recording name="rec1" audio="rec1.wav">
    <segment name="1" start="0.0" end="1.5"><orth>eins zwei</orth></segment>
    <segment name="2" start="1.5"><orth> zwei </orth></segment>
  </recording>
  <recording name="rec2" audio="rec2.wav">
    <segment name="a"><orth></orth></segment>
  </recording>
</corpus>
"""


@pytest.mark.parametrize("gz", [False, True])
def test_bliss_readers_match_jax(gz, tmp_path):
    def case(P, root):
        import gzip
        opener, suffix = (gzip.open, ".gz") if gz else (open, "")
        paths = []
        for name, text in (("lexicon.xml", BLISS_LEXICON), ("corpus.xml", BLISS_CORPUS)):
            paths.append(str(root / (name + suffix)))
            with opener(paths[-1], "wt") as f:
                f.write(text)
        lex, corpus = P.BlissLexicon.read(paths[0]), P.BlissCorpus.read(paths[1])
        assert lex.lemma_of("EINS").pronunciations == [["ai", "n", "s"], ["ai", "n"]]
        return (lex, lex.silence_lemma, lex.num_phonemes, lex.lemma_of("zwei"),
                lex.lemma_of("drei"), corpus,
                [corpus.full_segment_name(s) for s in corpus.segments])
    run_both(case, tmp_path, ("sprint.bliss",))
