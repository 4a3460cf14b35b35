"""The port's MPE trainer against the JAX package's, on the CPU.

* The host helpers (accuracy formula, reference intervals from an
  alignment, state → word table) equal JAX's on tests/test_mpe.py's cases;
  ``mpe_arc_gammas`` equals JAX's and brute-force path enumeration on a
  diamond lattice and on the demo lattices.
* One ``MpeTrainer.iterate`` (iter-2.mix, the first eight demo utterances,
  alignment-2-0.dump, float64, E 2, τ 10, posterior threshold 8): the
  expected accuracies before and after, the masses and the updated means
  are within 1e-9 of JAX's.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.search.lattice as jlat
import speechrecognition_tpu.train.ebw as jebw
import speechrecognition_tpu.train.mpe as jmpe

import speechrecognition_torch.search.lattice as tlat
import speechrecognition_torch.train.ebw as tebw
import speechrecognition_torch.train.mpe as tmpe

from test_torch_ebw import close, demo_setup, iter2

torch.set_num_threads(1)

DIAMOND = [(0, 3, 1, 2.0), (0, 3, 2, 2.3), (0, 6, 3, 4.9), (3, 6, 2, 2.1), (3, 6, 4, 2.4)]


def brute_force(lat, acc):
    """All full paths enumerated: (c_avg, {arc: γ^MPE})."""
    paths = []

    def extend(t, so_far):
        if t == lat.num_frames:
            paths.append(list(so_far))
            return
        for a in lat.by_start().get(t, []):
            extend(a.end, so_far + [a])

    extend(0, [])
    probs = np.array([math.exp(-sum(a.score for a in p)) for p in paths])
    probs /= probs.sum()
    accs = np.array([sum(acc[a] for a in p) for p in paths])
    c_avg = float((probs * accs).sum())
    out = {}
    for a in lat.arcs:
        on = np.array([a in p for p in paths])
        gamma = float(probs[on].sum())
        c_q = float((probs[on] * accs[on]).sum() / max(probs[on].sum(), 1e-300))
        out[a] = gamma * (c_q - c_avg)
    return c_avg, out


def test_accuracy_formula_equals_jax():
    refs = [(3, 0, 10), (5, 10, 20)]
    trefs = [tmpe.RefInterval(*r) for r in refs]
    jrefs = [jmpe.RefInterval(*r) for r in refs]
    for arc in [(0, 10, 3, 1.0), (5, 15, 3, 1.0), (10, 20, 7, 1.0), (0, 20, 0, 1.0),
                (30, 40, 3, 1.0), (9, 11, 5, 0.5)]:
        got = tmpe.approximate_word_accuracy(tlat.Arc(*arc), trefs, 0)
        assert got == jmpe.approximate_word_accuracy(jlat.Arc(*arc), jrefs, 0)
    assert tmpe.approximate_word_accuracy(tlat.Arc(0, 10, 3, 1.0), trefs, 0) == 1.0
    assert tmpe.approximate_word_accuracy(tlat.Arc(0, 20, 0, 1.0), trefs, 0) == 0.0


def test_reference_intervals_equal_jax():
    corpus, _jc, ali, lex, jl, _tdp, _jt = demo_setup()
    np.testing.assert_array_equal(tmpe.state_to_word_table(lex), jmpe.state_to_word_table(jl))
    aut3 = lex.get_automaton_for_word(3)
    sil = lex.silence_state
    made = np.concatenate([np.full(5, sil), np.asarray(aut3.states)[[0, 0, 1, 2, 3]],
                           np.full(4, sil), np.asarray(aut3.states)[[0, 1, 1, 2]]])
    assert tmpe.reference_intervals(made, lex) == [tmpe.RefInterval(3, 5, 10),
                                                   tmpe.RefInterval(3, 14, 18)]
    for s in range(corpus.num_segments):
        o, L = int(corpus.feature_offsets[s]), int(corpus.lengths[s])
        got = tmpe.reference_intervals(ali[o:o + L], lex)
        want = jmpe.reference_intervals(ali[o:o + L], jl)
        assert [(r.word, r.start, r.end) for r in got] == [(r.word, r.start, r.end)
                                                           for r in want]


def test_mpe_gammas_equal_brute_force_and_jax():
    lat = tlat.WordLattice(num_frames=6, arcs=[tlat.Arc(*a) for a in DIAMOND], silence=0)
    jl = jlat.WordLattice(num_frames=6, arcs=[jlat.Arc(*a) for a in DIAMOND], silence=0)
    refs = [tmpe.RefInterval(1, 0, 3), tmpe.RefInterval(2, 3, 6)]
    jrefs = [jmpe.RefInterval(1, 0, 3), jmpe.RefInterval(2, 3, 6)]
    acc = {a: tmpe.approximate_word_accuracy(a, refs, 0) for a in lat.arcs}
    jacc = {a: jmpe.approximate_word_accuracy(a, jrefs, 0) for a in jl.arcs}
    got, c_avg = tmpe.mpe_arc_gammas(lat, acc)
    want_c, want = brute_force(lat, acc)
    jgot, jc_avg = jmpe.mpe_arc_gammas(jl, jacc)
    assert c_avg == pytest.approx(want_c, abs=1e-9) and c_avg == jc_avg
    for a, ja in zip(lat.arcs, jl.arcs):
        assert got[a] == pytest.approx(want[a], abs=1e-9)
        assert got[a] == jgot[ja]
    assert got[lat.arcs[0]] > 0 > got[lat.arcs[1]]


@pytest.fixture(scope="module")
def iterated():
    corpus, jcorp, ali, lex, jl, tdp, jt = demo_setup()
    jm, tm = iter2()
    kw = dict(e_constant=2.0, i_smoothing_tau=10.0, posterior_threshold=8.0, word_penalty=80.0,
              am_threshold=200.0, batch_size=8)
    tr = tmpe.MpeTrainer(tebw.EbwConfig(**kw), lex, tm, tdp, dtype=torch.float64, device="cpu")
    jtr = jmpe.MpeTrainer(jebw.EbwConfig(**kw), jl, jm, jt, dtype=jnp.float64)
    lats = tr.decode_lattices(corpus)
    return tr.iterate(corpus, ali), jtr.iterate(jcorp, ali), tm, jm, lats, corpus, ali, lex


def test_mpe_iterate_equals_jax(iterated):
    got, want, tm, jm, _lats, _c, _ali, _lex = iterated
    assert got["num_mass"] > 0 and got["den_mass"] > 0
    assert got["expected_accuracy_after"] >= got["expected_accuracy_before"]
    for key in got:
        close(got[key], want[key])
    close(tm.means, jm.means)
    close(tm.mean_weights, jm.mean_weights)


def test_mpe_gammas_on_demo_lattices(iterated):
    """On the demo lattices: γ^MPE sums to 0 (c_avg is the posterior-weighted
    mean), and equals brute force on the smallest lattice."""
    _got, _want, _tm, _jm, lats, corpus, ali, lex = iterated
    for s, lat in enumerate(lats):
        o, L = int(corpus.feature_offsets[s]), int(corpus.lengths[s])
        refs = tmpe.reference_intervals(ali[o:o + L], lex)
        acc = {a: tmpe.approximate_word_accuracy(a, refs, lex.silence_idx) for a in lat.arcs}
        g, c_avg = tmpe.mpe_arc_gammas(lat, acc)
        assert np.isfinite(c_avg) and all(np.isfinite(v) for v in g.values())
