"""The port's lattice functions (search/flf.py, flf_rescore.py,
flf_closure.py, flf_compose.py, flf_cn.py and the posterior algorithms of
flf_network.py) against the JAX package's, on the same lattices.

One case for each lattice-function test of tests/test_flf.py,
test_flf_network.py and test_flf_nodes_r5.py, keeping the test's own checks;
then every function on lattices built by ``WordLattice.from_books`` from
seeded word-end books (``torch_flf_tables.random_books``). ``run_both`` holds
the two packages' results bit-equal, the files they wrote too (SLF, lattice,
CN and fCN archives). The network configs, the node census and the
recognizer node are tests/test_torch_flf_network.py.
"""

import io
import math

import numpy as np
import pytest

from torch_flf_tables import FLF_MODULES, books_lattice, outcome, run_both

MODULES = FLF_MODULES + ("fsa.automaton",)
VOCAB = ["[sil]", "eins", "zwei", "drei", "vier"]

TOY_ARPA = """
\\data\\
ngram 1=7
ngram 2=2
ngram 3=1

\\1-grams:
-0.8\t<s>\t-0.3
-0.9\t</s>
-0.7\teins\t-0.2
-0.8\tzwei\t-0.2
-0.9\tdrei\t-0.1
-1.0\tvier\t-0.1
-2.0\t<unk>

\\2-grams:
-0.3\teins zwei\t-0.1
-0.4\t<s> eins\t-0.1

\\3-grams:
-0.2\teins zwei vier

\\end\\
"""


def both(case, tmp_path):
    return run_both(case, tmp_path, MODULES)


def toy(P):
    """tests/test_flf.py's lattice: two competing middle words."""
    return P.WordLattice(num_frames=10, arcs=[P.Arc(0, 4, 1, 1.0), P.Arc(4, 8, 2, 0.5),
                                              P.Arc(4, 8, 3, 0.9), P.Arc(8, 10, 4, 0.2)],
                         silence=0)


def toy5(P):
    """test_flf_network.py's and test_flf_nodes_r5.py's lattice."""
    return P.WordLattice(num_frames=6, arcs=[P.Arc(0, 3, 1, 1.0), P.Arc(0, 3, 3, 3.0),
                                             P.Arc(3, 6, 2, 1.0), P.Arc(3, 6, 0, 4.0),
                                             P.Arc(0, 6, 0, 9.0)], silence=0)


def linear(P, words, score=0.0):
    return P.WordLattice(num_frames=len(words),
                         arcs=[P.Arc(i, i + 1, w, score) for i, w in enumerate(words)], silence=0)


def silence_heavy(P):
    A = P.Arc
    return P.WordLattice(num_frames=6, arcs=[A(0, 1, 0, 0.5), A(0, 1, 0, 1.5), A(1, 3, 1, 1.0),
                                             A(1, 3, 3, 1.2), A(3, 4, 0, 0.3), A(3, 4, 0, 0.1),
                                             A(4, 6, 2, 1.0), A(3, 6, 2, 2.0)], silence=0)


# -- tests/test_flf.py -----------------------------------------------------------

def slf_roundtrip(P, root):
    lat = toy(P)
    P.write_slf(str(root / "l.slf"), lat, VOCAB, utterance="utt1")
    back = P.read_slf(str(root / "l.slf"), VOCAB)
    assert back.best_path()[0] == lat.best_path()[0]
    return back, back.best_path()


def slf_gzip(P, root):
    P.write_slf(str(root / "l.slf.gz"), toy(P), VOCAB)
    return P.read_slf(str(root / "l.slf.gz"), VOCAB)


def lattice_archive(P, root):
    arch = P.LatticeArchive(str(root / "arch"), VOCAB)
    arch.write("corpus/rec1/utt1", toy(P))
    arch.write("corpus/rec1/utt2", toy(P))
    assert arch.list() == ["corpus/rec1/utt1", "corpus/rec1/utt2"]
    return arch.list(), arch.read("corpus/rec1/utt1"), arch.read("corpus/rec1/utt2", silence=2)


def confusion_network_posteriors(P, root):
    slots = P.confusion_network(toy(P))
    expect = math.exp(-0.5) / (math.exp(-0.5) + math.exp(-0.9))
    assert slots[1].probs[2] == pytest.approx(expect, abs=1e-6)
    return slots, P.cn_decode(slots), P.confusion_network(toy(P), silence_as_eps=False)


def cn_epsilon_slot(P, root):
    lat = P.WordLattice(num_frames=10, arcs=[P.Arc(0, 4, 1, 0.1), P.Arc(4, 8, 2, 1.2),
                                             P.Arc(4, 8, 0, 0.1), P.Arc(8, 10, 3, 0.1)],
                        silence=0)
    slots = P.confusion_network(lat)
    mid = [s for s in slots if 2 in s.probs][0]
    assert mid.eps_prob() > mid.probs[2] and P.cn_decode(slots) == [1, 3]
    return slots, [(s.center, s.eps_prob(), s.best()) for s in slots]


def system_combination_majority_vote(P, root):
    def cn(words):
        return [P.CnSlot(start=4 * k, end=4 * k + 4, probs={w: p})
                for k, (w, p) in enumerate(words)]
    systems = [cn([(1, 0.9), (2, 0.6), (4, 0.8)]), cn([(1, 0.8), (3, 0.7), (4, 0.9)]),
               cn([(1, 0.7), (3, 0.8), (4, 0.6)])]
    comb = P.combine_confusion_networks(systems)
    assert P.cn_decode(comb) == [1, 3, 4]
    return comb, P.combine_confusion_networks(systems, weights=[3.0, 1.0, 0.5])


def push_lattice_preserves_path_scores(P, root):
    pushed = P.push_lattice(toy(P))
    assert pushed.best_path()[0] == toy(P).best_path()[0]
    return pushed, pushed.best_path()


def compose_linear_transcript(P, root):
    lat = toy(P)
    lat2 = P.WordLattice(num_frames=10, arcs=lat.arcs + [P.Arc(8, 9, 0, 0.05),
                                                          P.Arc(9, 10, 4, 0.1)], silence=0)
    out = [P.compose_linear(lat, [1, 3, 4]), P.compose_linear(lat, [1, 1, 4]),
           P.compose_linear(lat2, [1, 2, 4])]
    assert [p[2] for p in out[2][1]] == [1, 2, 0, 4] and math.isinf(out[1][0])
    return out


def context_lattice_archive(P, root):
    arcs = [P.CArc(start=0, pred=5, end=4, word=1, am=1.0, lm=0.2),
            P.CArc(start=4, pred=1, end=8, word=2, am=0.5, lm=0.1),
            P.CArc(start=4, pred=1, end=8, word=3, am=0.4, lm=0.9)]
    lat = P.ContextLattice(num_frames=8, num_contexts=6, arcs=arcs, silence=0)
    arch = P.LatticeArchive(str(root / "ctx"), VOCAB, context=True)
    arch.write("utt/1", lat)
    back = arch.read("utt/1")
    assert back.best_words() == lat.best_words()
    P.write_slf_context(str(root / "c.slf"), lat, VOCAB, utterance="u")
    return back, back.best_words(), P.read_slf_context(str(root / "c.slf"), VOCAB)


def union_merges_paths(P, root):
    a, b = toy(P), P.WordLattice(num_frames=10, arcs=[P.Arc(0, 4, 1, 0.8), P.Arc(4, 10, 4, 0.3)],
                                 silence=0)
    u = P.union_lattices([a, b])
    merged = next(x for x in u.arcs if (x.start, x.end, x.word) == (0, 4, 1))
    assert merged.score < 0.8
    return u, u.best_path()


def trim_and_mesh_drop_dead_arcs(P, root):
    lat = P.WordLattice(num_frames=10, arcs=[P.Arc(0, 4, 1, 1.0), P.Arc(4, 10, 2, 0.5),
                                             P.Arc(5, 7, 3, 0.1)], silence=0)
    t, m = P.trim_lattice(lat), P.mesh_lattice(lat)
    assert {(a.start, a.end) for a in t.arcs} == {(0, 4), (4, 10)}
    return t, m


def determinize_minimize_lattice(P, root):
    det, mini = P.determinize_lattice(toy(P)), P.minimize_lattice(toy(P))
    assert mini.num_states <= det.num_states
    return det, mini


def pivot_confusion_network(P, root):
    slots = P.pivot_confusion_network(toy(P), silence_as_eps=False)
    assert P.cn_decode(slots) == [1, 2, 4]
    return slots, P.pivot_confusion_network(toy5(P))


def rescore_arpa_matches_brute_force(P, root):
    (root / "toy.arpa").write_text(TOY_ARPA)
    lm = P.ArpaLM(str(root / "toy.arpa"))
    W = len(VOCAB)
    arcs = [P.CArc(0, W, 4, 1, am=10.0, lm=0.0), P.CArc(4, 1, 8, 2, am=9.0, lm=0.0),
            P.CArc(4, 1, 8, 3, am=8.5, lm=0.0), P.CArc(8, 2, 10, 4, am=3.0, lm=0.0),
            P.CArc(8, 3, 10, 4, am=3.0, lm=0.0)]
    clat = P.ContextLattice(num_frames=10, num_contexts=W + 1, arcs=arcs, silence=0)
    return P.rescore_arpa(clat, lm, VOCAB, scale=5.0), P.rescore_arpa(clat, lm, VOCAB, 0.5, 0)


# -- the posterior algorithms (tests/test_flf_network.py) -------------------------

def fwdbwd_posteriors_normalized(P, root):
    post = P.fwdbwd_posteriors(toy5(P))
    pcn = P.frame_posterior_cn(toy5(P), post)
    assert all(sum(pcn[t].values()) <= 1.0 + 1e-9 for t in range(6))
    return post, pcn


def arc_confidence_matches_frame_average(P, root):
    return P.arc_confidence(toy5(P)), P.arc_confidence(toy(P))


def local_cost_decode(P, root):
    lat = P.WordLattice(num_frames=4, arcs=[P.Arc(0, 4, 1, 2.0), P.Arc(0, 2, 2, 1.0),
                                            P.Arc(2, 4, 3, 1.5), P.Arc(2, 4, 4, 1.6),
                                            P.Arc(2, 4, 5, 1.7)], silence=0)
    assert P.local_cost_decode(lat)[0] == [2, 3]
    return (P.local_cost_decode(toy5(P)), P.local_cost_decode(lat),
            P.local_cost_decode(lat, word_penalty=2.0, silence_free=False))


def gamma_correction(P, root):
    slots = [P.CnSlot(start=0, end=2, probs={1: 0.6, 2: 0.4})]
    pcn = P.frame_posterior_cn(toy5(P))
    return ([P.gamma_correction_func(x, g) for x, g in ((0.1, 2.0), (0.3, 2.0), (0.5, 3.0),
                                                        (0.9, 0.5), (1.2, 2.0), (1e-30, 4.0))],
            P.gamma_correct_cn(slots, gamma=3.0), P.gamma_correct_cn(slots, 0.5, normalize=False),
            P.gamma_correct_fcn(pcn, 2.0), P.gamma_correct_fcn(pcn, 2.0, normalize=False))


# -- compose, closure, rescore and CN families (tests/test_flf_nodes_r5.py) -------

def compose_family(P, root):
    lat = toy5(P)
    c = P.compose_lattices(lat, linear(P, [1, 2]))
    assert [w for w in c.best_path()[0] if w > 0] == [1, 2]
    d = P.difference_lattices(lat, linear(P, [1, 2]))
    assert [w for w in d.best_path()[0] if w > 0] == [3, 2]
    return (c, c.best_path(), P.intersect_lattices(lat, linear(P, [3, 2])), d,
            P.compose_lattices(lat, linear(P, [3, 0]), unweighted_left=True))


def compose_with_fsa_rescoring(P, root):
    fsa = P.Automaton.build(1, [(0, 0, w, (10.0 if w == 3 else 0.0)) for w in range(5)],
                            {0: 0.0})
    r = P.compose_with_fsa(toy5(P), fsa, scale=0.5)
    assert all(a.score == pytest.approx(8.0) for a in r.arcs if a.word == 3)
    return r, r.best_path()


def compose_with_lm_matches_manual_scores(P, root):
    (root / "toy.lm").write_text(TOY_ARPA)
    lm = P.ArpaLM(str(root / "toy.lm"))
    r = P.compose_with_lm(toy5(P), lm, VOCAB, scale=2.0)
    assert [w for w in r.best_path()[0] if w > 0] == [1, 2]
    return r, r.best_path()


def remove_epsilons_and_fit(P, root):
    lat = P.WordLattice(num_frames=5, arcs=[P.Arc(0, 2, 1, 1.0), P.Arc(2, 3, -1, 0.5),
                                            P.Arc(3, 5, 2, 1.0), P.Arc(2, 5, 2, 2.0)], silence=0)
    r = P.remove_epsilon_arcs(lat)
    assert all(a.word != -1 for a in r.arcs)
    short = P.WordLattice(num_frames=6, arcs=[P.Arc(0, 3, 1, 1.0), P.Arc(3, 4, 2, 1.0)],
                          silence=0)
    f = P.fit_lattice(short)
    assert any(a.word == -1 and a.end == 6 for a in f.arcs)
    return r, f, P.fit_lattice(short, end_time=8)


def closure_family(P, root):
    lat = silence_heavy(P)
    chain = P.WordLattice(num_frames=6, arcs=[P.Arc(0, 2, 1, 1.0), P.Arc(2, 3, 0, 0.5),
                                              P.Arc(3, 4, 0, 0.25), P.Arc(4, 6, 2, 1.0)],
                          silence=0)
    out = [P.nonword_closure_filter(lat, level=lv) for lv in ("arc", "weak", "strong")]
    for f in out:
        assert f.best_path() == lat.best_path()
    return (out, P.nonword_closure_normalization(chain), P.nonword_closure_removal(lat),
            P.nonword_closure_filter(lat, nonwords=[3], level="weak"))


def score_dimensions(P, root):
    lat = toy5(P)
    ml = P.append_lattices(lat, lat)
    red = P.reduce_scores(ml)
    assert red.view().best_path() == ml.view().best_path()
    e = P.exp_score(lat, scale=-1.0)
    cs = P.change_semiring(ml, {"am": 0.5, "am-2": 0.0})
    return (ml, ml.keys, red, P.multiply_score(P.add_score(lat, 1.0), 2.0), e,
            P.log_score(e, scale=-1.0), cs, cs.view(), P.project_semiring(cs, ["am"]),
            outcome(P.append_lattices, toy5(P), linear(P, [1, 2])),
            P.extend_by_penalty(lat, 5.0, class_penalties={3: 1.0}).view(),
            P.extend_by_pronunciation_score(lat, {1: 0.7, 2: 1.1}, scale=2.0).view(),
            P.MultiLattice.promote(lat).keys)


def cn_and_fcn_archives(P, root):
    slots, pcn = P.confusion_network(toy5(P)), P.frame_posterior_cn(toy5(P))
    cns, fcns = P.CnArchive(str(root / "cns")), P.FcnArchive(str(root / "fcns"))
    cns.write("s1", slots)
    fcns.write("s1", pcn)
    out = io.StringIO()
    P.dump_cn(slots, VOCAB, out, seg_id="s1")
    P.dump_fcn(pcn, VOCAB, out, seg_id="s1")
    return cns.read("s1"), cns.list(), fcns.read("s1"), fcns.list(), out.getvalue()


def cn_pruning_and_combination(P, root):
    slots = [P.CnSlot(0, 2, {1: 0.6, 2: 0.25, 3: 0.1})]
    f1, f2 = [{1: 0.8, 2: 0.2}], [{1: 0.2, 2: 0.6}]
    return (P.prune_cn(slots, threshold=0.8), P.prune_cn(slots, max_slot_size=1, normalize=True),
            P.prune_cn([P.CnSlot(0, 2, {1: 0.1})], remove_eps_slots=0.8),
            P.prune_fcn([{1: 0.5, 2: 0.3, 3: 0.1}], max_slot_size=2),
            P.prune_fcn([{1: 0.5, 2: 0.3, 3: 0.1}], threshold=0.6, normalize=True),
            P.fcn_combination([f1, f2]), P.fcn_combination([f1, f2], max_approx=True),
            P.fcn_combination([f1, f2], weights=[3, 1]),
            P.concatenate_fcns([[{1: 1.0}], [{2: 1.0}, {3: 0.5}]]),
            P.cn_to_lattice(slots))


def oracle_alignment_costs(P, root):
    slots = [P.CnSlot(0, 2, {1: 0.7, 3: 0.3}), P.CnSlot(2, 4, {2: 0.9})]
    assert P.oracle_align_cn(slots, [1, 2]) == ([(0, 1), (1, 2)], 0.0)
    return (P.oracle_align_cn(slots, [4, 2]), P.oracle_align_cn(slots, [1, 2], cost="oracle-loss"),
            P.oracle_align_cn(slots, [3, 2], cost="weighted-oracle-error", alpha=2.0))


def cn_and_fcn_features(P, root):
    lat = toy5(P)
    slots, pcn = P.confusion_network(lat), P.frame_posterior_cn(lat)
    return ([P.cn_features(lat, slots, feature=f) for f in ("confidence", "entropy", "slot")],
            P.cn_features(lat, slots, feature="cost", oracle=[1, 2]),
            [P.fcn_features(lat, pcn, feature=f) for f in ("confidence", "error")],
            P.fcn_features(lat, pcn, feature="error", alpha=0.0))


def fwer_and_aligner(P, root):
    hyp = P.WordLattice(num_frames=6, arcs=[P.Arc(0, 3, 1, 0), P.Arc(3, 6, 2, 0)], silence=0)
    ref = P.WordLattice(num_frames=6, arcs=[P.Arc(0, 3, 1, 0), P.Arc(3, 6, 0, 0)], silence=0)
    pcn = P.frame_posterior_cn(toy5(P))
    assert P.fwer(hyp, ref=ref) == (3.0, 6)
    return (P.fwer(hyp, ref_fcn=pcn), P.fwer(hyp, ref_fcn=pcn, alpha=0.5),
            P.align_hypothesis([1, 2], toy5(P)), P.align_hypothesis([1, 4], toy5(P)),
            P.align_hypothesis([3, 0], toy5(P), intersection=False),
            P.state_cluster_cn(toy5(P)), P.state_cluster_cn(toy(P), silence_as_eps=False))


CASES = [
    slf_roundtrip, lattice_archive, confusion_network_posteriors, cn_epsilon_slot,
    system_combination_majority_vote, push_lattice_preserves_path_scores,
    compose_linear_transcript, context_lattice_archive, union_merges_paths,
    trim_and_mesh_drop_dead_arcs, determinize_minimize_lattice, pivot_confusion_network,
    rescore_arpa_matches_brute_force,
    fwdbwd_posteriors_normalized, arc_confidence_matches_frame_average, local_cost_decode,
    gamma_correction,
    compose_family, compose_with_fsa_rescoring, compose_with_lm_matches_manual_scores,
    remove_epsilons_and_fit, closure_family, score_dimensions, cn_and_fcn_archives,
    cn_pruning_and_combination, oracle_alignment_costs, cn_and_fcn_features, fwer_and_aligner,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_flf_function_matches_jax(case, tmp_path):
    both(case, tmp_path)


def test_slf_gzip_matches_jax(tmp_path):
    both(slf_gzip, tmp_path)


@pytest.mark.parametrize("seed", range(8))
def test_flf_functions_on_seeded_books_match_jax(seed, tmp_path):
    """Every lattice function on a lattice from seeded word-end books (and a
    second one for the binary operations)."""
    def case(P, root):
        lat = books_lattice(P, seed)
        other = books_lattice(P, 100 + seed)
        words = lat.best_path()[0]
        slots, pcn = P.confusion_network(lat), P.frame_posterior_cn(lat)
        P.write_slf(str(root / "l.slf"), lat, VOCAB + ["fuenf"], utterance=str(seed))
        arch = P.LatticeArchive(str(root / "arch"), VOCAB + ["fuenf"])
        arch.write(f"s/{seed}", lat)
        calls = [
            (lat.best_path,), (lat.n_best, 5), (lat.forward_backward,),
            (P.read_slf, str(root / "l.slf"), VOCAB + ["fuenf"]), (arch.read, f"s/{seed}"),
            (P.push_lattice, lat), (P.compose_linear, lat, words),
            (P.compose_linear, lat, [w for w in words if w != 0]),
            (P.union_lattices, [lat, other]), (P.trim_lattice, lat), (P.mesh_lattice, lat),
            (P.determinize_lattice, lat), (P.minimize_lattice, lat), (P.cn_decode, slots),
            (P.pivot_confusion_network, lat), (P.combine_confusion_networks,
                                               [slots, P.confusion_network(other)]),
            (P.fwdbwd_posteriors, lat), (P.arc_confidence, lat), (P.local_cost_decode, lat, 0.5),
            (P.gamma_correct_cn, slots, 2.0), (P.gamma_correct_fcn, pcn, 0.5),
            (P.nonword_closure_filter, lat), (P.nonword_closure_filter, lat, None, "weak"),
            (P.nonword_closure_filter, lat, None, "strong"),
            (P.nonword_closure_normalization, lat), (P.nonword_closure_removal, lat),
            (P.compose_lattices, lat, other), (P.compose_lattices, lat, linear(P, words)),
            (P.difference_lattices, lat, linear(P, words)), (P.remove_epsilon_arcs, lat),
            (P.fit_lattice, lat), (P.append_lattices, lat, lat),
            (P.extend_by_penalty, lat, 2.5), (P.exp_score, lat, -1.0),
            (P.prune_cn, slots, 0.9), (P.prune_fcn, pcn, None, 2, True),
            (P.fcn_combination, [pcn, P.frame_posterior_cn(other)]),
            (P.oracle_align_cn, slots, [w for w in words if w != 0]),
            (P.cn_features, lat, slots, "entropy"), (P.fcn_features, lat, pcn, "error"),
            (P.fwer, lat, other), (P.align_hypothesis, [w for w in words if w != 0], lat),
            (P.state_cluster_cn, lat), (P.cn_to_lattice, slots),
        ]
        return lat, slots, pcn, [outcome(*c) for c in calls]
    both(case, tmp_path)
