"""The port's fsa/ (speechrecognition_torch/fsa) against the JAX package's,
on the same inputs.

One case for each test of tests/test_fsa.py, test_fsa_lazy.py and
test_fsa_tail.py: the case calls the operations the test calls, keeps the
test's own checks, and returns what the operations gave; ``run_both``
(tests/torch_flf_tables.py) runs it with each package and holds the two
results bit-equal: every automaton's states, arcs (source, target, input,
output, weight) and final weights, every path and score, the files written.
Random automata come from ``np.random.default_rng(seed)``.
"""

import itertools

import numpy as np
import pytest

from torch_flf_tables import FSA_MODULES, outcome, random_arcs, random_automaton, run_both

MODULES = FSA_MODULES + ("search.lattice",)


def enumerate_paths(P, a, max_len: int = 8):
    """Brute force: the best weight of each accepted input sequence."""
    best = {}
    stack = [(a.initial, (), 0.0)]
    while stack:
        s, labs, w = stack.pop()
        if np.isfinite(a.final[s]):
            t = w + float(a.final[s])
            if labs not in best or t < best[labs]:
                best[labs] = t
        if len(labs) >= max_len:
            continue
        for i in range(a.num_arcs):
            if a.src[i] == s:
                lab = int(a.ilabel[i])
                nl = labs if lab == P.EPS else labs + (lab,)
                stack.append((int(a.dst[i]), nl, w + float(a.weight[i])))
    return best


def same_language(pa, pb):
    assert set(pa) == set(pb)
    for k in pa:
        assert pa[k] == pytest.approx(pb[k])


# -- tests/test_fsa.py ---------------------------------------------------------

def linear_acceptor_and_best(P, root):
    a = P.linear_acceptor([3, 1, 2], [0.5, 0.25, 0.125])
    il, ol, w = P.best_path(a)
    assert il == [3, 1, 2] and ol == [3, 1, 2] and w == pytest.approx(0.875)
    return a, (il, ol, w), a.accepts([3, 1, 2]), a.accepts([3, 1])


def union_concat_closure(P, root):
    a = P.linear_acceptor([1], [1.0])
    b = P.linear_acceptor([2], [2.0])
    u, c, k = P.union(a, b), P.concat(a, b), P.closure(a)
    pk = enumerate_paths(P, k, max_len=4)
    assert pk[(1, 1, 1)] == pytest.approx(3.0)
    return u, c, k, enumerate_paths(P, u), enumerate_paths(P, c), pk


def compose_acceptors_intersect(P, root):
    a = P.Automaton.build(3, [(0, 1, 1, 0.5), (0, 1, 2, 0.25), (1, 2, 3, 0.0)], {2: 0.0})
    c = P.compose(a, P.linear_acceptor([2, 3], [1.0, 1.0]))
    assert enumerate_paths(P, c) == {(2, 3): pytest.approx(2.25)}
    return c


def compose_transducer_relabels(P, root):
    t1 = P.Automaton.build(2, [(0, 1, 1, 10, 0.5)], {1: 0.0})
    t2 = P.Automaton.build(2, [(0, 1, 10, 77, 0.25)], {1: 0.0})
    c = P.compose(t1, t2)
    assert P.best_path(c)[:2] == ([1], [77])
    return c, P.best_path(c)


def compose_random_transducers(P, root):
    out = []
    for seed in range(6):
        a = random_automaton(P, seed, eps=True, transducer=True)
        b = random_automaton(P, 50 + seed, eps=True)
        out.append(P.compose(a, b))
    return out


def remove_epsilons_preserves_language(P, root):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(10):
        a = P.Automaton.build(5, random_arcs(rng, eps=True), {4: 0.0})
        b = P.remove_epsilons(a)
        assert not ((b.ilabel == P.EPS) & (b.olabel == P.EPS)).any()
        same_language(enumerate_paths(P, a), enumerate_paths(P, b))
        out.append(b)
    return out


def determinize_preserves_weights(P, root):
    rng = np.random.default_rng(11)
    out = []
    for trial in range(10):
        a = P.Automaton.build(5, random_arcs(rng, eps=trial % 2 == 0), {4: 0.0})
        d = P.determinize(a)
        assert P.is_deterministic(d)
        same_language(enumerate_paths(P, a), enumerate_paths(P, d))
        out.append(d)
    return out


def minimize_preserves_and_shrinks(P, root):
    a = P.Automaton.build(
        5, [(0, 1, 1, 1.0), (0, 2, 1, 1.0), (1, 3, 2, 0.5), (2, 4, 2, 0.5)], {3: 0.0, 4: 0.0})
    m = P.minimize(a)
    assert m.num_states < P.connect(a).num_states
    out = [P.connect(a), m]
    rng = np.random.default_rng(13)
    for _ in range(8):
        a = P.Automaton.build(5, random_arcs(rng), {4: 0.0})
        m = P.minimize(a)
        same_language(enumerate_paths(P, a), enumerate_paths(P, m))
        out.append(m)
    return out


def push_preserves_total_weights(P, root):
    out = []
    for seed in (3, 4, 5):
        a = P.Automaton.build(5, random_arcs(np.random.default_rng(seed)), {4: 0.0})
        p = P.push(a)
        pa, pp = enumerate_paths(P, a), enumerate_paths(P, p)
        for k in pa:
            assert pa[k] == pytest.approx(pp[k])
        out.append(p)
    return out


def shortest_distance_semirings(P, root):
    a = P.Automaton.build(2, [(0, 1, 1, 1.0), (0, 1, 2, 2.0)], {1: 0.0})
    d = P.shortest_distance(a, semiring=P.LogSemiring)
    assert d[1] == pytest.approx(-np.log(np.exp(-1.0) + np.exp(-2.0)))
    r = random_automaton(P, 21, num_arcs=14)
    return (d, P.shortest_distance(a, semiring=P.TropicalSemiring),
            P.shortest_distance(r, semiring=P.LogSemiring),
            P.shortest_distance(r, reverse=True))


def n_best(P, root):
    a = P.Automaton.build(3, [(0, 1, 1, 1.0), (0, 1, 2, 2.0), (1, 2, 3, 0.0),
                              (1, 2, 4, 0.5)], {2: 0.0})
    nb = P.n_best(a, 3)
    assert [labs for labs, _w in nb] == [[1, 3], [1, 4], [2, 3]]
    return nb, P.n_best(random_automaton(P, 8, num_arcs=14), 5)


def prune_keeps_best(P, root):
    a = P.Automaton.build(3, [(0, 1, 1, 0.0), (0, 1, 2, 5.0), (1, 2, 3, 0.0)], {2: 0.0})
    p, p2 = P.prune(a, 1.0), P.prune(a, 10.0)
    assert set(enumerate_paths(P, p)) == {(1, 3)}
    return p, p2, P.prune(random_automaton(P, 9, num_arcs=14), 1.5)


def reverse_project_invert(P, root):
    t = P.Automaton.build(3, [(0, 1, 1, 9, 0.5), (1, 2, 2, 8, 0.25)], {2: 0.125})
    r, pi, iv = P.reverse(t), P.project(t, "output"), P.invert(t)
    assert P.best_path(r)[0] == [2, 1] and P.best_path(iv)[:2] == ([9, 8], [1, 2])
    return r, pi, iv, P.best_path(r), P.best_path(pi), P.best_path(iv)


def io_roundtrip(P, root):
    a = P.Automaton.build(5, random_arcs(np.random.default_rng(5)), {4: 0.0})
    P.write_fsa(str(root / "a.fsa"), a)
    b = P.read_fsa(str(root / "a.fsa"))
    np.testing.assert_array_equal(a.src, b.src)
    return b


def draw_dot(P, root):
    dot = P.draw(P.linear_acceptor([1, 2], [0.5, 0.5]), symbols={1: "eins", 2: "zwei"})
    assert dot.startswith("digraph") and "eins" in dot
    return dot, P.draw(random_automaton(P, 4, eps=True, transducer=True))


def from_word_lattice_best_matches(P, root):
    arcs = [P.Arc(0, 3, 5, 1.0), P.Arc(0, 3, 6, 2.0), P.Arc(3, 7, 5, 0.5), P.Arc(3, 7, 7, 0.25)]
    lat = P.WordLattice(num_frames=7, arcs=arcs, silence=0)
    fsa = P.from_word_lattice(lat)
    il, _, w = P.best_path(fsa)
    words, score = lat.best_path()
    assert w == pytest.approx(score) and il == words
    return fsa, P.best_path(fsa)


# -- tests/test_fsa_lazy.py ----------------------------------------------------

def lazy_random_acceptor(P, seed):
    """tests/test_fsa_lazy.py's random acceptor (cycles allowed)."""
    rng = np.random.default_rng(seed)
    arcs = [(int(rng.integers(6)), int(rng.integers(6)), int(rng.integers(3)),
             float(rng.random())) for _ in range(12)]
    return P.connect(P.Automaton.build(6, arcs, {5: float(rng.random())}, 0))


def lazy_random_acyclic(P, seed):
    """tests/test_fsa_lazy.py's random acyclic acceptor."""
    rng = np.random.default_rng(seed)
    arcs = []
    for _ in range(16):
        s = int(rng.integers(7))
        arcs.append((s, int(rng.integers(s + 1, 8)), int(rng.integers(3)), float(rng.random())))
    return P.connect(P.Automaton.build(8, arcs, {7: float(rng.random())}, 0))


def lazy_static_matches_eager(P, root):
    out = []
    for seed in range(10):
        a = lazy_random_acceptor(P, seed)
        if a.num_states == 0:
            continue
        m = P.materialize(P.LazyStatic(a))
        assert m.num_arcs == P.connect(a).num_arcs
        out.append((m, P.best_path_lazy(P.LazyStatic(a)), P.best_path(a)))
    return out


def lazy_compose_matches_eager(P, root):
    out = []
    for seed in range(20):
        a, b = lazy_random_acceptor(P, 100 + seed), lazy_random_acceptor(P, 200 + seed)
        if a.num_states == 0 or b.num_states == 0:
            continue
        e = P.connect(P.compose(a, b))
        m = outcome(lambda: P.connect(P.materialize(P.lazy_compose(P.LazyStatic(a),
                                                                   P.LazyStatic(b)))))
        out.append((e, m))
    return out


def lazy_determinize_matches_eager(P, root):
    out = []
    for seed in range(10):
        a = lazy_random_acyclic(P, 300 + seed)
        if a.num_states == 0:
            continue
        e = P.determinize(a)
        m = P.materialize(P.lazy_determinize(P.LazyStatic(a)))
        assert P.is_deterministic(m) and m.num_states == e.num_states
        out.append((e, m, P.best_path(m)))
    return out


def lazy_determinize_avoids_blowup(P, root):
    n = 18
    arcs = [(0, 0, 0, 2.0), (0, 0, 1, 2.0), (0, 1, 0, 2.0)]
    for i in range(1, n):
        arcs += [(i, i + 1, 0, 2.0), (i, i + 1, 1, 2.0)]
    arcs.append((0, n + 1, 2, 1.0))
    a = P.Automaton.build(n + 2, arcs, {n: 0.0, n + 1: 0.0}, 0)
    guard = outcome(P.determinize, a, max_states=2000)
    assert isinstance(guard, RuntimeError)
    lz = P.lazy_determinize(P.LazyStatic(a))
    labels, score = P.best_path_lazy(lz, max_expansions=5000)
    assert labels == [2] and lz.num_materialized <= 4
    return guard, labels, score, lz.num_materialized


def alphabet_and_archive_roundtrip(P, root):
    alpha = P.Alphabet(["[sil]", "eins", "zwei"])
    assert alpha.index("eins") == 1 and alpha.add(P.Alphabet.EPS_SYMBOL) == P.EPS
    a = lazy_random_acceptor(P, 7)
    arch = P.FsaArchive(str(root / "fsas"), alpha)
    arch.write("g/one", a)
    back = P.FsaArchive.open(str(root / "fsas")).read("g/one")
    P.write_fsa_text(str(root / "a.txt"), a, alpha)
    text = P.read_fsa_text(str(root / "a.txt"), alpha)
    alpha.save(str(root / "alpha"))
    return (alpha.symbols(), alpha.symbol(P.EPS), arch.list(), back, text,
            P.Alphabet.load(str(root / "alpha")).symbols())


# -- tests/test_fsa_tail.py ----------------------------------------------------

def probability_semiring(P, root):
    sr = P.ProbabilitySemiring
    return sr.plus(0.25, 0.5), sr.times(0.25, 0.5), sr.sum([0.1, 0.2, 0.3]), sr.zero, sr.one


def count_semiring_saturates(P, root):
    sr = P.CountSemiring
    assert sr.times(70000, 70000) == sr.INF
    return (sr.plus(2, 3), sr.times(2, 3), sr.plus(sr.INF - 1, 5), sr.times(70000, 70000),
            sr.times(sr.INF, 0))


def integer_semirings(P, root):
    T, L = P.TropicalIntegerSemiring, P.LogIntegerSemiring
    a = L.plus(10, 10)
    assert isinstance(a, int) and a < 10
    return (T.plus(4, 7), T.times(4, 7), T.times(2 ** 31 - 2, 5), a, L.plus(L.zero, 42),
            [L.plus(x, y) for x in (0, 3, 100) for y in (1, 7, 2 ** 20)])


def semiring_registry(P, root):
    assert P.get_semiring("probability") is P.ProbabilitySemiring
    names = ["tropical", "log", "probability", "count", "tropical-integer", "log-integer",
             "nope"]
    return [outcome(P.get_semiring, n) for n in names]


def levenshtein_distance_and_info(P, root):
    g = P.levenshtein(P.linear_acceptor([1, 2, 3, 4]), P.linear_acceptor([1, 5, 4]))
    info = P.levenshtein_info(g)
    assert info["total"] == 2 and info["sub"] == 1 and info["del"] == 1
    return g, P.best_path(g), info


def levenshtein_matches_bruteforce(P, root):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(10):
        a = rng.randint(1, 4, rng.randint(1, 6)).tolist()
        b = rng.randint(1, 4, rng.randint(1, 6)).tolist()
        g = P.levenshtein(P.linear_acceptor(a), P.linear_acceptor(b))
        D = np.zeros((len(a) + 1, len(b) + 1))
        D[:, 0], D[0, :] = np.arange(len(a) + 1), np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            for j in range(1, len(b) + 1):
                D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                              D[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
        assert P.best_path(g)[2] == pytest.approx(D[len(a), len(b)])
        out.append((g, P.levenshtein_info(g)))
    return out


def levenshtein_custom_costs(P, root):
    g = P.levenshtein(P.linear_acceptor([1]), P.linear_acceptor([2]),
                      sub_cost=10.0, del_cost=3.0, ins_cost=4.0)
    assert P.best_path(g)[2] == pytest.approx(7.0)
    return g, P.best_path(g)


def extend_collect_multiply(P, root):
    a = P.linear_acceptor([1, 2], weights=[1.5, 2.5])
    e = P.extend(a, 1.0)
    assert np.allclose(P.collect(e, 3.0).weight, [2.5, 3.0])
    r = random_automaton(P, 31)
    return (e, P.collect(e, 3.0), P.multiply(a, 2.0), P.extend(r, 0.7), P.collect(r, 1.1),
            P.multiply(r, 0.3))


def expm_logm_roundtrip(P, root):
    a = P.linear_acceptor([1, 2], weights=[1.5, 2.5])
    r = random_automaton(P, 32)
    return P.expm(a), P.logm(P.expm(a)), P.expm(r), P.logm(P.expm(r))


def extend_final_only_touches_finals(P, root):
    a = P.linear_acceptor([1, 2], weights=[1.5, 2.5])
    f = P.extend_final(a, 5.0)
    assert f.final[2] == a.final[2] + 5.0
    return f, P.extend_final(random_automaton(P, 33), 0.25)


def sort_arcs_by_type(P, root):
    a = P.Automaton.build(3, [(0, 1, 3, 0.5), (0, 1, 1, 0.2), (0, 2, 2, 0.1), (1, 2, 9, 0.0)],
                          {2: 0.0})
    assert P.sort_arcs(a, "by-input").ilabel[:3].tolist() == [1, 2, 3]
    r = random_automaton(P, 34, num_arcs=16, transducer=True)
    kinds = ["by-input", "by-output", "by-weight", "by-input-and-output",
             "by-input-and-output-and-target", "bogus"]
    return [outcome(P.sort_arcs, x, k) for x in (a, r) for k in kinds]


def accepted_strings(a, max_len=6):
    out_idx, res = a.out_index(), set()

    def dfs(s, acc):
        if np.isfinite(a.final[s]):
            res.add(tuple(acc))
        if len(acc) < max_len:
            for i in out_idx[s]:
                dfs(int(a.dst[i]), acc + [int(a.ilabel[i])])

    dfs(a.initial, [])
    return res


def permute_full_window(P, root):
    p = P.permute(P.linear_acceptor([1, 2, 3]))
    assert accepted_strings(p) == set(itertools.permutations([1, 2, 3]))
    return p


def permute_window_limits_reordering(P, root):
    p = P.permute(P.linear_acceptor([1, 2, 3, 4]), window_size=2)
    got = accepted_strings(p, max_len=4)
    assert (2, 1, 3, 4) in got and (4, 1, 2, 3) not in got
    return p, sorted(got)


def permute_rejects_nonlinear(P, root):
    a = P.Automaton.build(2, [(0, 1, 1, 0.0), (0, 1, 2, 0.0)], {1: 0.0})
    e = outcome(P.permute, a)
    assert isinstance(e, ValueError)
    return e


def random_path_is_accepting_path(P, root):
    a = P.Automaton.build(3, [(0, 1, 1, 0.5), (0, 1, 2, 0.1), (1, 2, 3, 0.0)], {2: 0.0})
    paths = [P.random_path(a, seed=seed) for seed in range(5)]
    assert all(p.ilabel.tolist() in ([1, 3], [2, 3]) for p in paths)
    return paths


def random_path_weighted_prefers_cheap_arcs(P, root):
    a = P.Automaton.build(3, [(0, 1, 1, 20.0), (0, 1, 2, 0.0), (1, 2, 3, 0.0)], {2: 0.0})
    picks = [int(P.random_path(a, weight=1.0, seed=s).ilabel[0]) for s in range(20)]
    assert picks.count(2) >= 18
    return picks


def random_path_maximum_size(P, root):
    a = P.Automaton.build(1, [(0, 0, 1, 0.0)], {0: 0.0})
    p = P.random_path(a, maximum_size=5, seed=0)
    assert p.num_arcs <= 5
    return p


def random_path_same_seed_same_path(P, root):
    """One seed draws one path in both packages (np.random.RandomState)."""
    a = random_automaton(P, 35, num_states=6, num_arcs=18)
    return [P.random_path(a, weight=w, seed=s) for s in range(10) for w in (0.0, 0.5, 1.0)]


CASES = [
    linear_acceptor_and_best, union_concat_closure, compose_acceptors_intersect,
    compose_transducer_relabels, compose_random_transducers,
    remove_epsilons_preserves_language, determinize_preserves_weights,
    minimize_preserves_and_shrinks, push_preserves_total_weights, shortest_distance_semirings,
    n_best, prune_keeps_best, reverse_project_invert, io_roundtrip, draw_dot,
    from_word_lattice_best_matches,
    lazy_static_matches_eager, lazy_compose_matches_eager, lazy_determinize_matches_eager,
    lazy_determinize_avoids_blowup, alphabet_and_archive_roundtrip,
    probability_semiring, count_semiring_saturates, integer_semirings, semiring_registry,
    levenshtein_distance_and_info, levenshtein_matches_bruteforce, levenshtein_custom_costs,
    extend_collect_multiply, expm_logm_roundtrip, extend_final_only_touches_finals,
    sort_arcs_by_type, permute_full_window, permute_window_limits_reordering,
    permute_rejects_nonlinear, random_path_is_accepting_path,
    random_path_weighted_prefers_cheap_arcs, random_path_maximum_size,
    random_path_same_seed_same_path,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_fsa_matches_jax(case, tmp_path):
    run_both(case, tmp_path, MODULES)


@pytest.mark.parametrize("seed", range(6))
def test_random_automaton_ops_match_jax(seed, tmp_path):
    """Every operation of fsa/ops.py and fsa/tail.py on one seeded random
    automaton (with epsilons and output labels)."""
    def case(P, root):
        a = random_automaton(P, 400 + seed, num_states=6, num_arcs=14, eps=True,
                             transducer=True)
        acc = random_automaton(P, 500 + seed, num_states=6, num_arcs=12)
        return [a, P.connect(a), P.remove_epsilons(a), P.reverse(a), P.invert(a),
                P.project(a, "input"), P.project(a, "output"), P.closure(acc),
                P.union(a, acc), P.concat(a, acc), P.compose(a, acc),
                outcome(P.determinize, acc), P.push(acc), outcome(P.minimize, acc),
                outcome(P.best_path, a), P.n_best(acc, 4), P.prune(acc, 2.0),
                P.shortest_distance(a), P.shortest_distance(acc, semiring=P.LogSemiring),
                P.is_deterministic(acc), outcome(P.levenshtein, acc, a), P.sort_arcs(a, "by-weight"),
                P.random_path(a, seed=seed), P.draw(acc)]
    run_both(case, tmp_path, MODULES)
