"""Seeded inputs of the LVCSR tier's 1-best path (the linear-lexicon scan,
kernel M; its traceback, kernel N; the int8 quantized scorer, kernel O):
lexica with tied states, the AN4 config's transition model, bigram LMs and
ARPA files, utterances and features near the model's means.

Shared by tests/test_torch_linear_lvcsr.py, test_torch_quantized.py,
test_torch_cuda.py and chip_smoke.py (which loads this file by path).
Imports numpy and the port only.
"""

import numpy as np

from speechrecognition_torch.io import RawMixtureSet
from speechrecognition_torch.lexicon import Lexicon, MarkovAutomaton
from speechrecognition_torch.models.gmm import MixtureModel, VarianceModel
from speechrecognition_torch.sprint.am import StateTypeTdp, TransitionModel

INF = float("inf")

#: the AN4 recognition config's [*.acoustic-model.tdp] block as
#: bench/an4/RESULTS.md records it: loop 3 / forward 0 / skip 3 / exit 150;
#: silence 0.0001 / 3 / infinity / 15; entry-m1 loop infinity
AN4_TDP_CONFIG = """\
[*.acoustic-model.tdp]
scale = 1.0
*.loop = 3.0
*.forward = 0.0
*.skip = 3.0
*.exit = 150.0
silence.loop = 0.0001
silence.forward = 3.0
silence.skip = infinity
silence.exit = 15.0
entry-m1.loop = infinity
"""

#: TransitionModel.from_config of AN4_TDP_CONFIG
AN4_TDP = TransitionModel(
    default=StateTypeTdp(3.0, 0.0, 3.0, 150.0),
    silence=StateTypeTdp(0.0001, 3.0, INF, 15.0),
    entry_m1=StateTypeTdp(INF, 0.0, 3.0, 150.0),
    entry_m2=StateTypeTdp(3.0, 0.0, 3.0, 150.0),
    scale=1.0,
    phone1=StateTypeTdp(3.0, 0.0, 3.0, 150.0))

#: the tuned operating point of bench/an4/RESULTS.md
AN4_TUNED = {"lm_scale": 6.0, "word_exit": 30.0, "sil_exit": 10.0}

#: the AN4 test corpus: 130 utterances, 35,570 frames (355.7 s)
AN4_UTTERANCES = 130
AN4_FRAMES = 35570


def tied_lexicon(lengths, sil_positions, num_classes, rng, own_silence=False) -> Lexicon:
    """Silence (word 0, ``sil_positions`` states) and one real word a length
    in ``lengths`` (positions), every state drawn from ``num_classes``
    tied classes, as an LVCSR lexicon's CART-tied automata. With
    ``own_silence`` the silence's classes are drawn first and no real word
    uses them, as a CART tree gives silence leaves of its own (then the
    prefix tree shares no node between silence and a word)."""
    lex = Lexicon()
    lex.orth.append("[SILENCE]")
    sil = rng.integers(0, num_classes, sil_positions).astype(np.int32)
    lex.automata.append(MarkovAutomaton(states=sil))
    lex.silence = 0
    classes = np.setdiff1d(np.arange(num_classes), sil) if own_silence else np.arange(num_classes)
    for i, n in enumerate(lengths):
        lex.orth.append(f"W{i:03d}")
        lex.automata.append(MarkovAutomaton(
            states=classes[rng.integers(0, len(classes), int(n))].astype(np.int32)))
    return lex


def an4_lexicon(seed: int = 0, num_classes: int = 501) -> Lexicon:
    """AN4's shape: 130 real words of whole phones (3 states each), 3 to 30
    positions with a mean of about 10, plus a 3-state silence with classes
    of its own."""
    rng = np.random.default_rng(seed)
    phones = np.clip(1 + rng.poisson(2.3, 130), 1, 10)
    phones[0], phones[1] = 10, 1
    return tied_lexicon(3 * phones, 3, num_classes, rng, own_silence=True)


def random_lm(rng, W: int, silence_idx: int, sil_exit: float, low=1.0, high=8.0,
              integer=False):
    """Boundary matrices as build_lm_matrices shapes them: lm [W, W] and
    lm_start [W] of random costs, the silence row unused (0), the silence
    column and start entry the silence exit."""
    draw = (lambda *s: rng.integers(int(low), int(high) + 1, s).astype(np.float64)) \
        if integer else (lambda *s: rng.uniform(low, high, s))
    lm, lm_start = draw(W, W), draw(W)
    lm[silence_idx] = 0.0
    lm[:, silence_idx] = sil_exit
    lm_start[silence_idx] = sil_exit
    return lm, lm_start


def arpa_text(words, seed: int = 0, bigram_share: float = 0.3) -> str:
    """A seeded bigram ARPA LM over ``words`` plus <s>, </s> and <unk>:
    every unigram with a back-off weight, and a random share of the
    bigrams (the rest back off)."""
    rng = np.random.default_rng(seed)
    vocab = ["<s>", "</s>", "<unk>"] + list(words)
    uni = rng.uniform(-4.0, -1.0, len(vocab))
    uni[0] = -99.0
    bows = rng.uniform(-1.0, 0.0, len(vocab))
    hist = ["<s>"] + list(words)
    pairs = [(h, w) for h in hist for w in list(words) + ["</s>"]
             if rng.uniform() < bigram_share]
    lines = ["\\data\\", f"ngram 1={len(vocab)}", f"ngram 2={len(pairs)}", "",
             "\\1-grams:"]
    lines += [f"{uni[i]:.6f} {w} {bows[i]:.6f}" for i, w in enumerate(vocab)]
    lines += ["", "\\2-grams:"]
    lines += [f"{rng.uniform(-3.0, -0.05):.6f} {h} {w}" for h, w in pairs]
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def utterance_lengths(rng, B: int, total: int, low: int = 80, high: int = 480) -> np.ndarray:
    """B lengths within [low, high] (nearly) that sum to ``total``."""
    lens = rng.integers(low, high + 1, B).astype(np.float64)
    lens = np.maximum(np.round(lens * total / lens.sum()), 1).astype(np.int64)
    lens[np.argmax(lens)] += total - lens.sum()
    return lens.astype(np.int32)


def utterance_states(rng, lex: Lexicon, length: int, max_dur: int = 3):
    """(a frame's state for ``length`` frames, the words spoken): silence,
    seeded words (silence is word 0) with seeded durations (1 to max_dur
    frames a position) and optional silences between them, cut to
    ``length``."""
    out, words = [], []
    sil = lex.get_silence_automaton().states
    W = lex.num_words

    def emit(states):
        for s in states:
            out.extend([int(s)] * int(rng.integers(1, max_dur + 1)))

    emit(sil)
    while len(out) < length:
        words.append(int(rng.integers(1, W)))
        emit(lex.get_automaton_for_word(words[-1]).states)
        if rng.uniform() < 0.3:
            emit(sil)
    return np.asarray(out[:length], np.int32), words


def features_near_means(rng, model: MixtureModel, states: np.ndarray) -> np.ndarray:
    """A frame for each state: one of its mixture's densities' mean (any
    density's for a mixture without one) plus half a pooled standard
    deviation of noise, float32. As tests/test_quantized.py's draw, NaN
    (an inactive density's mean) becomes 0: a front end gives finite
    features. NaN frames are tested on their own."""
    var = np.asarray(model.vars[0], np.float64)

    def mean_of(s):
        mix = model.mixtures[int(s)]
        if not mix:
            return int(rng.integers(model.means.shape[0]))
        return mix[int(rng.integers(len(mix)))][0]

    choice = np.asarray([mean_of(s) for s in states], np.int64)
    x = model.means[choice] + rng.standard_normal((len(states), model.dim)) * np.sqrt(var) * 0.5
    return np.nan_to_num(x).astype(np.float32)


def pooled_raw(rng, S: int, D: int, dim: int, empty_share: float = 0.0,
               palette: int = 0) -> RawMixtureSet:
    """A seeded globally pooled mixture set: S mixtures of 1 to D
    densities, one shared variance; ``empty_share`` of the densities get no
    count (inactive after finalisation); with ``palette`` every mean is one
    of that many vectors (duplicate means, hence duplicate k-means
    centers and tied cluster distances)."""
    sizes = rng.integers(1, D + 1, S)
    J = int(sizes.sum())
    counts = rng.uniform(5.0, 50.0, J)
    counts[rng.uniform(size=J) < empty_share] = 0.0
    means = rng.normal(0.0, 2.0, (J, dim))
    if palette:
        means = rng.normal(0.0, 2.0, (palette, dim))[rng.integers(0, palette, J)]
    mean_acc = means * counts[:, None]
    var = rng.uniform(0.5, 2.0, dim)
    total = counts.sum()
    var_acc = ((var[None, :] + means ** 2) * counts[:, None]).sum(0, keepdims=True)
    densities = np.stack([np.arange(J), np.zeros(J, np.int64)], axis=1).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    mixtures = [np.arange(bounds[s], bounds[s + 1], dtype=np.int64) for s in range(S)]
    return RawMixtureSet(dim=dim, mean_acc=mean_acc, mean_weight=counts, var_acc=var_acc,
                         var_weight=np.asarray([total]), densities=densities,
                         mixtures=mixtures)


def pooled_model(raw: RawMixtureSet) -> MixtureModel:
    return MixtureModel.from_raw(raw, VarianceModel.GLOBAL_POOLING, max_approx=True)


#: integer TDPs that force ties in the recursions and entries
TIE_TDP = TransitionModel(default=StateTypeTdp(1.0, 0.0, 1.0, 0.0),
                          silence=StateTypeTdp(0.0, 1.0, 2.0, 0.0),
                          entry_m1=StateTypeTdp(INF, 0.0, 1.0, 0.0),
                          entry_m2=StateTypeTdp(0.0, 0.0, 0.0, 0.0))

#: the scan's test cases: name → (word lengths, silence positions, classes,
#: B, lengths, T, integer scores, silence exit, threshold, seed)
LINEAR_CASES = {
    "lengths-1-2-3": ([1, 2, 3], 3, 10, 3, [12, 7, 0], 12, False, 15.0, 8.0, 0),
    "silence-1": ([3, 2, 4, 6], 1, 12, 3, [12, 12, 5], 12, False, 15.0, 8.0, 1),
    "silence-2": ([3, 2, 4, 6], 2, 12, 2, [14, 9], 14, False, 15.0, 8.0, 2),
    "ties": ([2, 3, 3, 2, 1], 3, 4, 3, [16, 16, 11], 16, True, 2.0, 6.0, 3),
    "all-silence": ([3, 2], 3, 8, 2, [10, 10], 10, False, 0.1, 1e9, 4),
    "exit-off-float32": ([3, 6, 3, 4], 3, 12, 2, [14, 10], 14, False, 10.1, 9.0, 5),
}


def linear_case(name):
    """(lexicon, TransitionModel, lm, lm_start, am float64 [B, T, S], lens,
    threshold) of a LINEAR_CASES entry; silence is word 0."""
    lengths, ps, S, B, lens, T, integer, sil_exit, thr, seed = LINEAR_CASES[name]
    rng = np.random.default_rng(seed)
    lex = tied_lexicon(lengths, ps, S, rng)
    tm = TIE_TDP if integer else AN4_TDP
    lm, lm_start = random_lm(rng, lex.num_words, 0, sil_exit, integer=integer,
                             low=1.0, high=4.0 if integer else 8.0)
    if integer:
        lm[2] = lm[1]                   # tied predecessors
        am = rng.integers(0, 4, (B, T, S)).astype(np.float64)
    else:
        am = rng.uniform(0.0, 6.0, (B, T, S))
    if name == "all-silence":           # only silence (class 0) is plausible
        lex.automata[0].states[:] = 0
        for a in lex.automata[1:]:
            a.states[:] = np.maximum(a.states, 1)
        am[:] = 30.0
        am[:, :, 0] = 0.0
    return lex, tm, lm, lm_start, am, np.asarray(lens, np.int32), thr


def traceback_books(seed: int, B: int = 4, T: int = 600, W: int = 3, nan=None, ties=(),
                    sil_offset: float = 1.0, signed_zero: bool = False):
    """Random scan outputs with a scan's structure for the traceback alone
    (book, bkp, pred, origin, silend, silorg as float64 / int32 numpy, and
    lens): entry boundaries and silence origins one or two frames back, so that
    a long utterance walks past MAX_TRACE_WORDS words; one utterance ends at
    the sentence start early, one is empty (B >= 3).

    The start of each walk, every utterance's last live row (frame
    max(len, 1) - 1), can be forced:

    * ``nan``: ("book" or "silend", "first", "middle" or "last"), a NaN at
      that index of the word ends or the silence ends (argmin picks the
      first NaN, and the silence test is then false);
    * ``ties``: indices (those inside the row) where both rows take their
      least value (the random values are positive), -2.0 in the word ends
      and -2.0 + ``sil_offset`` in the silence ends (below 0: the silence
      copy wins; 0: equal, the word wins); the first index must win. With
      ``signed_zero`` the word ends' ties are 0.0, the first +0.0 and the
      later ones -0.0, which equal it (the silence ends' likewise when
      ``sil_offset`` is 0).
    """
    rng = np.random.default_rng(seed)
    V = W + 1
    t_idx = np.arange(T)[:, None, None]
    book = rng.uniform(0.0, 50.0, (T, B, W))
    silend = rng.uniform(0.0, 60.0, (T, B, V))
    bkp = np.maximum(t_idx - rng.integers(1, 3, (T, B, W)), 0).astype(np.int32)
    pred = rng.integers(0, W, (T, B, W)).astype(np.int32)
    if B > 1:
        pred[:, 1][rng.uniform(size=(T, W)) < 0.05] = W
    origin = np.maximum(t_idx - rng.integers(0, 2, (T, B, V)), 0).astype(np.int32)
    silorg = np.maximum(t_idx - rng.integers(1, 5, (T, B, V)), 0).astype(np.int32)
    lens = np.asarray(([T, T - 17, 0] + [int(rng.integers(1, T))] * (B - 3))[:B], np.int32)
    last = np.minimum(np.maximum(lens, 1) - 1, T - 1)
    rows = (last, np.arange(B))
    low = 0.0 if signed_zero else -2.0
    for a, n, value in ((book, W, low), (silend, V, low + sil_offset)):
        for k, i in enumerate(i for i in ties if i < n):
            a[rows + (i,)] = -0.0 if k and value == 0.0 else value
    if nan is not None:
        where, which = nan
        a = book if where == "book" else silend
        n = a.shape[2]
        a[rows + ({"first": 0, "middle": n // 2, "last": n - 1}[which],)] = np.nan
    return book, bkp, pred, origin, silend, silorg, lens


#: kernel N's forced starts: name → traceback_books options (NaNs first,
#: in the middle and last; ties across the warp design's lane boundaries,
#: won by the word end, the silence copy or neither; -0.0 against +0.0)
TRACEBACK_STARTS = {
    "random": {},
    **{f"nan-{where}-{which}": {"nan": (where, which)}
       for where in ("book", "silend") for which in ("first", "middle", "last")},
    "ties-0-31-32-63": {"ties": (0, 31, 32, 63)},
    "ties-31-32-63": {"ties": (31, 32, 63)},
    "ties-31-32-63-silence": {"ties": (31, 32, 63), "sil_offset": -1.0},
    "ties-0-31-32-63-equal": {"ties": (0, 31, 32, 63), "sil_offset": 0.0},
    "signed-zero-31-32-63": {"ties": (31, 32, 63), "sil_offset": 0.0, "signed_zero": True},
}
#: the widths kernel N's starts are checked at: one word, a lane's worth
#: and either side of it, the AN4 lexicon's 130 and past 256
TRACEBACK_WIDTHS = (1, 31, 32, 33, 130, 300)


# -- the reference's silence-copy oracle (tests/test_linear_lvcsr.py:27-117) ---

ORACLE_SIL_COST = 2.5


def oracle_case(seed: int, T: int = 14):
    """The oracle's inputs: (base lexicon, its TDPs, lm, lm_start, am
    [1, T, S]; the extended lexicon with one silence copy a context, its
    lm, lm_start and am). The extended lexicon decoded by the bigram
    decoder must give the linear decoder's transcript on the base one."""
    rng = np.random.default_rng(seed)
    base, ext = Lexicon(), Lexicon()
    for lex in (base, ext):
        lex.add_word("[silence]", 1, 1, silence=True)
        lex.add_word("a", 3, 1)
        lex.add_word("b", 2, 1)
    ext.add_word("[sil-a]", 1, 1)
    ext.add_word("[sil-b]", 1, 1)
    lm = rng.uniform(1.0, 8.0, size=(3, 3))
    lm_start = rng.uniform(1.0, 8.0, size=3)
    lm[:, 0] = ORACLE_SIL_COST
    lm_start[0] = ORACLE_SIL_COST
    big = 1e30
    ext_lm, ext_start = np.full((5, 5), big), np.full(5, big)
    for ctx, row in ((0, lm_start), (1, lm[1]), (2, lm[2]), (3, lm[1]), (4, lm[2])):
        ext_lm[ctx, 1], ext_lm[ctx, 2] = row[1], row[2]
    ext_start[1], ext_start[2], ext_start[0] = lm_start[1], lm_start[2], ORACLE_SIL_COST
    for ctx, sil in ((0, 0), (1, 3), (2, 4), (3, 3), (4, 4)):
        ext_lm[ctx, sil] = ORACLE_SIL_COST
    mapping = np.arange(ext.num_states)
    for w, src in ((0, 0), (1, 1), (2, 2), (3, 0), (4, 0)):
        for i, s in enumerate(ext.get_automaton_for_word(w).states):
            mapping[int(s)] = int(base.get_automaton_for_word(src).states[i])
    am = rng.uniform(0.0, 6.0, size=(1, T, base.num_states))
    return base, lm, lm_start, am, ext, ext_lm, ext_start, am[:, :, mapping]
