"""The AN4 LVCSR system: its assembly from the Sprint setup's files, its
features, the self-trained CART-tied GMM, the ARPA bigram boundary matrices
and the 1-best decode with its report — counterpart of ``build_system``,
``load_corpus``, ``train_model``, ``build_lm_matrices`` and ``decode`` in the
repository's tools/an4_system.py.

``build_system`` reads the setup's Bliss lexicon and corpus, CART tree and
Sprint configs and parses its Flow network (the reference's
cache.lda.flow: an MFCC cache, a sliding window and an LDA product); it
takes the files' paths as arguments, where the repository's tool reads
them from the reference's example setup. ``load_corpus`` runs the Flow
network segment by segment into a ``Corpus``. ``train_model`` trains the
tied GMM with the port's EM trainer on the card (``device="cpu"`` for the
CPU), in float64 or double-float (kernels C, E/F, G and H).

``build_lm_matrices`` turns an ARPA LM into the boundary matrices of the
linear-lexicon and word-conditioned tree searches: lm[v, w] = lm_scale ·
(−log p(w|v)) + the exit TDP of word w; silence is transparent (its row is
unused, its column holds only the silence exit). ``decode`` scores a
corpus (the float "mxu" pack, or the int8 quantized scorer for the ``q8``
names) and decodes it with the linear engine (``linear*`` names: kernels M
and N) or the exact or pruned WCTS (kernel K), and reports WER, SER,
S/I/D, RTF and the search-space means.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def log(*a):
    print("[an4]", *a, file=sys.stderr, flush=True)


def build_system(*, config, pruned_config, lexicon, corpus, cart_tree, flow, cache, lda):
    """Assemble the system from the setup's files: the recognition
    ``config`` and its ``pruned_config`` (the acoustic pruning), the Bliss
    ``lexicon`` and ``corpus``, the CART tree ``cart_tree``, and the Flow
    network ``flow`` (the reference's cache.lda.flow) over the MFCC
    ``cache`` and the ``lda`` matrix. Returns (cfg, corpus_xml, asm, lex,
    tm, net, acoustic_pruning, lm_scale)."""
    from ..sprint import BlissCorpus, BlissLexicon, DecisionTree, SprintConfig
    from ..sprint.am import AllophoneStateModel, TransitionModel
    from ..sprint.flow import FlowNetwork

    cfg = SprintConfig.read(config)
    cfg_pruned = SprintConfig.read(pruned_config)

    bliss = BlissLexicon.read(lexicon)
    tree = DecisionTree.read(cart_tree)
    corpus_xml = BlissCorpus.read(corpus)
    asm = AllophoneStateModel(bliss=bliss, tree=tree)
    lex, _orths, _tied = asm.build_search_lexicon()
    tm = TransitionModel.from_config(cfg)

    # Flow features: MFCC cache → sliding window max-size 9 / right 4 → LDA
    # matrix multiplication
    net = FlowNetwork.parse(flow, config={"base-feature-extraction-cache.path": cache,
                                          "lda.file": lda})
    acoustic_pruning = float(cfg_pruned.get("x.acoustic-pruning", "200"))
    lm_scale = float(cfg.get("x.lm.scale", "1"))
    return (cfg, corpus_xml, asm, lex, tm, net, acoustic_pruning, lm_scale)


def load_corpus(corpus_xml, lex, net):
    """Run the Flow network over every segment of the Bliss corpus.
    Returns (Corpus of float32 features, word index sequences)."""
    from ..corpus import Corpus

    feats_list, offsets, word_seqs, names = [], [0], [], []
    ctx = {}
    for seg in corpus_xml.segments:
        key = corpus_xml.full_segment_name(seg)
        f = np.asarray(net.run(params={"id": key}, context=ctx)["features"], np.float32)
        feats_list.append(f)
        offsets.append(offsets[-1] + f.shape[0])
        word_seqs.append([lex.word_idx(w) for w in seg.orth])
        names.append(seg.name)
    return Corpus(features=np.concatenate(feats_list),
                  feature_offsets=np.asarray(offsets, np.int64),
                  orths=word_seqs, names=names,
                  frame_duration=0.01, dim=feats_list[0].shape[1]), word_seqs


def train_model(corpus, lex, asm, out_dir, splits, train_dtype="f64", *, device="cuda"):
    """Train the CART-tied triphone GMM (global pooling, max-approximation)
    from a linear segmentation: ``splits`` splits, 2 realignments and 3
    estimates a split, pruning threshold 300, flat TDPs 3/0/3. train_dtype
    "df32" runs the double-float path (float64 decisions in float32
    arithmetic), "f64" float64. Writes <out_dir>/am.mix; returns (model,
    training seconds)."""
    from ..io import write_mixture_set
    from ..models.gmm import MixtureModel, VarianceModel
    from ..tdp import TdpModel
    from ..train.em import Trainer, TrainerConfig

    if train_dtype not in ("df32", "f64"):
        raise ValueError(f"train_dtype must be 'df32' or 'f64', not {train_dtype!r}")
    model = MixtureModel(dim=corpus.dim, num_mixtures=asm.num_classes,
                         var_model=VarianceModel.GLOBAL_POOLING, max_approx=True)
    tdp = TdpModel(silence_state=int(lex.get_silence_automaton().states[0]),
                   loop=3.0, forward=0.0, skip=3.0)
    cfg = TrainerConfig(min_obs=1, num_splits=splits, num_aligns=2, num_estimates=3,
                        pruning_threshold=300.0)
    dtype = "df32" if train_dtype == "df32" else torch.float64
    trainer = Trainer(cfg, lex, model, tdp, dtype=dtype, log=log, device=device)
    t0 = time.perf_counter()
    trainer.train(corpus)
    train_s = time.perf_counter() - t0
    write_mixture_set(os.path.join(out_dir, "am.mix"), model.to_raw())
    log(f"trained {model.num_densities()} densities in {train_s:.1f}s")
    return model, train_s


def build_lm_matrices(lex, tm, lm_scale, word_exit=None, sil_exit=None, *, arpa_path):
    """ARPA bigram matrices over the search lexicon with the config's
    scales: lm[v, w] = lm_scale · (−log p(w|v)) + exit TDP of word w
    (exit charged at word end, Am/TransitionModel.cc doExit). Silence is
    transparent (no LM score, exit only). word_exit/sil_exit override the
    config's TDP exits (the tuned operating point). ``arpa_path`` names
    the ARPA file (the AN4 setup's is data/an4.2.20081121.lm)."""
    from ..lm.arpa import ArpaLM

    arpa = ArpaLM(arpa_path)
    W = lex.num_words
    sil = lex.silence_idx
    if word_exit is None:
        word_exit = tm.scale * tm.default.exit
    if sil_exit is None:
        sil_exit = tm.scale * tm.silence.exit
    lm_ids = [arpa.index(lex.orth[w]) if lex.orth[w] in arpa.word2int
              else (arpa.index("<unk>") if "<unk>" in arpa.word2int else None)
              for w in range(W)]
    bos = arpa.index("<s>")
    lm = np.zeros((W, W))
    lm_start = np.zeros(W)
    for w in range(W):
        if w == sil:
            continue
        lm_start[w] = lm_scale * arpa.score(lm_ids[w], [bos]) + word_exit
        for v in range(W):
            if v == sil:
                continue  # transparent silence: context row unused
            lm[v, w] = lm_scale * arpa.score(lm_ids[w], [lm_ids[v]]) + word_exit
    lm[:, sil] = sil_exit
    lm_start[sil] = sil_exit
    return lm, lm_start


def decode(model, corpus, word_seqs, lex, tm, lm, lm_start, threshold,
           prune, lookahead_on, dtype_name, device="cuda"):
    """dtype_name: f32 | f64 | q8 | q8-preselect, or a name starting with
    ``linear`` for the linear-lexicon engine — q8* score acoustics with the
    int8 quantized batch scorer (models/quantized.py, the reference's
    SIMD-diagonal-maximum production scorer for this config,
    Mm/Module.cc:84 + recognition-triphones-lda.config:40), optionally with
    density-preselection clustering; the search scan itself runs f32.
    Everything runs on ``device`` (the card unless the caller asks for the
    CPU). The WCTS keeps silence LM-transparent, as the original's default."""
    from ..search.edit_distance import EDAccumulator, edit_distance
    from ..search.linear_lvcsr import decode_batch_linear_lvcsr
    from ..search.wcts import LookaheadTables, decode_batch_wcts

    quant = "q8" in dtype_name
    linear = dtype_name.startswith("linear")
    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    tables = tm.tree_tables(lex)
    la = LookaheadTables.build(tables) if lookahead_on else None
    pack = model.pack(dtype=torch.float32 if quant else dtype, device=device)
    lin_tables = tm.decoder_tables(lex) if linear else None

    n = corpus.num_segments
    idxs = list(range(n))
    feats, lens = corpus.padded_batch(idxs)
    qp = None
    if quant:
        from ..models.quantized import am_scores_q_chunked, build_quant_pack
        qp = build_quant_pack(model, preselection="preselect" in dtype_name, device=device)
    t0 = time.perf_counter()
    am = None
    if quant:
        B, T, dim = feats.shape
        flat = torch.as_tensor(np.asarray(feats).reshape(B * T, dim), dtype=torch.float32,
                               device=pack.device)
        am = am_scores_q_chunked(qp, flat).reshape(B, T, qp.num_mixtures)
    if linear:
        # the linear-lexicon engine: exact 1-best, no per-frame tree
        # statistics
        hyps = decode_batch_linear_lvcsr(
            pack, feats, np.asarray(lens), lin_tables, lm, lm_start,
            threshold, lex.silence_idx, prune=prune, am=am)
        stats = {k: np.zeros((feats.shape[1], n), np.int64)
                 for k in ("active_states", "active_trees", "word_ends")}
    else:
        hyps, stats = decode_batch_wcts(
            pack, feats, np.asarray(lens), tables, tm, lm, lm_start,
            threshold, lex.silence_idx, prune=prune, lookahead=la,
            dtype=dtype, emit_stats=True, transparent_silence=True,
            am=am)
    dt = time.perf_counter() - t0

    acc = EDAccumulator()
    n_words = 0
    sent_err = 0
    for s in idxs:
        ed = edit_distance(word_seqs[s], hyps[s])
        acc += ed
        n_words += len(word_seqs[s])
        if ed.total_count > 0:
            sent_err += 1
    audio_s = float(np.asarray(lens).sum()) * corpus.frame_duration
    # per-frame stats masked to real frames
    T = stats["active_states"].shape[0]
    mask = (np.arange(T)[:, None] < np.asarray(lens)[None, :])
    act = stats["active_states"].astype(np.float64)
    trees = stats["active_trees"].astype(np.float64)
    wends = stats["word_ends"].astype(np.float64)
    frames = mask.sum()
    return {
        "wer": 100.0 * acc.total_count / n_words,
        "ser": 100.0 * sent_err / n,
        "errors": [int(acc.substitute_count), int(acc.insert_count),
                   int(acc.delete_count)],
        "n_words": n_words,
        "decode_s": dt,
        "audio_s": audio_s,
        "rtf": dt / audio_s,
        "mean_active_states": float((act * mask).sum() / frames),
        "max_active_states": int(act.max()),
        "mean_active_trees": float((trees * mask).sum() / frames),
        "mean_word_ends": float((wends * mask).sum() / frames),
        "hyps": hyps,
    }
