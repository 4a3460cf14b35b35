"""The AN4 LVCSR system's decode: the ARPA bigram boundary matrices and the
1-best decode with its report — counterpart of ``build_lm_matrices`` and
``decode`` in the repository's tools/an4_system.py.

``build_lm_matrices`` turns an ARPA LM into the boundary matrices of the
linear-lexicon and word-conditioned tree searches: lm[v, w] = lm_scale ·
(−log p(w|v)) + the exit TDP of word w; silence is transparent (its row is
unused, its column holds only the silence exit). ``decode`` scores a
corpus (the float "mxu" pack, or the int8 quantized scorer for the ``q8``
names) and decodes it with the linear engine (``linear*`` names: kernels M
and N) or the exact or pruned WCTS (kernel K), and reports WER, SER,
S/I/D, RTF and the search-space means. The assembly of the system from the
reference's Bliss lexicon, CART tree, Flow features and trained model
(``build_system``, ``load_corpus``, ``train_model``) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch


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
