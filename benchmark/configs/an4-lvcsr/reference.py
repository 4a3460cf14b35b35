"""Plain reference of the AN4 configuration's decode: the int8 quantized
max-approximated scores of the reference's SIMD batch scorer
(rwth-asr-0.5/src/Mm/BatchFeatureScorer.cc:375-396, .hh:199-333) and the
linear-lexicon bigram search with one LM-transparent silence copy per
predecessor (Teaching/LinearSearch.cc:211-436) in float32, with its word
traceback. NumPy for the quantization's tables, PyTorch for the products and the
search.

The quantization: means and features times scale / σ (the pooled σ), with
scale = 255 / (1.25 · 2 · max |μ / σ|) over the active densities, rounded
half to even and clipped to [-128, 127]; a density's integer distance
Σ (qx − qμ)² plus ⌊scale² · log-norm − 2 · scale² · log w⌋; per mixture the
least, divided by 2 · scale² in float32. ``bits=4`` quantizes to [-8, 7] with
the scale's 255 replaced by 15 (the control of this cell's check, put in the
program's place).

The search follows the semantics of the port's plain version of kernel M
(search/linear_lvcsr.py), itself held to the JAX package: within-word 0-1-2
recursion with the source state's TDPs (Sprint semantics; a word's last state
may loop), larger jumps winning ties; a word's entry from the best of the
predecessors' word ends or their silence copies' ends plus the boundary cost,
the first predecessor winning ties, entries winning ties; renormalisation by
the frame's best over words and silence copies, and pruning. The traceback
starts at the best word end or (if strictly better) silence end of the last
frame and walks predecessors at entry boundaries through silence origins.

Imports NumPy, PyTorch and the benchmark's plain readers only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.harness import lm as lm_text
from benchmark.harness import mixfile, traffic

BIG = 1e30
INACTIVE = 1 << 30
MAX_WORDS = 128
BATCH = 1040
SCORE_CHUNK = 1 << 14


def _scale(model: mixfile.Model, bits: int):
    """(1 / σ, the means over σ, the quantization's scale)."""
    isv = 1.0 / np.sqrt(model.variances[model.active][0])
    div = model.means * isv
    return isv, div, (2 ** bits - 1) / (1.25 * 2.0 * np.abs(div[model.active]).max())


def score_unit(model: mixfile.Model, bits: int = 8) -> float:
    """A score's step for one unit of the integer distance: 1 / (2 · scale²)."""
    scale = _scale(model, bits)[2]
    return 1.0 / float(np.float32(2.0 * scale * scale))


def quantized_scores(model: mixfile.Model, x, device, bits: int = 8) -> torch.Tensor:
    """[n, dim] float32 features (an array or a tensor) → [n, S] float32
    scores on ``device`` (the integer products in float64, where every
    partial sum is an exact integer)."""
    S, D, dim = model.means.shape
    var = model.variances[model.active][0]
    log_norm = dim * np.log(2 * np.pi) + np.log(var).sum()
    isv, div, scale = _scale(model, bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scale2x = 2.0 * scale * scale
    qm = np.clip(np.round(div * scale), lo, hi).astype(np.int64).reshape(S * D, dim)
    act = model.active.reshape(-1)
    consts = np.full(S * D, INACTIVE, np.int64)
    consts[act] = np.floor(scale * scale * log_norm
                           - scale2x * model.log_weights.reshape(-1)[act]).astype(np.int64)
    qm[~act] = 0
    qm_t = torch.as_tensor(qm, dtype=torch.float64, device=device)
    base = torch.as_tensor((qm * qm).sum(1) + consts, device=device)
    fscale = torch.as_tensor((isv * scale).astype(np.float32), device=device)
    div2 = torch.tensor(np.float32(scale2x), device=device)
    out = []
    for i in range(0, x.shape[0], SCORE_CHUNK):
        xf = torch.as_tensor(x[i:i + SCORE_CHUNK], dtype=torch.float32, device=device) * fscale
        qx = torch.clamp(torch.round(xf), lo, hi)
        qx = torch.where(torch.isnan(qx), torch.zeros_like(qx), qx).double()
        prod = torch.round(qx @ qm_t.T).long()
        d = (qx * qx).sum(1).long()[:, None] - 2 * prod + base[None, :]
        out.append(d.reshape(-1, S, D).amin(-1).float() / div2)
    return torch.cat(out)


def search_tables(cfg: dict, model: mixfile.Model):
    """The real words' lattice, the silence's, and the boundary costs."""
    lex = traffic.lexicon_from_config(cfg["lexicon"], model)
    t = cfg["tdp"]
    scale = float(t["scale"])

    def row(k):
        return [BIG if v == "inf" or float(v) == float("inf") else scale * float(v) for v in t[k]]
    sil = lex.silence
    real = [w for w in range(lex.num_words) if w != sil]
    W = len(real)
    P = max(len(lex.states[w]) for w in real)
    st = np.zeros((W, P), np.int64)
    wl = np.array([len(lex.states[w]) for w in real])
    for i, w in enumerate(real):
        st[i, :wl[i]] = lex.states[w]
        st[i, wl[i]:] = lex.states[w][-1]
    src = row("default")

    def within(length, rows):
        out = np.full((len(length), rows.shape[1], 3), BIG)
        for j in range(3):
            for s in range(rows.shape[1]):
                ok = (s - j >= 0) & (s < length)
                out[:, s, j] = np.where(ok, rows[:, max(s - j, 0), j], BIG)
        return out
    tdpw = within(wl, np.broadcast_to(np.array(src[:3]), (W, P, 3)))
    e = row("entry_m1")
    entry = np.stack([np.full(W, e[1]), np.where(wl > 1, e[2], BIG)], 1)
    ss = np.asarray(lex.states[sil], np.int64)
    stdp = within(np.array([len(ss)]), np.broadcast_to(np.array(row("silence")[:3]),
                                                       (1, len(ss), 3)))[0]
    sentry = np.array([e[1], e[2] if len(ss) > 1 else BIG])
    lmc = cfg["lm"]
    text = lm_text.arpa_text(lex.orth[1:], lmc["seed"], lmc["bigram_share"])
    lm, start = lm_text.boundary_costs(text, lex.orth, sil, lmc["lm_scale"], lmc["word_exit"],
                                       lmc["sil_exit"])
    lm_ext = np.concatenate([lm[np.ix_(real, real)], start[real][None, :]], 0)
    sil_exit = float(np.float32(lm[real[0], sil]))
    return np.asarray(real), st, wl, tdpw, entry, ss, stdp, sentry, sil_exit, lm_ext


def scan(am, lens, st, wl, tdpw, entry, ss, stdp, sentry, sil_exit, lm_ext, thr):
    """The search over am [B, T, S] float32 → the books the traceback walks."""
    B, T, S = am.shape
    dev, dt = am.device, am.dtype
    W, P = st.shape
    V, Ps = W + 1, len(ss)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt)

    def i32(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)
    big, half = f(BIG), f(BIG) * 0.5
    tdpw, entp, stdp, sentp, lm = f(tdpw), f(entry), f(stdp), f(sentry), f(lm_ext)
    sexit, thr = f(sil_exit), f(thr)
    st = torch.as_tensor(st, device=dev)
    lp = torch.as_tensor(wl - 1, device=dev)
    sst = torch.as_tensor(ss, device=dev)
    valid = torch.as_tensor(np.arange(P)[None, :] < wl[:, None], device=dev)
    widx = torch.arange(W, device=dev)
    ne = min(2, Ps)
    hyp, bkp, pred = big.expand(B, W, P).clone(), i32((B, W, P), 0), i32((B, W, P), W)
    shyp, sorg = big.expand(B, V, Ps).clone(), i32((B, V, Ps), 0)
    book, silend, silorg = big.expand(B, W).clone(), big.expand(B, V).clone(), i32((B, V), 0)
    bcol, sbcol = big.expand(B, W, 1), big.expand(B, V, 1)
    z_w, p_w, z_v = i32((B, W, 2), 0), i32((B, W, 2), W), i32((B, V, 2), 0)
    outs = {k: [] for k in ("book", "bkp", "pred", "origin", "silend", "silorg")}
    for i in range(T):
        t = i + 1
        a = am[:, i]
        ams = a[:, st]
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = torch.cat([bcol, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]], 2)
        c2 = torch.cat([bcol, bcol, hyp[:, :, :-2] + tdpw[None, :, 2:, 2]], 2)
        b1 = torch.cat([z_w[:, :, :1], bkp[:, :, :-1]], 2)
        b2 = torch.cat([z_w, bkp[:, :, :-2]], 2)
        p1 = torch.cat([p_w[:, :, :1], pred[:, :, :-1]], 2)
        p2 = torch.cat([p_w, pred[:, :, :-2]], 2)
        wi, wb, wp = c2, b2, p2
        for c, b, p in ((c1, b1, p1), (c0, bkp, pred)):
            take = c < wi
            wi, wb, wp = torch.where(take, c, wi), torch.where(take, b, wb), torch.where(take, p, wp)
        wi = wi + ams
        start = torch.zeros((B, 1), dtype=dt, device=dev) if t == 1 else big.expand(B, 1)
        eb = torch.cat([book, start], 1)
        via = silend < eb
        eb = torch.minimum(eb, silend)
        origin = torch.where(via, silorg, i32((B, V), t - 1))
        cand = eb[:, :, None] + lm[None]
        ebase, epred = cand.amin(1), cand.argmin(1).to(torch.int32)
        e = (ebase[:, :, None] + entp[None]) + a[:, st[:, :2]]
        e = torch.cat([e, big.expand(B, W, P - 2)], 2)
        ep = torch.cat([epred[:, :, None].expand(B, W, 2), i32((B, W, P - 2), W)], 2)
        take = e <= wi
        new = torch.where(take, e, wi)
        nb = torch.where(take, i32((), t - 1), wb)
        npred = torch.where(take, ep, wp)
        new = torch.minimum(torch.where(valid[None], new, big), big)
        sams = a[:, sst][:, None, :]
        s0 = shyp + stdp[None, None, :, 0]
        s1 = torch.cat([sbcol, shyp[:, :, :-1] + stdp[None, None, 1:, 1]], 2)[:, :, :Ps]
        s2 = torch.cat([sbcol, sbcol, shyp[:, :, :-2] + stdp[None, None, 2:, 2]], 2)[:, :, :Ps]
        o1 = torch.cat([z_v[:, :, :1], sorg[:, :, :-1]], 2)[:, :, :Ps]
        o2 = torch.cat([z_v, sorg[:, :, :-2]], 2)[:, :, :Ps]
        sw, so = s2, o2
        for c, o in ((s1, o1), (s0, sorg)):
            take = c < sw
            sw, so = torch.where(take, c, sw), torch.where(take, o, so)
        sw = sw + sams
        se = (eb[:, :, None] + sentp[None, None, :ne]) + a[:, sst[:ne]][:, None, :]
        if Ps > ne:
            se = torch.cat([se, big.expand(B, V, Ps - ne)], 2)
        take = se <= sw
        snew = torch.minimum(torch.where(take, se, sw), big)
        sno = torch.where(take, origin[:, :, None].expand(B, V, Ps), so)
        best = torch.minimum(new.amin(dim=(1, 2)), snew.amin(dim=(1, 2)))
        best = torch.where(best >= half, torch.zeros_like(best), best)[:, None, None]
        new = torch.where(new >= half, big, new - best)
        snew = torch.where(snew >= half, big, snew - best)
        new = torch.where(new > thr, big, new)
        snew = torch.where(snew > thr, big, snew)
        ends = new[:, widx, lp]
        bk = torch.where(ends >= half, big, ends)
        sends = snew[:, :, Ps - 1]
        se_new = torch.where(sends >= half, big, sends + sexit)
        alive = t <= lens
        a3, a2 = alive[:, None, None], alive[:, None]
        hyp, bkp = torch.where(a3, new, hyp), torch.where(a3, nb, bkp)
        pred = torch.where(a3, npred, pred)
        shyp, sorg = torch.where(a3, snew, shyp), torch.where(a3, sno, sorg)
        book = torch.where(a2, bk, book)
        silend = torch.where(a2, se_new, silend)
        silorg = torch.where(a2, sno[:, :, Ps - 1], silorg)
        for k, v in (("book", bk), ("bkp", nb[:, widx, lp]), ("pred", npred[:, widx, lp]),
                     ("origin", origin), ("silend", se_new), ("silorg", sno[:, :, Ps - 1])):
            outs[k].append(v)
    return {k: torch.stack(v) for k, v in outs.items()}


def traceback(o, lens, W):
    """Real-word indices of each utterance, first word first."""
    book, bkp, pred, origin = o["book"], o["bkp"], o["pred"], o["origin"]
    silend, silorg = o["silend"], o["silorg"]
    T, B, _ = book.shape
    dev = book.device
    bi = torch.arange(B, device=dev)
    lens = lens.to(torch.int64)
    tb = lens.clamp(min=1)
    tl = (tb - 1).clamp(max=T - 1)
    fb, fs = book[tl, bi], silend[tl, bi]
    wb, sv = fb.argmin(1), fs.argmin(1)
    use_sil = fs.amin(1) < fb[bi, wb]
    cur = torch.where(use_sil, sv, wb)
    t = torch.where(use_sil, silorg[tl, bi, sv].long(), tb)
    done = (cur >= W) | (t <= 0) | (lens == 0)
    out = []
    for _ in range(MAX_WORDS):
        out.append(torch.where(done, torch.full_like(cur, -1), cur))
        tc = (t - 1).clamp(0, T - 1)
        cc = cur.clamp(0, W - 1)
        boundary = bkp[tc, bi, cc].long()
        v = pred[tc, bi, cc].long()
        t_next = origin[boundary.clamp(0, T - 1), bi, v.clamp(0, W)].long()
        new_done = done | (v >= W) | (t_next <= 0)
        cur = torch.where(done, cur, v)
        t = torch.where(done, t, t_next)
        done = new_done
    return torch.stack(out).cpu().numpy()


def decode(cfg: dict, model_path: str, features: np.ndarray, offsets: np.ndarray,
           device, bits: int = 8, scores: torch.Tensor = None) -> List[List[int]]:
    """Each utterance's words (lexicon indices, silence left out); ``scores``
    the features' ``quantized_scores`` where they were worked out already."""
    model = mixfile.read_model(model_path, cfg["dim"], cfg["pooling"])
    real, *tabs = search_tables(cfg, model)
    W = len(real)
    lengths = np.diff(offsets)
    words: List[List[int]] = [[] for _ in lengths]
    if scores is None:
        scores = quantized_scores(model, features, device, bits)
    with torch.no_grad():
        for i in range(0, len(lengths), BATCH):
            ids = np.arange(i, min(i + BATCH, len(lengths)))
            lens = lengths[ids]
            T = int(lens.max())
            idx = offsets[ids][:, None] + np.minimum(np.arange(T)[None, :], lens[:, None] - 1)
            am = scores[torch.as_tensor(idx.reshape(-1), device=device)].reshape(len(ids), T, -1)
            am = torch.where(torch.as_tensor(np.arange(T)[None, :, None] < lens[:, None, None],
                                             device=device), am, torch.zeros((), device=device))
            lt = torch.as_tensor(lens, dtype=torch.int32, device=device)
            o = scan(am, lt, *tabs, float(cfg["acoustic_pruning"]))
            w = traceback(o, lt, W)
            for k, u in enumerate(ids):
                seq = [int(real[x]) for x in w[:, k] if x >= 0]
                words[u] = seq[::-1]
    return words
