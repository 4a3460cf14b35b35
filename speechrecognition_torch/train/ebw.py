"""Discriminative GMM training: lattice-based MMI with EBW updates —
counterpart of speechrecognition_tpu/train/ebw.py.

The reference's discriminative tier:
  * EBW re-estimation        — Mm/EbwDiscriminativeMixtureSetEstimator.cc
                               (extended Baum-Welch with per-density D)
  * I-smoothing              — Mm/ISmoothingMixtureSetEstimator.cc
  * lattice-based statistics — Speech/EbwDiscriminativeMixtureSetTrainer.cc,
                               Lattice/Posterior.cc

Per iteration, on the trainer's device:
  1. numerator statistics: the forced alignment's weighted EM statistics
     (gmm.accumulate_chunk, weight 1 a frame);
  2. denominator lattices: the word-loop decode as the bigram scan with a
     uniform LM row (kernel J) → per-frame books → WordLattice on the host;
     arc posteriors by the lattice's forward-backward;
  3. denominator statistics: every surviving arc's word automaton is
     force-aligned to its frame span (batched Viterbi: kernels E and G) and
     its frames accumulate with weight = arc posterior;
  4. the EBW M-step on the host in float64: μ/σ² with the per-density
     smoothing constant D = max(E·γ_den, D_min), doubled until the variances
     stay positive; mixture weights by the positivity-shifted update;
     optional I-smoothing of the numerator statistics with strength τ.

The packs are the "mxu" [x², x, 1] · P tables in ``dtype`` (float32 or
float64), built on ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..align.viterbi import AlignerTables, align_batch
from ..corpus import Corpus
from ..lexicon import Lexicon
from ..models import gmm as gmm_mod
from ..models.gmm import MIN_VARIANCE, MixtureModel, VarianceModel
from ..search.decoder import DecoderTables
from ..search.lattice import WordLattice
from ..search.ngram_decoder import check_decoder_tables, decode_scan_bigram
from ..tdp import TdpModel


@dataclass
class EbwConfig:
    e_constant: float = 2.0          # Mm EBW 'E' (D = E · denominator count)
    d_min: float = 1.0               # lower bound on D
    i_smoothing_tau: float = 0.0     # I-smoothing strength toward ML stats
    posterior_threshold: float = 8.0  # drop arcs with −log posterior above
    word_penalty: float = 80.0       # denominator decode word penalty
    am_threshold: float = 200.0      # denominator decode beam
    batch_size: int = 32             # decode/align batch
    chunk_frames: int = 1 << 14      # accumulation chunk
    weight_floor: float = 1e-6       # mixture-weight floor after update


#: span buckets of the arc alignments: a handful of batch shapes
T_BUCKETS = (32, 64, 128, 256, 512)


def _t_bucket(n: int) -> int:
    for b in T_BUCKETS:
        if n <= b:
            return b
    return -(-n // T_BUCKETS[-1]) * T_BUCKETS[-1]


class EbwTrainer:
    """One object per discriminative training run (model updated in place)."""

    def __init__(self, cfg: EbwConfig, lexicon: Lexicon, model: MixtureModel,
                 tdp: TdpModel, dtype=torch.float64, device="cuda"):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unknown discriminative training dtype {dtype!r}")
        self.cfg = cfg
        self.lexicon = lexicon
        self.model = model
        self.tdp = tdp
        self.dtype = dtype
        self.device = gmm_mod.pack_device(device, "discriminative trainer")
        #: host seconds by part of an iteration (each ends in a copy to the
        #: host): the lattices (decode, books → WordLattice, the lattices'
        #: forward-backward and accuracies), the arcs' alignment, the
        #: accumulation, the EBW update and the MMI criterion
        self.phase_seconds = {"lattices": 0.0, "align": 0.0, "accumulate": 0.0,
                              "update": 0.0, "criterion": 0.0}

    def _pack(self) -> gmm_mod.ScorePack:
        return self.model.pack(dtype=self.dtype, device=self.device)

    # -- statistics ------------------------------------------------------------

    def _accumulate_frames(self, pack, feats: np.ndarray, states: np.ndarray,
                           weights: np.ndarray):
        """Weighted statistics over flat frames in chunks of chunk_frames,
        summed in float64 on the device (the reference pads the last chunk
        with weight-0 rows, which add nothing). Returns float64 numpy."""
        t0 = time.perf_counter()
        S, D = pack.num_mixtures, pack.density_cap
        dim = self.model.dim
        f64 = dict(dtype=torch.float64, device=self.device)
        w = torch.zeros((S, D), **f64)
        xs = torch.zeros((S, D, dim), **f64)
        x2s = torch.zeros((S, D, dim), **f64)
        C = self.cfg.chunk_frames
        for start in range(0, len(states), C):
            end = min(start + C, len(states))
            cw, cxs, cx2s = gmm_mod.accumulate_chunk(
                pack, torch.as_tensor(np.asarray(feats[start:end], np.float32), device=self.device),
                torch.as_tensor(np.asarray(states[start:end], np.int64), device=self.device),
                torch.as_tensor(np.asarray(weights[start:end], np.float32), device=self.device),
                first_pass=False)
            w, xs, x2s = w + cw, xs + cxs, x2s + cx2s
        out = tuple(t.cpu().numpy() for t in (w, xs, x2s))
        self.phase_seconds["accumulate"] += time.perf_counter() - t0
        return out

    def numerator_statistics(self, corpus: Corpus, alignment: np.ndarray):
        return self._accumulate_frames(
            self._pack(), corpus.features, alignment.astype(np.int32),
            np.ones(corpus.total_frames, np.float32))

    def decode_lattices(self, corpus: Corpus) -> List[WordLattice]:
        """Denominator word lattices from the zerogram word-loop decode
        (bigram scan with a uniform LM row = constant word penalty)."""
        t0 = time.perf_counter()
        pack = self._pack()
        lex = self.lexicon
        tables = DecoderTables.build(lex, self.tdp, word_penalty=0.0)
        check_decoder_tables(tables, pack.num_mixtures)
        W = lex.num_words
        lm = np.full((W, W), self.cfg.word_penalty)
        lm[:, lex.silence_idx] = 0.0
        lm_start = lm[0].copy()
        dev, dt = self.device, self.dtype
        ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                for a in (tables.state_table, tables.last_pos, tables.word_len)]
        floats = [torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=dev)
                  for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]

        lats: List[Optional[WordLattice]] = [None] * corpus.num_segments
        order = np.argsort(corpus.lengths, kind="stable")
        Bsz = self.cfg.batch_size
        for i in range(0, corpus.num_segments, Bsz):
            ids = order[i: i + Bsz].tolist()
            n_real = len(ids)
            while len(ids) < Bsz:
                ids.append(ids[-1])
            max_len = max(corpus.seq_length(s) for s in ids)
            T = -(-max_len // 32) * 32
            feats, lens = corpus.padded_batch(ids, pad_to=T)
            B = feats.shape[0]
            flat = torch.as_tensor(feats.reshape(B * T, -1), dtype=torch.float32, device=dev)
            am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures).to(dt)
            scores, bkps, _preds, offsets = decode_scan_bigram(
                am.contiguous(), torch.as_tensor(np.asarray(lens, np.int32), device=dev), *ints,
                *floats, self.cfg.am_threshold)
            scores, bkps, offsets = (t.cpu().numpy() for t in (scores, bkps, offsets))
            for b, s in enumerate(ids[:n_real]):
                lats[s] = WordLattice.from_books(
                    scores[:, b], bkps[:, b], offsets[:, b],
                    int(lens[b]), silence=lex.silence_idx)
        self.phase_seconds["lattices"] += time.perf_counter() - t0
        return lats  # type: ignore[return-value]

    def denominator_statistics(self, corpus: Corpus,
                               lattices: Sequence[WordLattice]):
        """Arc-posterior-weighted statistics: batched Viterbi alignment of
        every surviving lattice arc's word automaton to its span."""
        t0 = time.perf_counter()
        jobs = []  # (segment, start, end, word, posterior_prob)
        for s, lat in enumerate(lattices):
            _nodes, post = lat.forward_backward()
            for a in lat.arcs:
                p = post[a]
                if np.isfinite(p) and p <= self.cfg.posterior_threshold:
                    jobs.append((s, a.start, a.end, a.word, float(np.exp(-p))))
        self.phase_seconds["lattices"] += time.perf_counter() - t0
        return self.arc_statistics(corpus, jobs)

    def arc_statistics(self, corpus: Corpus, jobs):
        """Weighted statistics over lattice arcs: batched Viterbi alignment
        of each arc's word automaton to its frame span, frames accumulated
        with the job's weight. jobs: (segment, start, end, word, weight) —
        the building block both MMI denominators and MPE's sign-split
        accumulators use (Speech/LatticeArcAccumulator.cc)."""
        t0 = time.perf_counter()
        pack = self._pack()
        lex = self.lexicon
        dim = self.model.dim
        feats_out: List[np.ndarray] = []
        states_out: List[np.ndarray] = []
        weights_out: List[np.ndarray] = []
        jobs.sort(key=lambda j: j[2] - j[1])
        Bsz = self.cfg.batch_size
        # a fixed position capacity and bucketed spans, as the reference pads
        # them (the batch shapes it compiled); the padding changes no output
        A_cap = max(3, max(lex.get_automaton_for_word(w).num_states
                           for w in range(lex.num_words)))
        for i in range(0, len(jobs), Bsz):
            chunk = jobs[i: i + Bsz]
            n_real = len(chunk)
            while len(chunk) < Bsz:
                chunk.append(chunk[-1])
            span = [e - st for _s, st, e, _w, _p in chunk]
            T = _t_bucket(max(span))
            feats = np.zeros((Bsz, T, dim), np.float32)
            lens = np.asarray(span, np.int32)
            automata = []
            for b, (seg, st, e, w, _p) in enumerate(chunk):
                o = int(corpus.feature_offsets[seg])
                feats[b, : e - st] = corpus.features[o + st: o + e]
                automata.append(lex.get_automaton_for_word(w))
            tables = AlignerTables.build(automata, self.tdp, pad_to=A_cap)
            st_tbl, _costs = align_batch(pack, feats, lens, tables, pruning_threshold=None,
                                         dtype=self.dtype)
            for b in range(n_real):
                L = int(lens[b])
                feats_out.append(feats[b, :L])
                states_out.append(st_tbl[b, :L].astype(np.int32))
                weights_out.append(np.full(L, chunk[b][4], np.float32))
        self.phase_seconds["align"] += time.perf_counter() - t0

        if not feats_out:
            S, D = pack.num_mixtures, pack.density_cap
            return (np.zeros((S, D)), np.zeros((S, D, dim)), np.zeros((S, D, dim)))
        return self._accumulate_frames(
            pack, np.concatenate(feats_out), np.concatenate(states_out),
            np.concatenate(weights_out))

    # -- EBW M-step --------------------------------------------------------------

    def ebw_update(self, num, den) -> None:
        """Extended Baum-Welch re-estimation in place
        (Mm/EbwDiscriminativeMixtureSetEstimator.cc semantics)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        model = self.model
        w_n, x_n, x2_n = [a.copy() for a in num]
        w_d, x_d, x2_d = den

        # I-smoothing: scale numerator stats by (γ+τ)/γ — equivalent to
        # adding τ observations drawn from the ML estimate itself
        if cfg.i_smoothing_tau > 0:
            tau = cfg.i_smoothing_tau
            nz = w_n > 0
            scale = np.where(nz, (w_n + tau) / np.where(nz, w_n, 1.0), 1.0)
            x_n *= scale[:, :, None]
            x2_n *= scale[:, :, None]
            w_n = np.where(nz, w_n + tau, w_n)

        new_vars_num: Dict[int, np.ndarray] = {}   # var_idx → Σ occ·σ²
        new_vars_den: Dict[int, float] = {}
        global_var_num = np.zeros(model.dim)
        global_var_den = 0.0

        for s in range(model.num_mixtures):
            occ_tot = 0.0
            occs = []
            for d, (mi, vi) in enumerate(model.mixtures[s]):
                gn, gd = float(w_n[s, d]), float(w_d[s, d])
                occs.append((d, mi, vi, gn, gd))
                occ_tot += gn
            if occ_tot <= 0:
                continue
            for d, mi, vi, gn, gd in occs:
                if gn + gd <= 0:
                    continue
                mu = model.means[mi].copy()
                var = model.vars[vi].copy()
                if not np.all(np.isfinite(mu)):
                    continue
                if not np.all(np.isfinite(var)) or np.any(var <= 0):
                    var = np.full(model.dim, 1.0)
                Dd = max(cfg.e_constant * gd, cfg.d_min)
                for _ in range(60):
                    denom = gn - gd + Dd
                    if denom > 1e-8:
                        mu_new = (x_n[s, d] - x_d[s, d] + Dd * mu) / denom
                        var_new = ((x2_n[s, d] - x2_d[s, d]
                                    + Dd * (var + mu * mu)) / denom
                                   - mu_new * mu_new)
                        if np.all(var_new > MIN_VARIANCE):
                            break
                    Dd *= 2.0
                else:
                    mu_new, var_new = mu, var
                model.means[mi] = mu_new
                occ = max(gn, 1e-8)
                new_vars_num[vi] = new_vars_num.get(
                    vi, np.zeros(model.dim)) + occ * var_new
                new_vars_den[vi] = new_vars_den.get(vi, 0.0) + occ
                global_var_num += occ * var_new
                global_var_den += occ

            # mixture weights: shifted positivity update
            # c' ∝ γ_num − γ_den + C·c with C chosen so all terms stay ≥ floor
            c_old = np.array([model.mean_weights[mi] for _d, mi, _vi, _gn, _gd
                              in occs])
            delta = np.array([gn - gd for _d, _mi, _vi, gn, gd in occs])
            C = cfg.e_constant * max(
                1.0, *(max(0.0, -dl) / max(c, 1e-8)
                       for dl, c in zip(delta, c_old)))
            c_new = np.maximum(delta + C * c_old, cfg.weight_floor)
            c_new /= c_new.sum()
            for (d, mi, _vi, _gn, _gd), cv in zip(occs, c_new):
                model.mean_weights[mi] = cv
                model.mean_weights_log[mi] = np.log(cv)

        # variance write-back per pooling mode
        if model.var_model == VarianceModel.GLOBAL_POOLING:
            if global_var_den > 0:
                v = np.maximum(global_var_num / global_var_den, MIN_VARIANCE)
                self._set_var(0, v)
        else:
            for vi, acc in new_vars_num.items():
                v = np.maximum(acc / new_vars_den[vi], MIN_VARIANCE)
                self._set_var(vi, v)
        # make the update durable: .mix checkpoints store accumulators
        # and re-finalize on load, so the discriminative parameters must
        # be encoded back into them
        model.sync_accumulators_to_parameters()
        self.phase_seconds["update"] += time.perf_counter() - t0

    def _set_var(self, vi: int, v: np.ndarray) -> None:
        model = self.model
        model.vars[vi] = v
        model.vars_inv[vi] = 1.0 / v
        model.norm[vi] = (model.dim * np.log(2 * np.pi) + np.log(v).sum()) / 2.0

    # -- objective and iteration -----------------------------------------------------

    def mmi_criterion(self, corpus: Corpus, alignment: np.ndarray,
                      lattices: Sequence[WordLattice]) -> float:
        """−log p_num + log p_den averaged per frame (lower = better MMI):
        numerator = aligned-path acoustic score, denominator = lattice
        total (−logΣ over paths)."""
        t0 = time.perf_counter()
        pack = self._pack()
        num = 0.0
        C = self.cfg.chunk_frames
        N = corpus.total_frames
        for start in range(0, N, C):
            end = min(start + C, N)
            sc = gmm_mod.am_scores(pack, torch.as_tensor(corpus.features[start:end],
                                                         device=self.device))
            st = torch.as_tensor(alignment[start:end].astype(np.int64), device=self.device)
            num += float(sc.gather(1, st[:, None]).to(torch.float64).sum())
        den = 0.0
        for lat in lattices:
            nodes, _post = lat.forward_backward()
            den += float(nodes[lat.num_frames])
        self.phase_seconds["criterion"] += time.perf_counter() - t0
        return (num - den) / N

    def iterate(self, corpus: Corpus, alignment: np.ndarray) -> dict:
        """One full MMI/EBW iteration; returns before/after diagnostics."""
        lats = self.decode_lattices(corpus)
        before = self.mmi_criterion(corpus, alignment, lats)
        num = self.numerator_statistics(corpus, alignment)
        den = self.denominator_statistics(corpus, lats)
        self.ebw_update(num, den)
        lats_after = self.decode_lattices(corpus)
        after = self.mmi_criterion(corpus, alignment, lats_after)
        return {"criterion_before": before, "criterion_after": after,
                "num_frames_mass": float(num[0].sum()),
                "den_frames_mass": float(den[0].sum())}
