"""EM training loop: linear segmentation → EM with splitting → realignment —
counterpart of speechrecognition_tpu/train/em.py.

Orchestration mirrors the reference outer loop (src/sietill/Training.cpp:44-235):

    linear segmentation → accumulate(first_pass) → finalize → write lin.mix
    for i in 0..num_splits:
        if i>0: split(2·min_obs) → acc → finalize → eliminate(min_obs) → acc → finalize
        for j in 0..num_aligns:  realign (pruned Viterbi)
            for k in 0..num_estimates (1 when i==0): acc → finalize
    write <i>.mix each round; AM score after every estimation

The per-frame work runs on the trainer's device: the E-step and AM-score
passes over state-sorted frame blocks (models/gmm.em_pass_sorted; kernel H
on the df32 path), or the chunked sum-mode passes (max-approx=false), and
the chunked forced alignment (align/viterbi.py; kernels C, E/F and G).
Bookkeeping stays on the host in float64.

``dtype`` is torch.float32 or torch.float64 (``model.pack(dtype=...,
device=...)``, the [x², x, 1] · P scores) or "df32" (``model.pack_df(
device=...)``, double-float scores and DP: the reference's float64 decisions
with float32 arithmetic); the trainer builds them on its ``device``, which
the caller names (``device="cpu"`` for the CPU). Packs
hold each mixture's own densities: the reference package padded them, and
every realignment batch, to fixed shapes so that its device programs
compiled once; inactive slots and duplicated rows change no output, and the
port has no compiles to save.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import tracing
from ..align.linear_seg import (linear_alignment_mapping,
                                linear_segmentation_approximation,
                                linear_segmentation_full_dp,
                                linear_segmentation_running_sums)
from ..align.viterbi import AlignerTables, realign_batch
from ..config import Configuration, ParameterBool, ParameterFloat, ParameterInt, ParameterString
from ..corpus import Corpus
from ..io import read_alignment, read_mixture_set, write_alignment, write_mixture_set
from ..lexicon import Lexicon, build_segment_automaton
from ..models.gmm import (MixtureModel, em_accumulate_corpus, em_am_score_corpus,
                          em_pass_sorted, sorted_blocks)
from ..tdp import TdpModel


@dataclass
class TrainerConfig:
    min_obs: int = 1
    num_splits: int = 1
    num_aligns: int = 1
    num_estimates: int = 1
    pruning_threshold: float = 50.0
    mixture_path: str = ""
    alignment_path: str = ""
    training_stats_path: str = ""
    realign: bool = True
    alignment_pruning: bool = True
    approx_linear_segmentation: bool = True
    #: "" (use the bool above, reference semantics) | "approx" |
    #: "running-sums" | "full-dp" — the reference's three interchangeable
    #: segmentations (Training.cpp:257,350,429)
    segmentation_variant: str = ""
    write_linear_segmentation: bool = False
    segmentation_path: str = ""
    batch_size: int = 256
    chunk_frames: int = 1 << 16
    #: resume after an interruption: skip splits < start_split, loading
    #: `<mixture-path><start_split-1>.mix` (Training.cpp:131-136,214-225)
    start_split: int = 0

    @staticmethod
    def from_config(config: Configuration) -> "TrainerConfig":
        return TrainerConfig(
            min_obs=ParameterInt("min-obs", 1)(config),
            num_splits=ParameterInt("num-splits", 1)(config),
            num_aligns=ParameterInt("num-aligns", 1)(config),
            num_estimates=ParameterInt("num-estimates", 1)(config),
            pruning_threshold=ParameterFloat("pruning-threshold", 50.0)(config),
            mixture_path=ParameterString("mixture-path", "")(config),
            alignment_path=ParameterString("alignment-path", "")(config),
            training_stats_path=ParameterString("training-stats-path", "")(config),
            realign=ParameterBool("realign", True)(config),
            alignment_pruning=ParameterBool("alignment-pruning", True)(config),
            approx_linear_segmentation=ParameterBool("approx-linear-segmentation", True)(config),
            write_linear_segmentation=ParameterBool("write-linear-segmentation", False)(config),
            segmentation_path=ParameterString("segmentation-path", "")(config),
            batch_size=ParameterInt("train-batch-size", 256)(config),
            start_split=ParameterInt("start-split", 0)(config),
            segmentation_variant=ParameterString(
                "linear-segmentation-variant", "")(config),
        )


class Trainer:
    def __init__(self, cfg: TrainerConfig, lexicon: Lexicon, model: MixtureModel,
                 tdp: TdpModel, max_approx: bool = True, dtype=torch.float32,
                 log=print, *, device):
        if dtype not in (torch.float32, torch.float64, "df32"):
            raise ValueError(f"unknown training dtype {dtype!r}")
        self.cfg = cfg
        self.lexicon = lexicon
        self.model = model
        self.tdp = tdp
        self.max_approx = max_approx
        self.dtype = dtype
        self.device = torch.device(device)
        self.log = log
        self.stats_lines: List[str] = []
        #: the corpus features on the device (built lazily): the flat
        #: [N_pad, dim] array, N padded to a multiple of chunk_frames
        self._dev_flat = None
        #: state-sorted block cache for the E-step passes, rebuilt when the
        #: alignment changes (one gather per realignment, reused by every
        #: pass under that alignment)
        self._align_version = 0
        self._sorted_cache = None
        self.phase_seconds = {"estimate": 0.0, "align": 0.0, "score": 0.0}

    # -- device helpers ------------------------------------------------------

    @tracing.span("em.pack")
    def _pack(self):
        if self.dtype == "df32":
            return self.model.pack_df(device=self.device)
        return self.model.pack(dtype=self.dtype, device=self.device)

    def _device_corpus(self, corpus: Corpus) -> torch.Tensor:
        """Upload the flat feature store once (zero rows pad it to whole
        chunks of ``chunk_frames`` for the sum-mode passes)."""
        if self._dev_flat is None:
            C = self.cfg.chunk_frames
            N = corpus.total_frames
            fp = np.zeros((-(-N // C) * C, self.model.dim), np.float32)
            fp[:N] = corpus.features
            self._dev_flat = torch.as_tensor(fp, device=self.device)
        return self._dev_flat

    def _chunked(self, corpus: Corpus, alignment: np.ndarray):
        """[K, C, dim] features, [K, C] states and mask of the sum-mode passes."""
        flat = self._device_corpus(corpus)
        C = self.cfg.chunk_frames
        K = flat.shape[0] // C
        st = np.zeros(K * C, np.int32)
        st[: alignment.shape[0]] = alignment
        mask = np.zeros(K * C, np.float32)
        mask[: corpus.total_frames] = 1.0
        return (flat.reshape(K, C, -1), torch.as_tensor(st.reshape(K, C), device=self.device),
                torch.as_tensor(mask.reshape(K, C), device=self.device))

    def _sorted_corpus(self, corpus: Corpus, alignment: np.ndarray):
        """State-sorted frame blocks (models/gmm.sorted_blocks) gathered on
        the device, cached per alignment version."""
        if (self._sorted_cache is not None
                and self._sorted_cache[0] == self._align_version):
            return self._sorted_cache[1:]
        flat = self._device_corpus(corpus)
        with tracing.span("em.sorted_blocks"):
            frame_idx, block_state, _nb = sorted_blocks(alignment, self.model.num_mixtures)
        with tracing.span("em.gather"):
            mask = torch.as_tensor((frame_idx >= 0).astype(np.float32), device=self.device)
            frames = flat[torch.as_tensor(np.maximum(frame_idx, 0), device=self.device)]
            bs = torch.as_tensor(block_state, device=self.device)
        self._sorted_cache = (self._align_version, frames, mask, bs)
        return frames, mask, bs

    def _em_pass(self, corpus: Corpus, alignment: np.ndarray, first_pass: bool = False):
        """One AM-score + E-step pass; returns (per-frame score, stats as
        float64 numpy)."""
        pack = self._pack()
        if not (first_pass or self.max_approx):
            # sum-mode EM (max-approx=false): soft membership over the
            # aligned mixture's densities (Mixtures.cpp:307-330), which the
            # state-sorted pass does not cover
            if self.dtype == "df32":
                raise NotImplementedError(
                    "sum-mode EM (max-approx=false) needs dtype f32/f64; "
                    "the df32 path covers max-approx only")
            chunks = self._chunked(corpus, alignment)
            total = em_am_score_corpus(pack, *chunks)
            stats = em_accumulate_corpus(pack, *chunks)
        else:
            frames, mask, bs = self._sorted_corpus(corpus, alignment)
            with tracing.span("em.estep"):
                total, *stats = em_pass_sorted(pack, frames, mask, bs, first_pass=first_pass)
        with tracing.span("em.stats_to_host"):
            w, xs, x2s = (t.cpu().numpy() for t in stats)
            total = float(total)
        return total / corpus.total_frames, (w, xs, x2s)

    def _accumulate(self, corpus: Corpus, alignment: np.ndarray, first_pass: bool) -> None:
        """One E-step over the whole corpus."""
        with tracing.span("em.estimate", self.phase_seconds, "estimate"):
            _score, stats = self._em_pass(corpus, alignment, first_pass)
            with tracing.span("em.mstep"):
                self.model.apply_statistics(*stats)

    def _score_and_accumulate(self, corpus: Corpus, alignment: np.ndarray) -> float:
        """AM score and E-step under the CURRENT model in one pass (the
        estimate loop's score(M_k)/accumulate(M_k) pair); the statistics
        are applied to the model, the per-frame AM score is returned."""
        with tracing.span("em.estimate", self.phase_seconds, "estimate"):
            score, stats = self._em_pass(corpus, alignment)
            with tracing.span("em.mstep"):
                self.model.apply_statistics(*stats)
        return score

    def calc_am_score(self, corpus: Corpus, alignment: np.ndarray) -> float:
        """Average per-frame score under the current alignment
        (reference: Training.cpp:585-612)."""
        with tracing.span("em.score", self.phase_seconds, "score"):
            score, _stats = self._em_pass(corpus, alignment)
        return score

    #: alignment padding buckets (multiples of ALIGN_CHUNK)
    ALIGN_BUCKETS = (320, 640, 960, 1280, 1600)

    def _align_bucket(self, length: int) -> int:
        for b in self.ALIGN_BUCKETS:
            if length <= b:
                return b
        return -(-length // self.ALIGN_BUCKETS[-1]) * self.ALIGN_BUCKETS[-1]

    def _realign(self, corpus: Corpus, tables_all: AlignerTables,
                 alignment: np.ndarray) -> None:
        """One whole-corpus realignment in length-sorted batches of
        ``batch_size`` utterances, gathered on the device from the resident
        features; each batch's states come back to the host once."""
        with tracing.span("em.realign", self.phase_seconds, "align"):
            flat = self._device_corpus(corpus)
            pack = self._pack()
            thr = self.cfg.pruning_threshold if self.cfg.alignment_pruning else None
            order = np.argsort(corpus.lengths, kind="stable")
            for i in range(0, corpus.num_segments, self.cfg.batch_size):
                with tracing.span("em.realign.index"):
                    ids = order[i: i + self.cfg.batch_size]
                    T = self._align_bucket(int(corpus.lengths[ids].max()))
                    lens = np.minimum(corpus.lengths[ids], T).astype(np.int32)
                    idx = corpus.feature_offsets[ids][:, None] + np.arange(T)[None, :]
                    idx = np.where(np.arange(T)[None, :] < lens[:, None], idx, 0)
                    rows = tables_all.rows(ids)
                if tracing.enabled():
                    tracing.count("align.frames_real", int(lens.sum()))
                    tracing.count("align.frames_padded", len(ids) * T)
                with tracing.span("em.realign.batch"):
                    states = realign_batch(pack, flat, idx, lens, rows, thr,
                                           tie_pruned=self.cfg.alignment_pruning,
                                           dtype=self.dtype)
                with tracing.span("em.realign.states_to_host"):
                    states = states.cpu().numpy()
                with tracing.span("em.realign.scatter"):
                    for b, s in enumerate(ids):
                        o = corpus.feature_offsets[s]
                        alignment[o: o + lens[b]] = states[b, : lens[b]]
            self._align_version += 1

    # -- the outer loop ------------------------------------------------------

    def train(self, corpus: Corpus) -> np.ndarray:
        cfg = self.cfg
        t_start = time.perf_counter()
        automata = [build_segment_automaton(self.lexicon, orth) for orth in corpus.orths]
        tables_all = AlignerTables.build(automata, self.tdp)
        alignment = np.zeros(corpus.total_frames, dtype=np.int32)

        if cfg.start_split > 0:
            self._resume(corpus, tables_all, alignment)
            for i in range(cfg.start_split, cfg.num_splits + 1):
                self._split_round(corpus, tables_all, alignment, i)
            self._finish(t_start)
            return alignment

        # linear segmentation (energy-based initial alignment)
        variant = cfg.segmentation_variant or (
            "approx" if cfg.approx_linear_segmentation else "running-sums")
        for s in range(corpus.num_segments):
            energy = corpus.feature_sequence(s)[:, 0]
            if variant == "approx":
                b1, b2 = linear_segmentation_approximation(energy)
            elif variant == "running-sums":
                b1, b2 = linear_segmentation_running_sums(energy)
            elif variant == "full-dp":
                # bug-compatible one-past-the-end mean: the next segment's
                # first energy in the flat store (Training.cpp:301)
                o_end = corpus.feature_offsets[s] + energy.shape[0]
                nxt = (float(corpus.features[o_end, 0])
                       if o_end < corpus.total_frames else 0.0)
                b1, b2 = linear_segmentation_full_dp(energy, next_energy=nxt)
            else:
                raise ValueError(f"unknown segmentation variant: {variant}")
            o = corpus.feature_offsets[s]
            alignment[o: o + energy.shape[0]] = linear_alignment_mapping(
                automata[s].states, energy.shape[0], b1, b2)
            if cfg.write_linear_segmentation and cfg.segmentation_path:
                self._write_segmentation(
                    f"{cfg.segmentation_path}{corpus.names[s]}.seg", energy, b1, b2)

        self._align_version += 1
        self._accumulate(corpus, alignment, first_pass=True)
        self.model.finalize()
        score = self.calc_am_score(corpus, alignment)
        self.log(f"AM score: {score:.6g}")
        self._stat(f"-1 0 0 {score:g}")
        self.log(f"Num densities: {self.model.num_densities()}")
        if cfg.mixture_path:
            write_mixture_set(cfg.mixture_path + "lin.mix", self.model.to_raw())

        for i in range(cfg.num_splits + 1):
            self._split_round(corpus, tables_all, alignment, i)

        self._finish(t_start)
        return alignment

    @tracing.span("em.round")
    def _split_round(self, corpus: Corpus, tables_all: AlignerTables,
                     alignment: np.ndarray, i: int) -> None:
        """One split iteration: split/eliminate, realigns, estimates, and
        the <i>.mix checkpoint (Training.cpp:138-225)."""
        cfg = self.cfg
        if i > 0:
            self.model.split(2 * cfg.min_obs)
            self._accumulate(corpus, alignment, first_pass=False)
            self.model.finalize()
            self.model.eliminate(cfg.min_obs)
            self._accumulate(corpus, alignment, first_pass=False)
            self.model.finalize()
            self.log(f"Num densities: {self.model.num_densities()}")
            score = self.calc_am_score(corpus, alignment)
            self.log(f"AM score (post split): {score:.6g}")
            self._stat(f"{i} -1 0 {score:g}")

        for j in range(cfg.num_aligns):
            if cfg.realign:
                self._realign(corpus, tables_all, alignment)
                if cfg.alignment_path:
                    write_alignment(f"{cfg.alignment_path}{i}-{j}.dump", alignment)
            num_estimates = 1 if i == 0 else cfg.num_estimates
            # estimate loop with fused passes: acc(M_k) → finalize →
            # score(M_{k+1}); score(M_{k+1}) and acc(M_{k+1}) (iteration
            # k+1's E-step) share one corpus pass
            self._accumulate(corpus, alignment, first_pass=False)
            for k in range(num_estimates):
                self.model.finalize()
                if k + 1 < num_estimates:
                    score = self._score_and_accumulate(corpus, alignment)
                else:
                    score = self.calc_am_score(corpus, alignment)
                self.log(f"AM score (accumulate): {score:.6g}")
                self._stat(f"{i} {j} {k} {score:g}")

        if cfg.mixture_path:
            write_mixture_set(f"{cfg.mixture_path}{i}.mix", self.model.to_raw())

    def _resume(self, corpus: Corpus, tables_all: AlignerTables,
                alignment: np.ndarray) -> None:
        """Restart after an interruption: reload the last completed split's
        .mix checkpoint and its alignment dump (or realign from the model
        when no dump was kept)."""
        cfg = self.cfg
        prev = cfg.start_split - 1
        raw = read_mixture_set(f"{cfg.mixture_path}{prev}.mix", self.model.dim)
        self.model = MixtureModel.from_raw(raw, self.model.var_model,
                                           max_approx=self.model.max_approx)
        self.log(f"resumed from {cfg.mixture_path}{prev}.mix "
                 f"({self.model.num_densities()} densities)")
        dump = f"{cfg.alignment_path}{prev}-{cfg.num_aligns - 1}.dump"
        if cfg.alignment_path and os.path.exists(dump):
            states, _w, _m = read_alignment(dump)
            if states.shape[0] != corpus.total_frames:
                raise ValueError(f"alignment dump {dump}: {states.shape[0]} frames != "
                                 f"corpus {corpus.total_frames}")
            alignment[:] = states
            self._align_version += 1
            self.log(f"resumed alignment from {dump}")
        else:
            self._realign(corpus, tables_all, alignment)

    def _finish(self, t_start: float) -> None:
        if self.cfg.training_stats_path:
            with open(self.cfg.training_stats_path, "w") as f:
                f.write("\n".join(self.stats_lines) + "\n")
        # per-phase timer report (reference: Training.cpp:230-234)
        self.log(f"Estimation  took {self.phase_seconds['estimate']:.1f} seconds")
        self.log(f"Alignment   took {self.phase_seconds['align']:.1f} seconds")
        self.log(f"Score comp. took {self.phase_seconds['score']:.1f} seconds")
        self.log(f"Training took {time.perf_counter() - t_start:.1f} seconds")

    def _stat(self, line: str) -> None:
        self.stats_lines.append(line)

    @staticmethod
    def _write_segmentation(path: str, energy: np.ndarray, b1: int, b2: int) -> None:
        """Energy trace + boundary markers for plotting
        (reference: Training.cpp:561-581 .seg format)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as out:
            for idx, e in enumerate(energy):
                out.write(f"{idx} {e}\n")
            out.write(f"\n{b1} -0.1 \n{b1} .15\n")
            out.write(f"\n{b2 - 1} -0.1 \n{b2 - 1} .15\n")
