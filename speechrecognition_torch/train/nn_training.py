"""Hybrid-MLP training: minibatch building, epochs, CV, newbob — counterpart
of speechrecognition_tpu/train/nn_training.py.

Replicates src/sietill/NNTraining.cpp:
  * MiniBatchBuilder (::42-200): shuffled train/CV split (`cv-size`),
    (T, B, D) batches with ±context frames (zero outside the sequence),
    one-hot targets from a stored alignment, per-sequence length mask,
    leading/trailing-silence truncation (`max-silence-frames`), optional
    per-batch Welford feature normalization;
  * NnTrainer (::296-430): per-epoch shuffle, forward → frame-error + CE
    loss → backward → SGD/AdaDelta update, CV frame-error, per-epoch model
    save, optional newbob learning-rate halving (<0.5% relative CV gain).

Each step runs on the trainer's device: the flat corpus and the alignment
go to the device once and each step ships only its segments' (base, length)
pairs (DeviceBatcher, gather_batch); the forward and backward passes are
full-float32 matrix products there. The MLP module holds the weights; each
accepted update is written back into it.

As in the reference package, the steps call ``MLP.loss`` without
``max_len``, so a layer's ``weight-decay`` takes no effect in training.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Configuration, ParameterBool, ParameterFloat, ParameterInt, ParameterString
from ..corpus import Corpus
from ..io import read_alignment
from ..models.gmm import _full_f32_matmul, pack_device
from ..models.nn import MLP, AdaDeltaUpdater, SGDUpdater, _leaves


@dataclass
class MiniBatchBuilder:
    corpus: Corpus
    batch_size: int
    num_classes: int
    silence_state: int
    alignment: np.ndarray            # int32 [total_frames]
    context_frames: int = 0
    max_silence_frames: int = 0xFFFFFFFF
    cv_size: float = 0.0
    seed: int = 0x58DBFDD0
    normalize_features_per_batch: bool = False

    def __post_init__(self):
        n = self.corpus.num_segments
        self.rng = np.random.default_rng(self.seed)
        self.num_train_seq = int(n * (1.0 - self.cv_size))
        order = np.arange(n)
        self.rng.shuffle(order)
        self.cv_segments = order[self.num_train_seq:].copy()
        self.train_segments = order[: self.num_train_seq].copy()
        self.max_seq_length = self.corpus.max_seq_length

    @staticmethod
    def from_config(config: Configuration, corpus: Corpus, batch_size: int,
                    num_classes: int, silence_state: int) -> "MiniBatchBuilder":
        target_file = ParameterString("target-file", "")(config)
        states, _w, _m = read_alignment(target_file)
        if states.shape[0] != corpus.total_frames:
            raise ValueError(
                f"alignment frames {states.shape[0]} != corpus {corpus.total_frames}")
        return MiniBatchBuilder(
            corpus=corpus, batch_size=batch_size, num_classes=num_classes,
            silence_state=silence_state, alignment=states,
            context_frames=ParameterInt("context-frames", 0)(config),
            max_silence_frames=ParameterInt("max-silence-frames", 0xFFFFFFFF)(config),
            cv_size=ParameterFloat("cv-size", 0.0)(config),
            seed=ParameterInt("seed", 0x58DBFDD0)(config),
            normalize_features_per_batch=ParameterBool(
                "normalize-features-per-batch", False)(config),
        )

    @property
    def num_train_batches(self) -> int:
        return -(-len(self.train_segments) // self.batch_size)

    @property
    def num_cv_batches(self) -> int:
        return -(-len(self.cv_segments) // self.batch_size)

    @property
    def feature_size(self) -> int:
        return self.corpus.dim * (2 * self.context_frames + 1)

    def shuffle(self) -> None:
        self.rng.shuffle(self.train_segments)

    def _boundaries(self, begin: int, end: int) -> Tuple[int, int]:
        """Truncate leading/trailing silence beyond max_silence_frames
        (NNTraining.cpp:187-200)."""
        a = self.alignment
        init = 0
        while begin + init < end and a[begin + init] == self.silence_state:
            init += 1
        fin = 0
        while end - 1 - fin >= begin and a[end - 1 - fin] == self.silence_state:
            fin += 1
        start = max(init, self.max_silence_frames) - self.max_silence_frames
        stop = (end - begin) - max(fin, self.max_silence_frames) + self.max_silence_frames
        return start, stop

    def build_batch(self, batch_index: int, cv: bool,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (features [T,B,(2k+1)·D], targets one-hot [T,B,C],
        mask lengths int [B])."""
        segs = self.cv_segments if cv else self.train_segments
        ids = segs[batch_index * self.batch_size: (batch_index + 1) * self.batch_size]
        T = self.max_seq_length
        B = self.batch_size
        k = self.context_frames
        D = self.corpus.dim
        feats = np.zeros((T, B, (2 * k + 1) * D), np.float32)
        targets = np.zeros((T, B, self.num_classes), np.float32)
        mask = np.zeros(B, np.int32)
        for i, s in enumerate(ids):
            seq = self.corpus.feature_sequence(s)
            o = int(self.corpus.feature_offsets[s])
            start, stop = self._boundaries(o, o + seq.shape[0])
            stop = start + min(stop - start, T)
            L = stop - start
            mask[i] = L
            win = np.zeros((L, (2 * k + 1) * D), np.float32)
            for delta in range(-k, k + 1):
                # frame t takes features from t+delta, zero outside [start, stop)
                t_lo = max(0, -delta)
                t_hi = L - max(0, delta)
                if t_hi > t_lo:
                    win[t_lo: t_hi, (delta + k) * D: (delta + k + 1) * D] = \
                        seq[start + t_lo + delta: start + t_hi + delta]
            feats[:L, i, :] = win
            states = self.alignment[o + start: o + stop]
            targets[np.arange(L), i, states] = 1.0

        if self.normalize_features_per_batch:
            ml = int(mask.max()) if len(ids) else 0
            valid = (np.arange(ml)[:, None] < mask[None, :])
            rows = feats[:ml][valid]
            mean = rows.mean(axis=0, dtype=np.float64)
            std = rows.std(axis=0, ddof=1, dtype=np.float64)
            feats[:ml][valid] = ((rows - mean) / std).astype(np.float32)
        return feats, targets, mask


class DeviceBatcher:
    """Device-resident minibatch assembly: the flat feature store and the
    target alignment go to ``device`` once; each step ships only per-segment
    metadata (base, length; a few hundred bytes) and gather_batch builds the
    context windows and one-hot targets there. Its batches equal
    MiniBatchBuilder.build_batch's (same silence truncation, zero-padded
    context, masked targets), padded to a bucket of lengths."""

    def __init__(self, builder: MiniBatchBuilder, device,
                 buckets: Tuple[int, ...] = (256, 384, 512, 768, 1024, 1600)):
        self.b = builder
        self.buckets = buckets
        corpus = builder.corpus
        self.flat = torch.as_tensor(corpus.features.astype(np.float32), device=device)
        self.align = torch.as_tensor(builder.alignment.astype(np.int64), device=device)
        # precompute silence-truncated (start, stop) per segment
        n = corpus.num_segments
        self.seg_start = np.zeros(n, np.int64)
        self.seg_len = np.zeros(n, np.int64)
        for s in range(n):
            o = int(corpus.feature_offsets[s])
            L = int(corpus.lengths[s])
            st, sp = builder._boundaries(o, o + L)
            self.seg_start[s] = o + st
            self.seg_len[s] = sp - st

    def bucket(self, length: int) -> int:
        for t in self.buckets:
            if length <= t:
                return t
        return self.buckets[-1]

    def batch_meta(self, batch_index: int, cv: bool):
        """(base int32 [B], lens int32 [B], T) for one shuffled batch."""
        segs = self.b.cv_segments if cv else self.b.train_segments
        ids = segs[batch_index * self.b.batch_size:
                   (batch_index + 1) * self.b.batch_size]
        B = self.b.batch_size
        base = np.zeros(B, np.int64)
        lens = np.zeros(B, np.int64)
        base[: len(ids)] = self.seg_start[ids]
        lens[: len(ids)] = self.seg_len[ids]
        T = self.bucket(int(lens.max()) if len(ids) else self.buckets[0])
        lens = np.minimum(lens, T)
        return base.astype(np.int32), lens.astype(np.int32), T


def gather_batch(flat: torch.Tensor, align: torch.Tensor, base: torch.Tensor,
                 lens: torch.Tensor, T: int, context: int, num_classes: int):
    """Device-side build_batch: returns (feats [T,B,(2k+1)D],
    targets [T,B,C], frame_mask [T,B]) on ``flat``'s device."""
    k = context
    N = flat.shape[0]
    base = base.to(device=flat.device, dtype=torch.long)
    lens = lens.to(device=flat.device, dtype=torch.long)
    t = torch.arange(T, device=flat.device)[:, None]        # [T, 1]
    pos = base[None, :] + t                                 # [T, B]
    frame_mask = (t < lens[None, :]).to(torch.float32)
    cols = []
    for delta in range(-k, k + 1):
        tt = t + delta
        valid = (tt >= 0) & (tt < lens[None, :])
        idx = torch.clamp(pos + delta, 0, N - 1)
        cols.append(flat[idx] * valid[:, :, None])          # [T, B, D]
    feats = torch.cat(cols, dim=2)                          # [T, B, (2k+1)·D]
    states = align[torch.clamp(pos, 0, N - 1)]              # [T, B]
    targets = (torch.nn.functional.one_hot(states, num_classes).to(torch.float32)
               * frame_mask[:, :, None])
    feats = feats * frame_mask[:, :, None]
    return feats, targets, frame_mask


def _tree_where(good: torch.Tensor, new, old):
    if isinstance(new, dict):
        return {k: _tree_where(good, new[k], old[k]) for k in new}
    return torch.where(good, new, old)


def _finite_guard(new_params, new_state, params, opt_state):
    """Skip a poisoned update: if ANY updated parameter is non-finite
    (inf/NaN loss from a blown-up batch), keep the previous parameters
    and updater state. One toxic batch otherwise NaN-poisons the whole
    run irrecoverably (observed with tanh+AdaDelta at full-corpus scale;
    the reference has no equivalent guard and would die the same way —
    this is a robustness extension, not a semantics change: finite updates
    are bit-identical). Decided on the device, with no host round trip."""
    leaves = [v for d in new_params.values() for v in d.values()]
    good = torch.stack([torch.isfinite(v).all() for v in leaves]).all()
    return (_tree_where(good, new_params, params),
            _tree_where(good, new_state, opt_state), good)


def _frame_errors(mlp: MLP, params, feats, targets, frame_mask) -> torch.Tensor:
    hyp = torch.argmax(mlp.log_probs(params, feats), dim=-1)
    ref = torch.argmax(targets, dim=-1)
    return ((hyp != ref) * frame_mask).sum()


class NnTrainer:
    """The train-nn action on ``device`` (the card unless the caller asks
    for the CPU); the MLP module is moved there and trained in place."""

    def __init__(self, config: Configuration, builder: MiniBatchBuilder,
                 mlp: MLP, log=print, device="cuda"):
        self.builder = builder
        self.log = log
        self.device = pack_device(device, "NN trainer")
        self.mlp = mlp.to(self.device)
        self.num_epochs = ParameterInt("num-epochs", 1)(config)
        self.start_epoch = max(1, ParameterInt("start-epoch", 1)(config))
        self.learning_rate = ParameterFloat("learning-rate", 0.001)(config)
        self.output_dir = ParameterString("output-dir", "./models")(config)
        self.stats_path = ParameterString("nn-training-stats-path", "")(config)
        self.method = ParameterString("method", "no")(config)
        self.gradient_check = ParameterBool("gradient-check", True)(config)
        self.seed = ParameterInt("param-init-seed", 498061416)(config)
        upd = ParameterString("updater", "sgd")(config)
        if upd == "sgd":
            self.updater = SGDUpdater(self.learning_rate)
        elif upd == "adadelta":
            self.updater = AdaDeltaUpdater(
                momentum=ParameterFloat("adadelta-momentum", 0.90)(config),
                learning_rate=self.learning_rate)
        else:
            raise ValueError(f"Unknown updater: {upd}")
        self.stats_lines: List[str] = []

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _host_batch(self, b: int, cv: bool):
        """MiniBatchBuilder's batch ``b`` on the device (the gradient check's
        input)."""
        f, t, m = self.builder.build_batch(b, cv=cv)
        frame_mask = (np.arange(f.shape[0])[:, None] < m[None, :]).astype(np.float32)
        return self._tensor(f), self._tensor(t), self._tensor(frame_mask)

    def loss_and_grads(self, params, feats, targets, frame_mask):
        """The training loss on one batch and its gradients (autograd, in
        ``params``' dtype), as ``(loss, {layer: {"W", "b"}})``."""
        names = _leaves(params)
        p = {n: {k: v.detach().requires_grad_(True) for k, v in d.items()}
             for n, d in params.items()}
        with torch.enable_grad(), _full_f32_matmul():
            loss = self.mlp.loss(p, feats, targets, frame_mask)
            g = torch.autograd.grad(loss, [p[n][k] for n, k in names])
        grads: Dict = {n: {} for n in params}
        for (n, k), v in zip(names, g):
            grads[n][k] = v
        return loss.detach(), grads

    def train_step(self, params, opt_state, feats, targets, frame_mask):
        """One update: the loss and its gradients, the frame errors under
        the old parameters, the updater, the finite guard. Returns new
        (params, state, loss, errors, frames), all on the device; changes
        neither ``params`` nor ``opt_state``."""
        loss, grads = self.loss_and_grads(params, feats, targets, frame_mask)
        with torch.no_grad():
            errors = _frame_errors(self.mlp, params, feats, targets, frame_mask)
            new_params, new_state = self.updater.update(params, grads, opt_state)
            new_params, new_state, _good = _finite_guard(
                new_params, new_state, params, opt_state)
        return new_params, new_state, loss, errors, frame_mask.sum()

    def eval_step(self, params, feats, targets, frame_mask):
        with torch.no_grad():
            return _frame_errors(self.mlp, params, feats, targets, frame_mask), frame_mask.sum()

    def train(self) -> Dict:
        rng = np.random.default_rng(self.seed)
        params = self.mlp.init_params(rng)
        if self.start_epoch > 1:
            params = self.mlp.load(f"{self.output_dir}/{self.start_epoch - 1}/")
        opt_state = self.updater.init_state(params)
        batcher = DeviceBatcher(self.builder, self.device)
        k, C = self.builder.context_frames, self.builder.num_classes

        def batch(b: int, cv: bool):
            base, lens, T = batcher.batch_meta(b, cv=cv)
            return gather_batch(batcher.flat, batcher.align, self._tensor(base),
                                self._tensor(lens), T, k, C)

        if self.gradient_check:
            f, t, m = self._host_batch(0, cv=False)
            worst = self.mlp.gradient_check(params, f[:32], t[:32], m[:32], samples=20)
            self.log(f"gradient check max rel dev: {worst:.2e}")

        lr = self.learning_rate
        prev_cv = 0.0
        best_cv, best_params = None, None
        for epoch in range(self.start_epoch, self.num_epochs + 1):
            t0 = time.perf_counter()
            self.builder.shuffle()
            # frame counts summed on the device in float64 (exact integers)
            tot_err = tot_frames = self._tensor(0.0, torch.float64)
            for b in range(self.builder.num_train_batches):
                new_params, opt_state, _loss, err, n = self.train_step(
                    params, opt_state, *batch(b, cv=False))
                self.mlp.set_params(new_params)
                tot_err = tot_err + err
                tot_frames = tot_frames + n
            cv_err = cv_frames = self._tensor(0.0, torch.float64)
            for b in range(self.builder.num_cv_batches):
                err, n = self.eval_step(params, *batch(b, cv=True))
                cv_err = cv_err + err
                cv_frames = cv_frames + n
            train_fer = float(tot_err) / max(1.0, float(tot_frames))
            cv_fer = float(cv_err) / max(1.0, float(cv_frames))
            elapsed = time.perf_counter() - t0
            self.mlp.save(params, f"{self.output_dir}/{epoch}/")
            self.log(f"epoch {epoch}: train FER {train_fer:.4f} cv FER {cv_fer:.4f} "
                     f"({elapsed:.1f}s)")
            self.stats_lines.append(f"{train_fer} # {cv_fer} # {elapsed}")
            if self.method in ("newBob", "newbob-restore"):
                if epoch > 1 and prev_cv > 0 and \
                        (prev_cv - cv_fer) / prev_cv * 100 < 0.5:
                    lr /= 2
                    self.log(f"newbob: halving learning rate to {lr}")
                    if isinstance(self.updater, SGDUpdater):
                        self.updater.learning_rate = lr
                prev_cv = cv_fer
            if self.method == "newbob-restore":
                # divergence rescue (an extension of the reference package;
                # the reference's newbob only adjusts the LR,
                # NNTraining.cpp:417-428): on a serious CV collapse, restore
                # the best epoch's weights and reset the updater accumulators
                if best_cv is None or cv_fer < best_cv:
                    best_cv = cv_fer
                    best_params = {n: {k: v.clone() for k, v in d.items()}
                                   for n, d in params.items()}
                elif cv_fer > best_cv + 0.02:
                    self.log(f"newbob-restore: cv FER {cv_fer:.4f} "
                             f"collapsed vs best {best_cv:.4f} — restoring "
                             f"best weights, resetting updater state")
                    self.mlp.set_params(best_params)
                    opt_state = self.updater.init_state(params)
                    prev_cv = best_cv
        if self.stats_path:
            os.makedirs(os.path.dirname(self.stats_path) or ".", exist_ok=True)
            with open(self.stats_path, "w") as f:
                f.write("Train frame error rate # Cv frame error rate # Time (s)\n")
                f.write("\n".join(self.stats_lines) + "\n")
        return {"params": params, "cv_fer": cv_fer, "train_fer": train_fer}


def compute_prior_from_alignment(alignment: np.ndarray, num_states: int) -> np.ndarray:
    """State frequencies from an alignment (SieTill.cpp:193-213)."""
    counts = np.bincount(alignment, minlength=num_states).astype(np.float64)
    return counts / counts.sum()
