"""Command-line entry point mirroring the reference ``sietill`` binary —
counterpart of speechrecognition_tpu/cli.py.

Usage: python -m speechrecognition_torch.cli <config.json> [action] [--device cpu|cuda]

Actions (src/sietill/SieTill.cpp:54-243):
  extract-features | train | recognize | corpus-statistics
are ported; train-nn, compute-prior, plot-activations and the NN feature
scorer raise NotImplementedError naming their ROADMAP item. ``train`` runs
the EM trainer in the precision ``train-dtype`` names: f32 (default), f64
or df32 (double-float, the reference's float64 decisions).

The device is explicit and defaults to ``cuda``. When CUDA is asked for and
no card is present the command fails; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import Configuration, ParameterBool, ParameterString
from .corpus import Corpus, CorpusDescription
from .features.frontend import (SignalAnalysisConfig, add_deltas,
                                compute_normalization_stats, extract_features)
from .io import (read_audio_file, read_mixture_set, write_feature_file,
                 write_normalization)
from .lexicon import build_sietill_lexicon
from .models.gmm import MixtureModel, VarianceModel
from .tdp import TdpModel

#: actions of the reference package not ported yet, and their ROADMAP item
UNPORTED = {
    "train-nn": "ROADMAP Queue 1 #9: the NN hybrid",
    "compute-prior": "ROADMAP Queue 1 #9: the NN hybrid",
    "plot-activations": "ROADMAP Queue 1 #9: the NN hybrid",
}


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m speechrecognition_torch.cli")
    p.add_argument("config")
    p.add_argument("action", nargs="?", default=None)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("Error: --device cuda, but no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    config = Configuration(args.config)
    action = args.action or ParameterString("action", "")(config)

    if action in UNPORTED:
        raise NotImplementedError(f"action {action} is not ported yet ({UNPORTED[action]})")

    feature_path = ParameterString("feature-path", "")(config)
    normalization_path = ParameterString("normalization-path", "")(config)
    max_approx = ParameterBool("max-approx", True)(config)

    lexicon = build_sietill_lexicon()
    description = CorpusDescription.from_config(config, lexicon)
    sig_cfg = SignalAnalysisConfig.from_config(config)

    if action == "extract-features":
        audio_path = ParameterString("audio-path", "")(config)
        audio_format = ParameterString("audio-format", "sph")(config)
        all_rows = []
        for i, seg in enumerate(description.segments):
            print(f"Processing ({i + 1}): {seg.name}", file=sys.stderr)
            audio = read_audio_file(f"{audio_path}{seg.name}.{audio_format}")
            cepstra = extract_features(audio, sig_cfg)
            write_feature_file(f"{feature_path}{seg.name}.mm2", cepstra)
            all_rows.append(add_deltas(cepstra, sig_cfg))
        if normalization_path:
            mean, std = compute_normalization_stats(np.concatenate(all_rows, axis=0))
            write_normalization(normalization_path, mean, std)
        return 0

    if action == "train":
        from .train.em import Trainer, TrainerConfig
        pooling = VarianceModel.from_string(ParameterString("pooling", "")(config))
        corpus = Corpus.read(description, feature_path, sig_cfg,
                             normalization_path=normalization_path or None)
        tdp = TdpModel.from_config(config, lexicon.silence_state)
        model = MixtureModel(dim=sig_cfg.n_features_total, num_mixtures=lexicon.num_states,
                             var_model=pooling, max_approx=max_approx)
        dtype_name = ParameterString("train-dtype", "f32")(config)
        dtype = {"f64": torch.float64, "df32": "df32"}.get(dtype_name, torch.float32)
        trainer = Trainer(TrainerConfig.from_config(config), lexicon, model, tdp,
                          max_approx=max_approx, dtype=dtype, device=device,
                          log=lambda *a: print(*a, file=sys.stderr))
        trainer.train(corpus)
        return 0

    if action == "recognize":
        scorer_kind = ParameterString("feature-scorer", "gmm")(config)
        if scorer_kind == "nn":
            raise NotImplementedError(
                "feature-scorer=nn is not ported yet (ROADMAP Queue 1 #9: the NN hybrid)")
        if scorer_kind != "gmm":
            print(f"unknown feature scorer: {scorer_kind}", file=sys.stderr)
            return 1
        pooling = VarianceModel.from_string(ParameterString("pooling", "")(config))
        corpus = Corpus.read(description, feature_path, sig_cfg,
                             normalization_path=normalization_path or None)
        tdp = TdpModel.from_config(config, lexicon.silence_state)
        from .search.decoder import Recognizer
        mix_path = ParameterString("load-mixtures-from", "")(config)
        raw = read_mixture_set(mix_path, sig_cfg.n_features_total)
        model = MixtureModel.from_raw(raw, pooling, max_approx=max_approx)
        recognizer = Recognizer(config, lexicon, tdp, model.pack(device=device))
        result = recognizer.recognize_corpus(corpus)
        print(f"WER: {result['wer']:.6f}% (S/I/D) "
              f"{result['substitutions']}/{result['insertions']}/{result['deletions']}",
              file=sys.stderr)
        print(f"SER: {result['ser']:.6f}%", file=sys.stderr)
        print(f"Time: {result['time']} seconds", file=sys.stderr)
        print(f"RTF: {result['rtf']}", file=sys.stderr)
        return 0

    if action == "corpus-statistics":
        # Tools/CorpusStatistics parity: segment/frame/word counts
        corpus = Corpus.read(description, feature_path, sig_cfg,
                             normalization_path=normalization_path or None)
        n_words = sum(len(o) for o in corpus.orths)
        hours = corpus.total_audio_seconds / 3600.0
        lens = corpus.lengths
        print(f"segments:       {corpus.num_segments}")
        print(f"frames:         {corpus.total_frames}")
        print(f"audio:          {corpus.total_audio_seconds:.1f} s ({hours:.2f} h)")
        print(f"running words:  {n_words}")
        print(f"frames/segment: min {int(lens.min())} median "
              f"{int(np.median(lens))} max {int(lens.max())}")
        counts = np.bincount(
            np.concatenate([np.asarray(o, dtype=np.int64) for o in corpus.orths])
            if n_words else np.zeros(0, np.int64),
            minlength=lexicon.num_words)
        for w in range(lexicon.num_words):
            print(f"  {lexicon.orth[w]:>10s}: {int(counts[w])}")
        return 0

    print(f"Error: unknown action {action}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
