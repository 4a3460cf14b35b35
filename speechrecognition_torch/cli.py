"""Command-line entry point mirroring the reference ``sietill`` binary —
counterpart of speechrecognition_tpu/cli.py.

Usage: python -m speechrecognition_torch.cli <config.json> [action] [--device cpu|cuda]

Actions (src/sietill/SieTill.cpp:54-243):
  extract-features | train | recognize | train-nn | compute-prior |
  plot-activations | corpus-statistics
``train`` runs the EM trainer in the precision ``train-dtype`` names: f32
(default), f64 or df32 (double-float, the reference's float64 decisions).
``recognize`` scores with the GMM (``feature-scorer`` gmm, the default) or
the hybrid MLP (``nn``: ``model-path``, ``prior-file``, ``prior-scale``,
``context-frames`` and the ``layers`` array) in float32.

The device is explicit and defaults to ``cuda``. When CUDA is asked for and
no card is present the command fails; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import Configuration, ParameterBool, ParameterFloat, ParameterInt, ParameterString
from .corpus import Corpus, CorpusDescription
from .features.frontend import (SignalAnalysisConfig, add_deltas,
                                compute_normalization_stats, extract_features)
from .io import (read_audio_file, read_mixture_set, write_feature_file,
                 write_normalization)
from .lexicon import build_sietill_lexicon
from .models.gmm import MixtureModel, VarianceModel
from .tdp import TdpModel


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
        if scorer_kind not in ("gmm", "nn"):
            print(f"unknown feature scorer: {scorer_kind}", file=sys.stderr)
            return 1
        pooling = VarianceModel.from_string(ParameterString("pooling", "")(config))
        corpus = Corpus.read(description, feature_path, sig_cfg,
                             normalization_path=normalization_path or None)
        tdp = TdpModel.from_config(config, lexicon.silence_state)
        from .search.decoder import Recognizer
        if scorer_kind == "gmm":
            mix_path = ParameterString("load-mixtures-from", "")(config)
            raw = read_mixture_set(mix_path, sig_cfg.n_features_total)
            model = MixtureModel.from_raw(raw, pooling, max_approx=max_approx)
            recognizer = Recognizer(config, lexicon, tdp, model.pack(device=device))
        else:
            from .models.nn import MLP, NNScorer, layer_specs_from_config
            context = ParameterInt("context-frames", 0)(config)
            mlp = MLP(layer_specs_from_config(config),
                      input_dim=sig_cfg.n_features_total * (2 * context + 1), device=device)
            mlp.load(ParameterString("model-path", "")(config))
            prior = NNScorer.load_prior(
                ParameterString("prior-file", "")(config), lexicon.num_states,
                ParameterFloat("prior-scale", 0.0)(config), device=device)
            recognizer = Recognizer(config, lexicon, tdp)
            recognizer.nn_scorer = NNScorer(mlp, prior, context)
        result = recognizer.recognize_corpus(corpus)
        print(f"WER: {result['wer']:.6f}% (S/I/D) "
              f"{result['substitutions']}/{result['insertions']}/{result['deletions']}",
              file=sys.stderr)
        print(f"SER: {result['ser']:.6f}%", file=sys.stderr)
        print(f"Time: {result['time']} seconds", file=sys.stderr)
        print(f"RTF: {result['rtf']}", file=sys.stderr)
        return 0

    if action in ("train-nn", "compute-prior", "plot-activations"):
        from .models.nn import MLP, layer_specs_from_config
        from .train.nn_training import (MiniBatchBuilder, NnTrainer,
                                        compute_prior_from_alignment)
        batch_size = ParameterInt("batch-size", 32)(config)
        corpus = Corpus.read(description, feature_path, sig_cfg,
                             normalization_path=normalization_path or None)
        builder = MiniBatchBuilder.from_config(
            config, corpus, batch_size, lexicon.num_states, lexicon.silence_state)
        if action == "train-nn":
            mlp = MLP(layer_specs_from_config(config), input_dim=builder.feature_size,
                      device=device)
            NnTrainer(config, builder, mlp, log=lambda *a: print(*a, file=sys.stderr),
                      device=device).train()
            return 0
        if action == "plot-activations":
            # forward the FIRST (unshuffled) minibatch through the loaded
            # MLP and dump every layer's activations as raw float32 files;
            # optionally t-SNE one layer colored by the target alignment
            # (reference: SieTill.cpp:152-179 + src/activation-plotting/)
            from .tools.tsne import dump_activations, tsne
            mlp = MLP(layer_specs_from_config(config), input_dim=builder.feature_size,
                      device=device)
            params = mlp.load(ParameterString("model-path", "")(config))
            acts_dir = ParameterString("activations-path", "activations/")(config)
            feats, targets, mask = builder.build_batch(0, cv=False)
            T, B, F = feats.shape
            valid = (np.arange(T)[:, None] < mask[None, :]).reshape(T * B)
            flat = feats.reshape(T * B, F)[valid]
            labels = targets.reshape(T * B, -1)[valid].argmax(axis=1)
            dump_activations(mlp, params, flat, [s.name for s in mlp.specs], acts_dir)
            np.asarray(labels, np.int32).tofile(acts_dir + "/labels.bin")
            print(f"wrote activations for {flat.shape[0]} frames "
                  f"({len(mlp.specs)} layers) to {acts_dir}", file=sys.stderr)
            tsne_plot = ParameterString("tsne-plot", "")(config)
            if tsne_plot:
                from .tools.tsne import plot_tsne
                layer = ParameterString("tsne-layer", mlp.specs[0].name)(config)
                max_frames = ParameterInt("tsne-max-frames", 1000)(config)
                with torch.no_grad():
                    acts = mlp.apply(params, torch.as_tensor(flat[:max_frames], device=device))
                Y = tsne(acts[layer].cpu().numpy().astype(np.float64), perplexity=30.0,
                         device=device)
                plot_tsne(Y, labels[:max_frames], tsne_plot)
                print(f"t-SNE of {layer} → {tsne_plot}", file=sys.stderr)
            return 0
        # compute-prior
        prior_file = ParameterString("prior-file", "")(config)
        prior = compute_prior_from_alignment(builder.alignment, lexicon.num_states)
        with open(prior_file, "w") as f:
            f.write(" ".join(str(p) for p in prior) + " ")
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
