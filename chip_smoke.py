#!/usr/bin/env python3
"""Smoke run of the PyTorch port's recognition and training paths on one
CUDA card.

    python3 chip_smoke.py

Drives speechrecognition_torch's recognizers on the card — the f32 "pallas"
path (Corpus.read → MixtureModel.from_raw → pack(method="pallas") →
Recognizer.recognize_corpus), the production double-float path
(pack_df() → Recognizer(dtype="df32")), the NN hybrid (Recognizer with an
NNScorer), the tree search (Recognizer with search-type=tree), the bigram
and word-conditioned tree searches (decode_batch_bigram, decode_batch_wcts),
the streaming recognizers and the LVCSR tier's 1-best decode
(tools.an4_system.decode: the int8 quantized scorer, the linear-lexicon scan
and its device traceback), each at full width — its EM trainer (Trainer(..., dtype="df32")
.train), its NN trainer (NnTrainer.train), its char-RNN LM
(CharRnnLm.train) and the Sprint tier's system at AN4 width
(tools.an4_system.build_system, load_corpus, train_model, the
allophone-state alignments and Baum-Welch passes), and holds each hand-written
kernel against its plain PyTorch version on the same tensors:

  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from speechrecognition_torch/csrc;
  3. kernel A (Mahalanobis scores) at the path's shape N=32768, J=1696,
     dim=25 and at a ragged shape: ≤ 1e-6 relative to the plain version
     over active slots, ≤ 3e-6 relative to a float64 centered computation;
     its fused entry (each mixture's minimum over its D slots, capped) at
     the same shapes (D=16 and the ragged iter-2.mix, D=4): bit-equal to the
     capped minimum of the unfused kernel on the same tensors, ≤ 1e-6
     relative to its plain version, ≤ 3e-6 to float64; the unfused kernel
     at dims 100 and 128; times of the unfused kernel + amin + clamp against
     the fused kernel, in turns, beside the fused kernel's bound and FP32
     issue limit;
  4. kernel B (word-loop Viterbi chunk) at B=1024, T=320 on real acoustic
     scores, over two chunks with carry: bit-equal to the plain version;
     its instance, residency (blocks per SM) and waves, its device time
     against the plain version in turns, and its staircase (device time at
     B = 132, 264, 528, 924 and 1024);
  5. the golden demo run: iter-2.mix on the 35 demo utterances reproduces
     tests/fixtures/demo_recognition.json (WER 19.587629 %, S/I/D 4/14/1),
     through kernel A's fused entry and kernel B;
  6. full width: bench/model.mix (106 mixtures × 16 densities) on the demo
     utterances repeated to one batch of 1024, decoded through the kernels
     (the main path; launch counts are read from this run: the fused entry
     of kernel A, never the unfused one, and kernel B) and through the
     plain versions: equal transcripts, each equal to the 35-utterance run;
     one torch.profiler run (device busy share, top device operations);
  7. kernel C (double-float GMM scores, min over densities and cap) at
     N=32768, J=1696 and at a ragged N with iter-2.mix (J=424): equal hi and
     lo words to its plain version; max error against float64 printed; then
     on tables whose magnitudes span 1e-6 .. 1e6 and on frames equal to
     bench/model.mix's mu.hi: the same bits as the plain version, whose
     exact product is Dekker's where the kernel's is one FMA (csrc/df.cuh);
  8. kernel D (double-float Viterbi chunk) and the float64 kernel B at
     B=1024, T=320 on real scores of both models, two chunks with carry:
     bit-equal to their plain versions;
  9. times of kernels C, D and f64 B against their plain versions, in turns,
     beside each kernel's bound (and kernel C's FP32 issue limit, also at
     the instruction count of Dekker's product; kernel D's FP32 issue limit
     and the instance that ran); kernel D's and f64 B's residency, the waves
     their 1024-utterance launch takes and their times at B = 132, 264, 528,
     924 and 1024 (a staircase shows the waves); kernel B's shape sweep
     (B 4, T 40, both types, two chunks with carry, bit-equal) over its warp
     instance's edges, 1 x 2 to 32 x 32, and past them, 33 x 8 and 4 x 33;
 10. golden demo runs in df32 and f64 on iter-2.mix: 35/35 transcripts,
     WER 19.587629 %, S/I/D 4/14/1, through the new kernels;
 11. full width, df32 (the production path; launch counts are read from this
     run): bench/model.mix on the 1024-utterance batch through kernels C and D
     and through the plain versions (cut to PLAIN_CUT utterances past
     PLAIN_BUDGET_S projected seconds): equal transcripts, each equal to the
     35-utterance df32 run; the count that differ from the f64 decode;
 12. the CLI's recognize on a temporary demo config with --device cuda:
     exit 0 and the golden WER line;
 13. kernels E (alignment DP chunk, f32 and f64), F (its double-float twin)
     and G (backtrack) at B=256, C=320, A=70 on real bench/model.mix
     scores, three chunks with carry: bit-equal to their plain versions,
     times in turns beside the instance that ran; kernel E's warp instance
     timed at A = 32 to 128 (every warp count) in three rounds; F's wide
     instance on a synthetic batch with A=160, and its first design (the
     block instance, forced): bit-equal over two chunks, timed in turns with
     the plain version and with each other; G per launch and per step beside its bound and the chain's
     floor (a timed chain of dependent shared-memory loads, a kernel this
     script builds for that alone), and on tests/torch_df_tables.py's edge cases plus
     Tp 3,000 at A 1,025: bit-equal;
 14. kernel H (double-float E-step) over the 1024-utterance corpus's sorted
     blocks: counts bit-equal, sums within 1e-12 relative, two launches
     bit-identical, times in turns beside its bound and the scoring's FP32
     issue limit;
 15. the golden demo trainer (the C++ trainer's recipe) in df32 and f64 on
     the card: its ten AM-score lines within 1e-4, alignment-2-0.dump and
     iter-2.mix as the fixtures; the f32 trainer through the kernels and
     through the plain versions: equal alignments;
 16. full width, df32 (the training main path; launch counts are read from
     this run): the 1024-utterance corpus with the full-corpus recipe cut
     to 4 splits, 1 alignment, 2 estimates; phase seconds, seconds per
     second of audio, peak memory, one torch.profiler run (device busy
     share, top device operations); the plain run (cut to PLAIN_TRAIN_CUT
     utterances past PLAIN_TRAIN_BUDGET_S): equal stats lines, final
     alignment and density counts; the f64 trainer's differing frames and
     one torch.profiler run of it (kernel E's device time and launches);
 17. the CLI's train on a temporary demo config with train-dtype df32 and
     --device cuda: exit 0 and the oracle's iter-2.mix;
 18. every scan whose lattice lives in device scratch (past 1,024 slots or
     positions): kernels B (f32, f64) and D at W*P = 1,056 and 24,000, E
     (f32, f64) and F at A = 1,025 and 3,000, on a small synthetic batch
     (B 4, T 40): bit-equal to their plain versions over two chunks, timed
     in turns; each has its own entry in the kernels line, whose launches
     are the wrapper's SCRATCH_LAUNCHES counted over the main paths' runs
     (checked to be 0: no SieTill shape needs scratch);
 19. the NN decode (bench/nn_run/model.json: 1x150 tanh, context 2, prior
     scale 1.2, TDP 4-0-30, word penalty 105, threshold 200): the 35 demo
     utterances reproduce tests/fixtures/demo_recognition_nn.json; the
     card's NN scores within NN_AM_ATOL + NN_AM_RTOL*|ref| of the same
     network in float64 on the same features (the CPU port's printed); kernel B (f32 and f64) on the MLP's scores
     at B=1024, two chunks with carry: bit-equal to its plain version, timed
     in turns; the MLP's GEMMs per 32,768 frames beside their bound; full
     width (the 1024-utterance batch; launch counts are read from these
     runs) in f32 and f64 through kernel B: transcripts equal to the
     35-utterance run, wall time, RTF, peak memory, one torch.profiler run
     each (busy share, top device operations, the GEMMs' share beside their
     bound), the f64 transcripts that differ from f32;
 20. the NN trainer at full width: bench/nn_tanh/train_nn_restore.config
     (1x150 tanh, context 2, batch 32, AdaDelta 0.9, cv-size 0.1,
     newbob-restore) cut to NN_TRAIN_EPOCHS epochs with its float64 gradient
     check, on the 1024 utterances with alignment-2-0.dump's targets
     repeated: seconds per epoch, frames per second, train and CV FER, peak
     memory, one profiled epoch; the same recipe with the port on this
     machine's CPU: FERs within NN_FER_ATOL, weights within NN_PARAM_RTOL;
 21. the CLI's NN actions with --device cuda on temporary demo configs:
     train-nn (models/1/, models/2/ in the raw layout, the stats file),
     compute-prior (the text of --device cpu), recognize with
     feature-scorer=nn (the fixture's WER line), plot-activations (output
     rows sum to 1); t-SNE of 1,000 frames of hidden activations on the
     card, TSNE_STEPS of its steps against the CPU port's within
     TSNE_STEP_RTOL;
 22. the native corpus loader built afresh with g++: the demo corpus's
     features and offsets bit-equal to the pure-Python path;
 23. kernel I (the prefix-tree scan) in f32 and f64 on bench/model.mix's
     scores of the 1024-utterance batch (T 960, N 212): bit-equal to its
     plain version, timed in turns beside its bound; the instance its C
     entry chooses (the owner instance, 4 nodes a lane) and the first design
     (the block instance, forced) bit-equal and timed in turns, with their
     registers, spills, residency, waves and barriers a frame (the owner
     instance must be the faster, or the C entry's choice is wrong); the golden demo tree
     runs (Recognizer with search-type=tree, f32 "pallas" and f64); the
     full-width tree Recognizer in both types (launch counts are read from
     these runs): transcripts equal to the plain run and to the 35-utterance
     run, and the count that differ from phase 6's word-loop decode (not a
     gate); the CLI's recognize with search-type=tree --device cuda: the
     golden WER line;
 24. kernel J (the bigram word-loop scan) at full width with the demo bigram
     LM (tests/fixtures/demo_bigram_lm.json), f32 and f64: bit-equal, timed
     in turns with its plain version; its instance (the warp instance at
     SieTill's 12 x 24), residency, waves and barriers a frame, and the first
     design (the block instance, forced) bit-equal and timed in turns with
     it; decode_batch_bigram at full width (its launch counts);
 25. kernel K (WCTS) at full width with the demo bigram LM, f32 pruned, with
     lookahead, with state_limit 48 and 10^6, and f64 pruned: carry and
     outputs bit-equal, timed in turns with the plain version and with the
     first design (the block instance, forced; also bit-equal); the
     instance (the owner instance at SieTill's 13 x 212), residency, waves
     and barriers a frame of both; a sweep of the owner instance's contexts
     a thread (8, 16) on the pruned scans; the profiled decode's
     kernel K device time; decode_batch_wcts at full width in each
     configuration (its launch counts; state_limit 10^6 changes no
     transcript; f64 WCTS equals kernel J's f64 decode); on the 35 demo
     utterances, f32 and f64: every output option (lattice word ends,
     statistics, transparent silence, lookahead, state limit) bit-equal over
     two chunks with carry, uniform-LM WCTS gives the golden transcripts,
     WCTS equals the bigram decode pruned and unpruned (a gate in f64), the
     lattices' best paths equal the 1-best; kernels I, J and K in device
     scratch (a 9,499-node tree, on kernel I's block instance, a 200 x 24
     lattice, 145,122 WCTS slots; B 4, T 40): bit-equal, timed; no search
     main path kept its lattice in scratch;
 26. streaming with 1,024 streams fed 160 frames at a time, partial()
     after each feed: OnlineRecognizer in f32 "pallas", f64 and df32 equals
     the offline Recognizer, OnlineWctsRecognizer (chunk 64, lookahead)
     equals decode_batch_wcts; commit and partial latencies;
 27. the batched feature front end (features.extract_features_batch) on the
     card in float64 on 1,024 synthetic utterances (from a seed) with the
     full-width batch's frame counts: finite, [1024, T, 12], within 1e-9
     relative of the CPU port on the same samples; its time beside its
     products' bound (float64 at the tensor cores' 67 TFLOP/s);
 28. kernel L (the forward-backward scan) at B=256, T=960, A=70 on
     bench/model.mix scores of the 1024-utterance corpus's segment
     automata, float32 and float64: the instance its C entry chooses (two
     chains, a forward and a backward warp an utterance, then the posterior
     pass) and the first design (a warp an utterance, forced) bit-equal to
     the plain version, gamma and log_z, and timed in turns (the chains
     must be the faster, or the C entry's choice is wrong), beside the
     bound, the plain version's time, per frame, registers, residency and
     waves and the backward chain's buffer; the split: each chain alone, and
     the device time of the chains' launch and of the posterior pass; a
     sweep at B=4, T=40 over every instance edge (tests/torch_fb_tables.py's
     L_INSTANCES: 1 to 3 positions a lane on a warp a chain, the wide chains
     at 2 to 4 positions a lane and 2 to 8 warps a chain up to 1,024, the
     block instance in device scratch at 1,025), bit-equal, the first design
     too;
 29. Baum-Welch at full width: baum_welch_posteriors and
     accumulate_baum_welch over the 1024 utterances in batches of 256,
     float64 with an "mxu" pack and float32 with a "pallas" pack (kernel
     A's fused and unfused entries and kernel L's two chains on the path;
     launch counts read from these runs): gamma, log_z, the statistics and
     the best paths bit-equal to the run with L's plain version; the frames
     whose posterior best path differs from the forced alignment (not a
     gate);
 30. MMI and MPE at full width, tools/mpe_run.py's recipe (bench/model.mix,
     model.mix.json's pooling, TDP, word penalty and threshold, E 2, tau
     50, posterior threshold 5, batch 256, float32 statistics; the
     numerator alignment from the df32 trainer's realignment): one
     MpeTrainer.iterate(compute_after=True) and one profiled
     EbwTrainer.iterate on a fresh model, seconds split into lattices, arc
     alignment, accumulation, update and criterion, launches of J, E and
     G, peak memory; the first 32 utterances through the kernels and
     through their plain versions: identical lattices and arc alignments,
     equal statistics and updated parameters; the 35 demo utterances in
     float64 (iter-2.mix): the card's MPE and MMI iterations within 1e-9 of
     the CPU port's;
 31. the LVCSR tier at AN4 width (bench/an4/am.mix: 501 mixtures, 4,623
     densities padded to 16 a mixture, dim 45, global pooling; a seeded
     lexicon of 130 words of whole phones, 3 to 30 positions, and a
     3-state silence with classes of its own; the AN4 config's TDP block
     through TransitionModel.from_config; a seeded bigram ARPA file under
     build/lvcsr/ through an4_system.build_lm_matrices at lm-scale 6,
     word-exit 30, sil-exit 10; 130 utterances of seeded words, 35,570
     frames near their states' means): the quantized packs (k-means on
     the host timed), kernel O without and with preselection (32 of 256
     clusters) on every chunk, its tensor-core design and its first design
     (forced) torch.equal to the plain version, the share of backoff
     cells, a 32,768-frame launch timed in turns (plain, new, first,
     first, new, plain; the phase fails unless the tensor-core design is
     the faster) beside its bound, registers and blocks an SM; O
     past the first design's limits (a synthetic pooled model at dim 200,
     without preselection and with 512 clusters, the selection in device
     scratch) torch.equal and timed; torch._int_mm's [32768, 48] x
     [48, J] int8 product as the library's context;
 32. kernel M on the int8 scores (float32) and on float64 "mxu" scores,
     pruned at 200 (all 130 utterances; the warp instance and the first
     design timed in turns with the plain version: plain, new, first,
     first, new, plain; the phase fails unless the warp instance is the
     faster) and unpruned (the first PLAIN_LIN_CUT): the eight
     outputs of both designs torch.equal; their registers and blocks an
     SM; kernel N's words, its warp design's and its first design's
     (forced), torch.equal on all 130 in both types and on
     tests/torch_linear_tables.py's forced starts (a NaN first, in the
     middle and last in the word or silence ends; ties across lane
     boundaries; -0.0 against +0.0; W 1 to 300; walks past 128 words); N's
     two designs timed in turns (plain, new, first, first, new, plain) by
     device time and by events, the phase failing unless the warp design is
     the faster, beside its bound over this run's walk steps and its chain
     floor (a timed chase of dependent loads through L2, built under
     build/chase/), with the words walked and the longest walk; M with its state
     in device scratch (299 words x 30 positions, the first design),
     bit-equal and timed; the main paths (launch counts read from these
     runs): an4_system.decode linear-q8, linear-q8-preselect and linear,
     pruned at 200 (WER, RTF, peak memory), and decode_batch_linear_lvcsr
     in float32 and float64, three wall times each with their RTF over the
     355.7 s; the same four decodes with the first designs of M and O
     forced: the same transcripts;
 33. the silence-copy oracle of tests/test_linear_lvcsr.py on the card
     (7 seeds; the extended lexicon through kernel J, the linear decode
     through kernels M and N); an4_system.decode linear and f32 (the
     exact WCTS, kernel K, transparent silence) unpruned: the count of
     transcripts that differ (not a gate);
 34. the char-RNN LM (lm/char_rnn.py; torch ops, no hand kernel) at the
     reference's widths (hidden 100, windows of 25, lr 0.1) on README.md's
     characters: three float64 train_steps on the card within 1e-10 of the
     CPU port's on the same parameters; CharRnnLm.train for
     CHAR_RNN_STEPS steps in float32 (the mean loss of the last 20 steps
     under half the first 20's) and 200 sampled characters inside the
     vocabulary, with milliseconds a train_step and a character.
 35. the lattice tier's one device path: an Flf network (search/flf_network.py)
     whose recognizer node decodes the SieTill demo system (iter-2.mix, 106
     mixtures at dim 25, the golden TDPs and word penalty, am-threshold 200)
     on the card, rec -> best and rec -> CN-builder -> CN-decoder, over the
     35 demo segments at the default device (the main path; J's launches
     are read from this run and added to decode_scan_bigram[f64]'s): 35 of
     35 best paths equal the golden hyps; each lattice equals the CPU port's
     node's (arcs and words exactly, scores within FLF_SCORE_RTOL); the
     profiler sees kernel J once a segment (in a fresh process: late in
     this script it records fewer launches than were made); the CN
     decodes' word errors within the best paths' + max(2, 2 %); ms a
     segment (host clock, median of three passes after a warm-up) and J's
     device time within it;
 36. the Sprint tier's alignment and training path at AN4 width, on the
     seeded files of tests/torch_sprint_tables.py (written under
     build/sprint36/: a Bliss lexicon of 131 entries and corpus of 130
     segments, a CART tree of 501 classes, the AN4 config's TDP block, an
     MFCC cache of dim 16 and 35,570 frames, an LDA to 45 dimensions and the
     three Flow files of cache.lda.flow): tools.an4_system.build_system,
     load_corpus (the Flow network) and train_model in df32 (3 splits, 2
     aligns, 3 estimates, threshold 300; launch counts read from this run,
     its phase split), sprint/mm_io's round trip, aligner_tables_for_orths
     over the 130 orthographies (chains of up to about 300 positions, so
     kernels E, F and L take their wide instances), align_batch_chunked in
     f32 "pallas" (A fused, E, G), f64 "mxu" (E, G) and df32 (C, F, G), and
     baum_welch_posteriors in f64 "mxu" and f32 "pallas" (L); each kernel's
     last recorded calls held against its plain version on the same inputs
     (bit-equal; A fused within A_REL_TOL relative; H's counts bit-equal
     and sums within 1e-12), timed in turns beside its bound; E's (f32
     and f64), F's and L's first designs (their block instances, forced)
     bit-equal on the same calls and timed in turns with the wide instances
     (E's in turns with the plain version too; F also on the df32
     alignment's NaN rows), with us a frame and registers; wall seconds
     of every step and the host share of the df32 alignment and the
     Baum-Welch pass (profiler, in a fresh process, in a window that
     recorded every launch the wrappers counted).

 37. the parallel paths (speechrecognition_torch/parallel/): at world size 1
     over NCCL, on phase 25's cell (bench/model.mix, 1,024 utterances, T
     960, the demo bigram LM, 13 contexts x 212 nodes), in float32 and
     float64: the eager route (mesh.run_frames_eager: kernel P, two launches
     a frame and one more) with P held against its plain version on its own
     launches at six frames (P1 and P2) and its books, bkps and preds equal
     to kernel K's decode on the same scores; then the main path,
     wcts_sharded, whose frames replay from a CUDA graph in chunks
     (mesh.FRAME_CHUNK; its launches read from this run, 2T + 1), equal to
     kernel K's decode and the eager route; both routes' wall time in turns
     against kernel K's warm scan, the graph route at chunks of 4-32 frames
     (float32); a frame's two launches of P's owner instance and its forced
     first design (the block instance) timed in turns with the plain
     version on the path's middle-frame state, P1 and P2 by device time,
     beside the bound, with blocks an SM and registers; the first design
     held against the plain version there; the collectives a frame by
     events; decode_sharded, and
     recognize_corpus_sharded in f32 "pallas" (A fused, B) and df32 (C, D)
     equal to the single card's tables and transcripts, accumulate_sharded
     equal to accumulate_chunk; then two rank processes on the one card over
     the host-staged gloo transport (tests/torch_parallel_ranks.py, 128
     utterances, T 960): wcts_sharded equal to kernel K's decode in both
     types, the sharded recognizers, decode and accumulation equal to the
     single card's, on both ranks; the collectives' host time a frame;
 38. the tools on the card: sprint_tools lattice-processor ... network (the
     Flf recognizer node, kernel J) over the 35 demo segments, best paths
     equal to the CPU port's and golden; partition.wer_vs_threshold at
     thresholds 25 and 200 (f64) equal to the CPU port's, golden at 200;
 39. models/gmm.py's aligned_density_scores_df bit-equal to the CPU port's
     and em_score_and_accumulate_corpus (df32 equal; f32 score within 1e-6)
     over the demo frames and golden alignment;
 40. one NaN acoustic score (tests/torch_nan_tables.py: utterance 0 of 4,
     frame 20 of 40) through kernels B (f32, f64) and D at 12 x 24, 33 x 8
     and 44 x 24 (warp, block and scratch instances; D with the NaN in the
     lattice's last cell unpruned and in an inner cell pruned), J at 12 x 24
     and 33 x 8 and its first design, E at A 70, 303 and 1,025 (the carry
     compared at the NaN's frame), I at 212 and 1,025 nodes and its first
     design, K on SieTill pruned and with every option (the owner instance
     and the block instance forced) and M and its first design: every output
     bit-equal to the plain version's on the card (NaN equal to NaN), or
     the run fails.

Kernels B, D, G and N are timed by their device time (torch.profiler), since
B and D's wrappers synchronise on a range check and a call timed by events
also holds its host work; the others by events around their calls (the
search tier's wrappers I, J and K check their tables once, where they are
built, and do not synchronise).

Every kernel's time is printed beside its bound: the larger of the bytes it
must move over 3.35 TB/s and the operations its function needs (an FMA as
two) over 67 TFLOP/s in float32 or 34 TFLOP/s in float64 (kernel O's int8
operations over the tensor cores' 1,979 TOP/s); for the sequential scans
also per frame. Every check that fails raises, so the
script exits non-zero. It exits non-zero without a result when no CUDA
device is present. The last line of standard output is
{"ok": true, "device": {...}}; the line before it is the per-kernel JSON
summary (launches on the main paths, error against the plain version, ms,
plain_ms, bound_ms, bound_by, library_ms).
"""

import ctypes
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIX = REPO / "tests" / "fixtures"
SETTINGS = {"am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
            "max-recognition-runs": 10 ** 9}
FULL_BATCH = 1024
A_REL_TOL = 1e-6
A_F64_TOL = 3e-6
#: double-float scores against float64: tests/test_decode_demo.py's bound
C_F64_REL = 2.0 ** -38
C_F64_ABS = 2.0 ** -30
#: seconds of plain full-width df32 decode past which the plain comparison
#: is cut to the first PLAIN_CUT utterances
PLAIN_BUDGET_S = 10.0
PLAIN_CUT = 128
#: the trainer's alignment batch (train-batch-size)
TRAIN_BATCH = 256
#: projected seconds of the plain full-width df32 trainer past which its
#: comparison is cut to the first PLAIN_TRAIN_CUT utterances
PLAIN_TRAIN_BUDGET_S = 60.0
PLAIN_TRAIN_CUT = 128
#: NVIDIA's H100 SXM data sheet: HBM3 bandwidth, and the FP32 and FP64 peaks
#: outside the tensor cores (an FMA counted as two operations)
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
FP64_OPS_S = 34e12
#: the FP64 tensor cores' peak (the same data sheet), which cuBLAS's float64
#: products reach
FP64_MMA_OPS_S = 67e12
#: the int8 tensor cores' dense peak (the same data sheet)
INT8_OPS_S = 1979e12
#: FP32 instructions the card issues per second: 132 SMs x 128 lanes x
#: 1.98 GHz (the clock at which 67 TFLOP/s counts an FMA as two operations)
FP32_ISSUE_S = 132 * 128 * 1.98e9
#: operations per unit of work, counted from the kernels' sources: a float
#: add, multiply, compare or min is 1 and an FMA 2; a double-float add 20
#: (df.cuh add: two two_sums of 6, two fast_two_sums of 3, two adds), a
#: double-float compare or minimum 3
DF_ADD, DF_CMP = 20, 3
#: kernel A, per frame and density slot and dimension: sub, mul, FMA (its
#: operations, and its FP32 instructions)
A_ELEMENT_OPS = 4
A_ELEMENT_INSTR = 3
#: the frame of phase 40's NaN in kernel E's inputs (its first chunk ends
#: there, so the carry it returns holds the NaN row)
NAN_E_FRAME = 20
#: the longest automaton of kernels E's and F's warp instances (their wide
#: instances past it)
F_WARP_A = 128
#: the synthetic automaton length that takes kernel F's wide instance (its
#: block instance, the first design, forced beside it)
F_BLOCK_A = 160
#: kernels C and H, per frame, density and dimension: add_f 10, two mul of 9
#: instructions each (1 product, 1 FMA counted twice, 3 for the cross terms,
#: 1 add, 3 for fast_two_sum), add 20; per density: half 2, two adds, minimum
C_ELEMENT_OPS = 10 + 2 * 10 + DF_ADD
C_ELEMENT_INSTR = 10 + 2 * 9 + DF_ADD
C_ELEMENT_INSTR_DEKKER = C_ELEMENT_INSTR + 2 * 14     # two_prod by splitting: 16, not 2
C_DENSITY_OPS = 2 + 2 * DF_ADD + DF_CMP
#: what the function needs, not how a kernel reduces. Kernels B and D, per
#: utterance, frame and (word, position) slot: five adds (three candidates,
#: the emission, the renormalisation), five compares in the score type (two
#: candidates, the entry, one step of the minimum over the W*P slots, the
#: prune) and two guards on the hi word (the BIG cap, the BIG/2 test); per
#: utterance and frame, the W-1 compares of the word-end minimum and two
#: guards, less the one compare the W*P-slot minimum does not need. The
#: entries' two adds in 2 of 24 slots are left out.
B_SLOT_OPS = 5 + 5 + 2
D_SLOT_OPS = 5 * DF_ADD + 5 * DF_CMP + 2
#: kernel D's FP32 instructions, counted from its warp instance's source
#: (csrc/decode_scan_df.cu): per slot and frame exactly the operations above
#: (slot_step, the minimum, renorm); per lane and frame the entry's two adds
#: (every lane forms one), the word end's renormalisation (an add, a guard, a
#: prune compare) and its cap guard, the dead-row guard and four key adds,
#: plus one compare per warp of the utterance's fold
D_SLOT_INSTR = D_SLOT_OPS
D_LANE_INSTR = 3 * DF_ADD + DF_CMP + 7
#: kernels E and F, per utterance, frame and position: five adds, four
#: compares in the score type (two candidates, one step of the row minimum,
#: the prune) and two guards on the hi word (BIG/2 before and after the
#: renormalisation); the guard on the row minimum, once per row and frame,
#: stands for the compare its minimum does not need
E_POS_OPS = 5 + 4 + 2
F_POS_OPS = 5 * DF_ADD + 4 * DF_CMP + 2
#: kernel H's float64 sums, per live row and dimension (x*m, x*x*m, two adds),
#: and per live row (its score, w, the total)
H_ROW_DIM_F64 = 5
H_ROW_F64 = 4
#: the C++ trainer's AM-score trajectory on the demo corpus (tests/test_em_demo.py)
ORACLE_AM_SCORES = [32.9885, 32.5804, 32.1673, 31.9418, 31.9074, 31.8869, 31.4152, 31.3187,
                    31.2697, 31.2383]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of one call, over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILED = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def log_profile(tag, prof, seconds):
    """The device busy share of a profiled run and its top device operations."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in events)
    busy = (f"{busy_us / 1e6 / seconds:.4f} ({busy_us / 1e3:.1f} ms of device time in "
            f"{seconds:.4f} s)" if busy_us > 0 else "not measured (no device time recorded)")
    log(f"{tag} profiled run: device busy share {busy}")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"{tag}   {dev_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}")


def scan_frame_ops(W, cmp):
    """Kernels B and D, per utterance and frame, besides the slots' ops."""
    return (W - 1) * cmp + 2 - cmp


def bound(nbytes, fp32=0.0, fp64=0.0, fp64_mma=0.0, int8=0.0):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over their peaks
    (``fp64_mma``: float64 matrix-product operations, at the tensor cores'
    peak; ``int8``: int8 operations, at the tensor cores' int8 peak)."""
    mem = nbytes / HBM_BYTES_S
    ops = (fp32 / FP32_OPS_S + fp64 / FP64_OPS_S + fp64_mma / FP64_MMA_OPS_S
           + int8 / INT8_OPS_S)
    return max(mem, ops) * 1e3, ("bytes" if mem >= ops else "operations")


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda", "source": f"speechrecognition_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def f_warps(A):
    """Warps per utterance of kernel F's warp or wide instance for A
    positions; -1 for its block instance (the row in device scratch): the
    choice of its C entry."""
    from speechrecognition_torch.ops import _native
    return _native.load().sr_align_fwd_df_warps(A)


def f_positions(A):
    """Positions a lane of kernel F's instance for A positions: 1 (the warp
    instance), 2-4 (the wide instance), 0 (the block instance)."""
    from speechrecognition_torch.ops import _native
    return _native.load().sr_align_fwd_df_positions(A)


#: the scans' kernels whose machine code phase 2 counts
SASS_KERNELS = ("decode_scan_warp_kernel", "decode_scan_df_warp_kernel",
                "decode_scan_df_block_kernel", "align_fwd_warp_kernel", "align_fwd_wide_kernel",
                "align_fwd_df_warp_kernel",
                "align_fwd_df_wide_kernel", "align_backtrack_kernel", "bigram_scan_warp_kernel",
                "wcts_owner_kernel", "tree_scan_owner_kernel", "tree_scan_kernel",
                "fb_chain_kernel", "fb_wide_chain_kernel",
                "fb_posterior_kernel", "fb_warp_kernel", "linear_scan_warp_kernel",
                "linear_scan_kernel")


def log_sass_counts(lib):
    """Static instruction counts of the scans' kernels in the built library
    (cuobjdump -sass): all instructions, and the float adds (FADD, DADD)
    among them; the frame loop is unrolled, so these count several frames
    and the set-up. Printed as not measured where cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("[2] machine code of the scans: not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        m = re.search(r"\d+([a-z_]+_kernel)(I\w*?E)?E", fn)
        if not m or m.group(1) not in SASS_KERNELS:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        adds = sum(o.split(".")[0] in ("FADD", "DADD") for o in ops)
        log(f"[2] {m.group(1)}{m.group(2) or ''}: {len(ops)} instructions, {adds} float adds")


def instance(query, *shape):
    """The instance a scan's C entry chooses for ``shape``, as the library's
    ``query`` reports it: warps per utterance (kernels E and F) or positions
    a lane (kernels B and D) of the warp instance; 0 for the block instance
    with its lattice in shared memory, -1 in device scratch."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    v = getattr(lib, query)(*shape)
    if query in ("sr_align_fwd_warps", "sr_align_fwd_df_warps") and v > 0 \
            and shape[0] > F_WARP_A:
        positions = getattr(lib, query.replace("_warps", "_positions"))(*shape)
        return f"wide instance, {v} warps an utterance, {positions} positions a lane"
    if query == "sr_forward_backward_instance" and lib.sr_forward_backward_warps(*shape) > 1:
        return (f"wide chains, {lib.sr_forward_backward_warps(*shape)} warps a chain, {v} "
                f"positions a lane")
    if v <= 0:
        return f"block instance, lattice in {'device scratch' if v < 0 else 'shared memory'}"
    if query == "sr_wcts_scan_instance":
        return f"owner instance, {v} contexts a thread"
    unit = ("position(s) a lane" if query in ("sr_decode_scan_instance", "sr_decode_scan_df_instance",
                                               "sr_decode_scan_bigram_instance",
                                               "sr_forward_backward_instance")
            else "contexts a thread" if query == "sr_wcts_scan_instance"
            else "warp(s) per utterance")
    return f"warp instance, {v} {unit}"


def waves(blocks, per_sm):
    """Waves of a launch of ``blocks`` blocks at ``per_sm`` blocks per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-blocks // (per_sm * sms)) if per_sm > 0 else None


def scan_bound(nb, T, S, W, P, word, df=False):
    """Kernel B or D over one chunk: the scores read once, the carry in and
    out, the per-frame outputs; the operations per slot and frame."""
    nbytes = nb * T * S * word + 2 * nb * W * P * (word + 4) + 2 * nb * word + 3 * T * nb * 4
    slots, frames = nb * T * W * P, nb * T
    if df:
        return bound(nbytes, fp32=slots * D_SLOT_OPS + frames * scan_frame_ops(W, DF_CMP))
    ops = slots * B_SLOT_OPS + frames * scan_frame_ops(W, 1)
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def align_bound(nb, C, A, word, df=False):
    """Kernel E or F over one chunk: the scores read once, the jumps written,
    the carry in and out, the TDP table and valid mask; the operations per
    position and frame."""
    nbytes = nb * C * A * (word + 1) + 2 * nb * A * word + nb * A * (3 * word + 1)
    ops = nb * C * A * (F_POS_OPS if df else E_POS_OPS)
    return bound(nbytes, **({"fp32": ops} if word == 4 or df else {"fp64": ops}))


def designs_in_turns(plain, new, first, reps_plain, reps):
    """Time plain, new design, first design, first design, new design,
    plain; return (new ms, first ms, plain ms, all six)."""
    p1 = cuda_ms(plain, reps_plain)
    n1 = cuda_ms(new, reps)
    f1 = cuda_ms(first, reps)
    f2 = cuda_ms(first, reps)
    n2 = cuda_ms(new, reps)
    p2 = cuda_ms(plain, reps_plain)
    return (n1 + n2) / 2, (f1 + f2) / 2, (p1 + p2) / 2, [p1, n1, f1, f2, n2, p2]


def graph_ms(fn, reps):
    """Mean device milliseconds of one call of ``fn`` whose launches are
    captured ``reps`` times in a CUDA graph and replayed (no host work
    between them), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, 3) / reps


def in_turns(plain, kernel, reps_plain, reps_kernel):
    """Time plain, kernel, kernel, plain; return (kernel ms, plain ms, all)."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2]


#: idle seconds at each end of a profiled window, and profiled windows
#: tried before device_ms gives up on a complete record
PROFILE_PAD_S = 0.02
PROFILE_TRIES = 3


def device_ms(fn, reps, key, exclude=None, bare=None):
    """Mean device milliseconds of a launch of the kernels whose name holds
    ``key`` (and not ``exclude``) over ``reps`` calls of ``fn``, after a
    warm-up (torch.profiler): the kernel alone. Events around a call also
    time its wrapper's host work wherever the device waits for it (kernels
    B and D's wrappers synchronise on a range check of their tables).

    The profiler has recorded fewer launches of kernel G than were made (4,
    5 or 9 of 10, late in runs of this script on an H100), and never did in
    110 windows of G alone, with and without its plain version run before;
    the cause is not known. A mean is therefore taken only from a
    window that recorded every launch: the window is padded with idle time
    at both ends, and a window that misses launches is logged with the
    device records it did hold and tried again, up to PROFILE_TRIES times.
    Then ``bare`` (a call that launches the kernel alone, its operands
    prepared once) is timed by events around ``reps`` back-to-back launches,
    and that figure is returned and logged as such; without ``bare``, ``fn``
    itself is timed so, its wrapper's host work included (an upper bound),
    and logged as such. The same miss has been seen on kernel B (4 of 5
    launches recorded in each of three windows of phase 18)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        ms, n = kernel_device_ms(prof, key, exclude)
        if n == reps:
            return ms / n
        held = [(e.key[:48], e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        log(f"[profiler] window {attempt + 1} recorded {n} of {reps} launches of {key}; "
            f"its device records: {held}")
    if bare is None:
        ms = cuda_ms(fn, reps)
        log(f"[profiler] {key}: {ms:.4f} ms a call by events around {reps} calls to its wrapper "
            f"(host work included), in place of its device time")
        return ms
    ms = cuda_ms(bare, reps)
    log(f"[profiler] {key}: {ms:.4f} ms a launch by events around {reps} back-to-back bare "
        f"launches, in place of its device time")
    return ms


def g_bare(final_hi, aut_len, jumps, feat_len, states_tbl, T, tie_pruned=True):
    """A call that launches kernel G alone on align_backtrack's arguments,
    its operands prepared once (no allocation or conversion per call)."""
    from speechrecognition_torch.ops import _native
    dev = jumps.device
    Tp, B, A = jumps.shape
    check(jumps.data_ptr() % 16 == 0, "kernel G's jumps start on a 16-byte boundary")
    ints = [t.to(torch.int32).contiguous() for t in (aut_len, feat_len, states_tbl)]
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    final_pos = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _native.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        _native.check(lib.sr_align_backtrack(
            final_hi.data_ptr(), ints[0].data_ptr(), jumps.data_ptr(), ints[1].data_ptr(),
            ints[2].data_ptr(), states.data_ptr(), final_pos.data_ptr(), B, A, Tp, int(T),
            int(bool(tie_pruned)), dev.index, stream), "kernel G")

    return launch


def kernel_in_turns(plain, kernel, reps_plain, reps_kernel, key, exclude=None, bare=None):
    """in_turns with the kernel's device time: plain (events), kernel (its
    device time, profiler), kernel, plain. Returns (kernel ms, plain ms, all
    four, ms of a call to the wrapper by events)."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = device_ms(kernel, reps_kernel, key, exclude, bare)
    k2 = device_ms(kernel, reps_kernel, key, exclude, bare)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2], cuda_ms(kernel, reps_kernel)


def demo_setup():
    """The SieTill lexicon, the 35-utterance demo corpus, the decoder's TDPs
    and settings, and iter-2.mix and bench/model.mix on the host."""
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.corpus import Corpus, CorpusDescription
    from speechrecognition_torch.features.frontend import SignalAnalysisConfig
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.tdp import TdpModel
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    check(corpus.num_segments == 35, "demo corpus has 35 utterances")
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    iter2 = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    bench = gmm.MixtureModel.from_raw(read_mixture_set(str(REPO / "bench" / "model.mix"), 25),
                                      gmm.VarianceModel.NO_POOLING, max_approx=True)
    return lex, corpus, tdp, Configuration(SETTINGS), iter2, bench


def card_name():
    """The card's name and power limit as nvidia-smi gives them (printed)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    return smi.splitlines()[0].strip()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from speechrecognition_torch.corpus import Corpus
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native, mahalanobis as maha
    from speechrecognition_torch.search import decoder as dec
    check("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. the card ------------------------------------------------------------
    card = card_name()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _native.load()
    log(f"[2] kernels: {_native.library_path().relative_to(REPO)} "
        f"(nvcc {_native.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s)")
    kernel_name = ""
    for line in _native.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel_name = line.split("'")[1]
        elif ("ptxas info" in line and "Used" in line
              or "spill" in line and " 0 bytes spill stores" not in line):
            log(f"    {kernel_name[:72]}: {line.strip()}")

    log_sass_counts(_native.library_path())

    lex, corpus, tdp, config, iter2, bench = demo_setup()
    pack_iter2 = iter2.pack(method="pallas", device=dev)
    pack_bench = bench.pack(method="pallas", device=dev)

    # -- 3. kernel A against its plain version -----------------------------------
    def f64_tables(model):
        mu, _a, _c, active = maha.pack_to_mahalanobis(model)
        S, D = active.shape
        mu64 = np.zeros((S * D, model.dim))
        a64 = np.zeros((S * D, model.dim))
        c64 = np.zeros(S * D)
        for s in range(S):
            for d, (mi, vi) in enumerate(model.mixtures[s]):
                if active[s, d]:
                    j = s * D + d
                    mu64[j], a64[j] = model.means[mi], 0.5 * model.vars_inv[vi]
                    c64[j] = model.norm[vi] - model.mean_weights_log[mi]
        return ([torch.as_tensor(v, device=dev) for v in (mu64, a64, c64)],
                torch.as_tensor(active.reshape(-1), device=dev))

    a_err = {}
    for label, model, pack, n in (("main", bench, pack_bench, gmm.AM_CHUNK),
                                  ("ragged", iter2, pack_iter2, 1000)):
        x = torch.as_tensor(np.resize(corpus.features, (n, 25)), device=dev)
        got = maha.mahalanobis_scores(x, pack.mu, pack.a, pack.c)
        ref = maha.mahalanobis_scores_reference(x, pack.mu, pack.a, pack.c)
        (mu64, a64, c64), active = f64_tables(model)
        exact = maha.mahalanobis_scores_reference(x.double(), mu64, a64, c64)
        torch.cuda.synchronize()
        g = got[:, active].double()
        r = ref[:, active].double()
        e = exact[:, active]
        rel = ((g - r).abs() / (1 + r.abs())).max().item()
        rel64 = ((g - e).abs() / (1 + e.abs())).max().item()
        rel64_plain = ((r - e).abs() / (1 + e.abs())).max().item()
        abs_err = (g - r).abs().max().item()
        inactive_equal = torch.equal(got[:, ~active], ref[:, ~active])
        log(f"[3] kernel A {label} N={n} J={pack.mu.shape[0]} dim=25: "
            f"max rel vs plain {rel:.3e}, max abs vs plain {abs_err:.3e}, "
            f"max rel vs f64 {rel64:.3e} (plain vs f64 {rel64_plain:.3e}), "
            f"inactive slots equal {inactive_equal}")
        check(tuple(got.shape) == (n, pack.mu.shape[0]), "kernel A output shape")
        check(bool(torch.isfinite(got).all()), "kernel A output finite")
        check(rel <= A_REL_TOL, f"kernel A vs plain {rel} > {A_REL_TOL}")
        check(rel64 <= A_F64_TOL, f"kernel A vs f64 {rel64} > {A_F64_TOL}")
        check(inactive_equal, "kernel A inactive slots")
        a_err[label] = abs_err

        # the fused entry on the same tensors
        D = pack.density_cap
        S = pack.num_mixtures
        fused = maha.mahalanobis_min_scores(x, pack.mu, pack.a, pack.c, D)
        fused_ref = maha.mahalanobis_min_scores_reference(x, pack.mu, pack.a, pack.c, D)
        expect = torch.clamp(got.reshape(n, S, D).amin(dim=-1), max=gmm.MIN_SCORE_INIT)
        exact_min = torch.where(active[None, :], exact, torch.inf).reshape(n, S, D).amin(-1)
        exact_min = exact_min.clamp(max=gmm.MIN_SCORE_INIT)
        torch.cuda.synchronize()
        bit_equal = torch.equal(fused.view(torch.int32), expect.view(torch.int32))
        f = fused.double()
        rel_m = ((f - fused_ref.double()).abs() / (1 + fused_ref.double().abs())).max().item()
        rel64_m = ((f - exact_min).abs() / (1 + exact_min.abs())).max().item()
        log(f"[3] kernel A fused {label} N={n} S={S} D={D}: bit-equal to the capped minimum "
            f"of the unfused kernel {bit_equal}; max rel vs plain {rel_m:.3e}, max rel vs f64 "
            f"{rel64_m:.3e}")
        check(tuple(fused.shape) == (n, S), "fused kernel A output shape")
        check(bit_equal, f"fused kernel A differs from the minimum of the unfused one ({label})")
        check(rel_m <= A_REL_TOL, f"fused kernel A vs plain {rel_m} > {A_REL_TOL}")
        check(rel64_m <= A_F64_TOL, f"fused kernel A vs f64 {rel64_m} > {A_F64_TOL}")
        a_err[f"fused {label}"] = (f - fused_ref.double()).abs().max().item()
    del got, ref, exact, fused, fused_ref, expect, exact_min

    # the generic instance at the dims past the first design's limit of 64
    for n, j, dim in ((4100, 424, 100), (4100, 424, 128)):
        rng = np.random.default_rng(dim)
        xr, mur, ar = (torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=dev)
                       for sh in ((n, dim), (j, dim), (j, dim)))
        ar = ar.abs() + 0.1
        cr = torch.as_tensor(rng.uniform(10.0, 40.0, size=j).astype(np.float32), device=dev)
        got = maha.mahalanobis_scores(xr, mur, ar, cr)
        ref = maha.mahalanobis_scores_reference(xr, mur, ar, cr)
        torch.cuda.synchronize()
        rel = ((got.double() - ref.double()).abs() / (1 + ref.double().abs())).max().item()
        log(f"[3] kernel A at dim={dim} N={n} J={j}: max rel vs plain {rel:.3e}")
        check(rel <= A_REL_TOL, f"kernel A at dim {dim} vs plain {rel} > {A_REL_TOL}")
    del xr, mur, ar, cr, got, ref

    x = torch.as_tensor(np.resize(corpus.features, (gmm.AM_CHUNK, 25)), device=dev)
    a_ms, a_plain_ms, a_all = in_turns(
        lambda: maha.mahalanobis_scores_reference(x, pack_bench.mu, pack_bench.a, pack_bench.c),
        lambda: maha.mahalanobis_scores(x, pack_bench.mu, pack_bench.a, pack_bench.c), 5, 20)
    n_a, j_a = x.shape[0], pack_bench.mu.shape[0]
    a_bound = bound(4 * (n_a * 25 + 2 * j_a * 25 + j_a + n_a * j_a),
                    fp32=n_a * j_a * (A_ELEMENT_OPS * 25 + 1))
    log(f"[3] kernel A time at N={n_a} J={j_a}: kernel {a_ms:.4f} ms, "
        f"plain {a_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in a_all)}); bound {a_bound[0]:.4f} ms "
        f"({a_bound[1]}) on {card}")
    S_a, D_a = pack_bench.num_mixtures, pack_bench.density_cap
    args_a = (x, pack_bench.mu, pack_bench.a, pack_bench.c)
    m_ms, m_plain_ms, m_all = in_turns(
        lambda: maha.mahalanobis_min_scores_reference(*args_a, D_a),
        lambda: maha.mahalanobis_min_scores(*args_a, D_a), 5, 20)
    u_ms, f_ms, uf_all = in_turns(
        lambda: maha.mahalanobis_min_scores(*args_a, D_a),
        lambda: torch.clamp(maha.mahalanobis_scores(*args_a).reshape(n_a, S_a, D_a).amin(-1),
                            max=gmm.MIN_SCORE_INIT), 20, 20)
    m_bound = bound(4 * (n_a * 25 + 2 * j_a * 25 + j_a + n_a * S_a),
                    fp32=n_a * j_a * (A_ELEMENT_OPS * 25 + 1) + n_a * S_a * (D_a - 1))
    m_issue = (n_a * j_a * (A_ELEMENT_INSTR * 25 + 1) + n_a * S_a * D_a) / FP32_ISSUE_S * 1e3
    log(f"[3] fused kernel A time at N={n_a} S={S_a} D={D_a}: kernel {m_ms:.4f} ms, plain "
        f"{m_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in m_all)}); bound {m_bound[0]:.4f} ms ({m_bound[1]}), "
        f"FP32 issue limit {m_issue:.4f} ms at {A_ELEMENT_INSTR} instructions per element "
        f"and dim on {card}")
    log(f"[3] unfused kernel A + amin + clamp {u_ms:.4f} ms against fused kernel A "
        f"{f_ms:.4f} ms, {u_ms / f_ms:.2f}x (fused, unfused, unfused, fused: "
        f"{', '.join(f'{v:.4f}' for v in uf_all)}) on {card}")
    X = pack_bench.features_expanded(x)
    with gmm._full_f32_matmul():
        mm_ms = cuda_ms(lambda: torch.mm(X, pack_bench.P), 20)
    log(f"[3] context for kernel A, a different function: the one-call quadratic "
        f"expansion [x^2, x, 1] @ P (torch.mm, full float32; ~1e-4 cancellation, so it "
        f"fails kernel A's 3e-6 gate) {mm_ms:.4f} ms at N={n_a} J={j_a} on {card}")
    del X

    # -- 4. kernel B against its plain version -----------------------------------
    big = repeat_corpus(corpus, FULL_BATCH, Corpus)
    rec_bench = dec.Recognizer(config, lex, tdp, pack_bench, dtype=torch.float32)
    T = rec_bench._bucket(big.max_seq_length)
    check(T == 960, f"full batch bucket {T} != 960")
    feats = dec.DeviceCorpus(big, dev).batch(list(range(FULL_BATCH)), T)
    lens = torch.as_tensor(big.lengths, dtype=torch.int32, device=dev)
    tables = rec_bench.tables
    targs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
        tables.tdp_within, tables.entry_pen))
    chunk = dec.DECODE_CHUNK
    b_abs = 0.0
    for label, pack in (("bench/model.mix", pack_bench), ("iter-2.mix", pack_iter2)):
        ams = [gmm.am_scores(pack, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
               .reshape(FULL_BATCH, chunk, -1).contiguous() for c in range(2)]
        carry_k = carry_p = None
        b_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan(ams[c], lens, *targs, 200.0, prune=True,
                                             carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_reference(ams[c], lens, *targs, 200.0,
                                                       prune=True, carry_in=carry_p,
                                                       t0=c * chunk)
            torch.cuda.synchronize()
            for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"),
                                  (*carry_k, *out_k), (*carry_p, *out_p)):
                same = k.dtype == p.dtype and torch.equal(k, p)
                b_equal &= same
                if k.is_floating_point():
                    b_abs = max(b_abs, (k.double() - p.double()).abs().max().item())
                if not same:
                    log(f"[4] kernel B chunk {c}: {name} differs")
        log(f"[4] kernel B B={FULL_BATCH} T={chunk} S=106 W=12 P=24 on {label} scores, "
            f"2 chunks with carry: bit-equal {b_equal}, max abs {b_abs:.3e}; "
            f"distinct best words over the 2 chunks: "
            f"{torch.unique(out_k[1]).numel()} (chunk 2)")
        check(b_equal, f"kernel B is not bit-equal to its plain version on {label} scores")
    b_ms, b_plain_ms, b_all, b_call = kernel_in_turns(
        lambda: dec.decode_scan_reference(ams[0], lens, *targs, 200.0, prune=True, t0=0),
        lambda: dec.decode_scan(ams[0], lens, *targs, 200.0, prune=True, t0=0), 2, 10,
        "decode_scan", "decode_scan_df")
    W, P = tables.state_table.shape
    S_b = ams[0].shape[2]
    b_bound = scan_bound(FULL_BATCH, chunk, S_b, W, P, 4)
    b_res = _native.load().sr_decode_scan_residency(W, P, 0)
    b_inst = instance("sr_decode_scan_instance", W, P)
    log(f"[4] kernel B time at B={FULL_BATCH} T={chunk} ({b_inst}): kernel "
        f"{b_ms:.4f} ms (device time), plain {b_plain_ms:.4f} ms (plain, kernel, kernel, "
        f"plain: {', '.join(f'{v:.4f}' for v in b_all)}); a call to the wrapper {b_call:.4f} "
        f"ms (events); bound {b_bound[0]:.4f} ms "
        f"({b_bound[1]}); per frame {b_ms / chunk * 1e3:.3f} us; residency {b_res} blocks "
        f"per SM, {waves(FULL_BATCH, b_res)} wave(s) on {card}")
    b_staircase(dec, _native, ams[0], lens, targs, W, P, card, f64=False)
    del ams, feats, carry_k, carry_p, out_k, out_p
    torch.cuda.empty_cache()

    # -- 5. golden demo run --------------------------------------------------------
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    rec_iter2 = dec.Recognizer(config, lex, tdp, pack_iter2, dtype=torch.float32)
    maha.mahalanobis_min_scores.LAUNCHES = dec.decode_scan.LAUNCHES = 0
    maha.mahalanobis_scores.LAUNCHES = 0
    res = rec_iter2.recognize_corpus(corpus, batch_size=35)
    counts = (maha.mahalanobis_min_scores.LAUNCHES, dec.decode_scan.LAUNCHES,
              maha.mahalanobis_scores.LAUNCHES)
    mism = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
    sid = [res["substitutions"], res["insertions"], res["deletions"]]
    log(f"[5] golden iter-2.mix: WER {res['wer']:.6f} % SER {res['ser']:.6f} % "
        f"S/I/D {sid[0]}/{sid[1]}/{sid[2]}, {len(mism)} mismatches of 35, "
        f"launches A fused {counts[0]} B {counts[1]}, A unfused {counts[2]}")
    check(not mism, f"golden transcripts differ at {mism}")
    check(abs(res["wer"] - golden["corpus"]["wer"]) < 1e-5, "golden WER")
    check(abs(res["ser"] - golden["corpus"]["ser"]) < 1e-9, "golden SER")
    check(sid == golden["corpus"]["sid"], "golden S/I/D")
    check(counts[0] > 0 and counts[1] > 0, "golden run did not launch both kernels")
    check(counts[2] == 0, "the max-approximation decode launched the unfused kernel A")

    # -- 6. full width: the main path -------------------------------------------------
    hyps35 = rec_bench.recognize_corpus(corpus, batch_size=35)["hyps"]
    rec_bench.warmup(big, batch_size=FULL_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    maha.mahalanobis_min_scores.LAUNCHES = maha.mahalanobis_scores.LAUNCHES = 0
    dec.decode_scan.LAUNCHES = dec.decode_scan.SCRATCH_LAUNCHES = 0
    res = rec_bench.recognize_corpus(big, batch_size=FULL_BATCH)
    launches = {"mahalanobis_min_scores": maha.mahalanobis_min_scores.LAUNCHES,
                "mahalanobis_scores": maha.mahalanobis_scores.LAUNCHES,
                "decode_scan": dec.decode_scan.LAUNCHES,
                "decode_scan in scratch": dec.decode_scan.SCRATCH_LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.profiler.profile(activities=PROFILED) as prof:
        res_prof = rec_bench.recognize_corpus(big, batch_size=FULL_BATCH)
    log_profile("[6]", prof, res_prof["time"])
    check(res_prof["hyps"] == res["hyps"], "the profiled f32 decode changed a transcript")
    del prof, res_prof
    with mock.patch.object(maha, "mahalanobis_min_scores", maha.mahalanobis_min_scores_reference), \
            mock.patch.object(maha, "mahalanobis_scores", maha.mahalanobis_scores_reference), \
            mock.patch.object(dec, "decode_scan", dec.decode_scan_reference):
        res_plain = rec_bench.recognize_corpus(big, batch_size=FULL_BATCH)
    check(res["num_decoded"] == res_plain["num_decoded"] == FULL_BATCH, "full batch decoded")
    diff = [s for s in range(FULL_BATCH) if res["hyps"][s] != res_plain["hyps"][s]]
    vs35 = [s for s in range(FULL_BATCH) if res["hyps"][s] != hyps35[s % 35]]
    log(f"[6] full width bench/model.mix, {FULL_BATCH} utterances "
        f"({res['audio_seconds']:.1f} s audio, padded to {T} frames): "
        f"kernel-vs-plain transcript differences {len(diff)}, "
        f"differences from the 35-utterance run {len(vs35)}; WER {res['wer']:.6f} %")
    log(f"[6] decode through the kernels: {res['time']:.4f} s, RTF {res['rtf']:.3e}; "
        f"through the plain versions: {res_plain['time']:.4f} s, RTF {res_plain['rtf']:.3e}; "
        f"peak device memory {peak / 2 ** 20:.1f} MiB; launches {launches}; on {card}")
    check(not diff, f"kernel and plain transcripts differ at {diff[:10]}")
    check(not vs35, f"full-batch transcripts differ from the 35-utterance run at {vs35[:10]}")
    check(launches["mahalanobis_min_scores"] > 0 and launches["decode_scan"] > 0,
          f"main path skipped a kernel: {launches}")
    check(launches["mahalanobis_scores"] == 0, "the f32 main path launched the unfused kernel A")

    f32_launches = launches
    wordloop_hyps = res["hyps"]
    from speechrecognition_torch.ops import doublefloat as dfm
    del pack_bench, pack_iter2, rec_bench, rec_iter2, res_plain
    torch.cuda.empty_cache()

    # -- 7. kernel C against its plain version -----------------------------------
    packdf_bench = bench.pack_df(device=dev)
    packdf_iter2 = iter2.pack_df(device=dev)
    c_err = {}
    for label, model, packdf, n in (("main", bench, packdf_bench, gmm.AM_CHUNK),
                                    ("ragged", iter2, packdf_iter2, 4133)):
        x = torch.as_tensor(np.resize(corpus.features, (n, 25)), device=dev)
        got = gmm.am_scores_df(packdf, x)
        ref = gmm.am_scores_df_reference(packdf, x)
        (mu64, a64, c64), active = f64_tables(model)
        exact = maha.mahalanobis_scores_reference(x.double(), mu64, a64, c64)
        exact = torch.where(active[None, :], exact, torch.inf)
        exact = exact.reshape(n, model.num_mixtures, -1).amin(-1).clamp(max=gmm.MIN_SCORE_INIT)
        torch.cuda.synchronize()
        equal = torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo)
        g64 = got.hi.double() + got.lo.double()
        err64 = (g64 - exact).abs()
        excess = (err64 - (exact.abs() * C_F64_REL + C_F64_ABS)).max().item()
        c_err[label] = (g64 - (ref.hi.double() + ref.lo.double())).abs().max().item()
        log(f"[7] kernel C {label} N={n} J={packdf.mu.hi.shape[0]} S={packdf.num_mixtures} "
            f"dim=25: hi and lo equal to plain {equal}; vs f64 max abs "
            f"{err64.max().item():.3e}, max rel {(err64 / exact.abs()).max().item():.3e}, "
            f"worst excess over |ref|*2^-38+2^-30 {excess:.3e}")
        check(tuple(got.hi.shape) == (n, packdf.num_mixtures), "kernel C output shape")
        check(bool(torch.isfinite(got.hi).all() & torch.isfinite(got.lo).all()),
              "kernel C output finite")
        check(equal, f"kernel C differs from its plain version ({label})")
        check(excess <= 0, f"kernel C vs f64 beyond the bound ({label})")
    del got, ref, exact, g64, err64

    # the FMA product of df.cuh against the plain version's Dekker product:
    # magnitudes 1e-6 .. 1e6 across the dimensions, and frames equal to a
    # density's mu.hi (diff = -mu.lo), on synthetic and real tables
    tables_mod = tables_module("torch_df_tables")
    wide, x_wide = tables_mod.wide_magnitude_pack_df(106, 16, 25, seed=4, n=4133, device=dev)
    J_b = packdf_bench.mu.hi.shape[0]
    x_hit = packdf_bench.mu.hi[(torch.arange(4133, device=dev) * 7) % J_b].contiguous()
    for label, packdf, x in (("wide-magnitude tables", wide, x_wide),
                             ("bench/model.mix, x == mu.hi", packdf_bench, x_hit)):
        got = gmm.am_scores_df(packdf, x)
        ref = gmm.am_scores_df_reference(packdf, x)
        torch.cuda.synchronize()
        equal = (torch.equal(got.hi.view(torch.int32), ref.hi.view(torch.int32))
                 and torch.equal(got.lo.view(torch.int32), ref.lo.view(torch.int32)))
        log(f"[7] kernel C on {label}, N={x.shape[0]} J={packdf.mu.hi.shape[0]}: hi and lo "
            f"bits equal to plain (Dekker product) {equal}")
        check(equal, f"kernel C differs from its plain version on {label}")
    del wide, x_wide, x_hit, got, ref

    # -- 8. kernel D and f64 kernel B against their plain versions -------------------
    rec_df = dec.Recognizer(config, lex, tdp, packdf_bench, dtype="df32")
    feats = dec.DeviceCorpus(big, dev).batch(list(range(FULL_BATCH)), T)
    lens = torch.as_tensor(big.lengths, dtype=torch.int32, device=dev)
    tables = rec_df.tables
    largs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state))
    df_tabs = (dfm.from_f64(tables.tdp_within, dev), dfm.from_f64(tables.entry_pen, dev))
    d_abs = b64_abs = 0.0
    # bench/model.mix last: its scores are the ones timed in phase 9
    for label, model, packdf in (("iter-2.mix", iter2, packdf_iter2),
                                 ("bench/model.mix", bench, packdf_bench)):
        chunks_df = []
        for c in range(2):
            a = gmm.am_scores_df(packdf, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
            chunks_df.append(dfm.DF(a.hi.reshape(FULL_BATCH, chunk, -1),
                                    a.lo.reshape(FULL_BATCH, chunk, -1)))
        carry_k = carry_p = None
        d_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan_df(chunks_df[c], lens, *largs, *df_tabs, 200.0,
                                                prune=True, carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_df_reference(
                chunks_df[c], lens, *largs, *df_tabs, 200.0, prune=True,
                carry_in=carry_p, t0=c * chunk)
            torch.cuda.synchronize()
            flat_k = (carry_k[0].hi, carry_k[0].lo, carry_k[1], carry_k[2].hi, carry_k[2].lo,
                      *out_k)
            flat_p = (carry_p[0].hi, carry_p[0].lo, carry_p[1], carry_p[2].hi, carry_p[2].lo,
                      *out_p)
            for name, k, p in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo", "score",
                                   "word", "bkp_t"), flat_k, flat_p):
                same = k.dtype == p.dtype and torch.equal(k, p)
                d_equal &= same
                if k.is_floating_point():
                    d_abs = max(d_abs, (k.double() - p.double()).abs().max().item())
                if not same:
                    log(f"[8] kernel D chunk {c}: {name} differs")
        log(f"[8] kernel D B={FULL_BATCH} T={chunk} on {label} df32 scores, 2 chunks with "
            f"carry: bit-equal {d_equal} (hi, lo, carry and outputs), max abs {d_abs:.3e}; "
            f"distinct best words in chunk 2: {torch.unique(out_k[1]).numel()}")
        check(d_equal, f"kernel D is not bit-equal to its plain version on {label} scores")

        pack64 = model.pack(dtype=torch.float64, device=dev)
        ams64 = [gmm.am_scores(pack64, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
                 .reshape(FULL_BATCH, chunk, -1).contiguous() for c in range(2)]
        targs64 = (*largs[:4], torch.as_tensor(tables.tdp_within, device=dev),
                   torch.as_tensor(tables.entry_pen, device=dev))
        carry_k = carry_p = None
        b64_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan(ams64[c], lens, *targs64, 200.0, prune=True,
                                             carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_reference(ams64[c], lens, *targs64, 200.0,
                                                       prune=True, carry_in=carry_p,
                                                       t0=c * chunk)
            torch.cuda.synchronize()
            for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"),
                                  (*carry_k, *out_k), (*carry_p, *out_p)):
                same = k.dtype == p.dtype and torch.equal(k, p)
                b64_equal &= same
                if k.is_floating_point():
                    b64_abs = max(b64_abs, (k - p).abs().max().item())
                if not same:
                    log(f"[8] f64 kernel B chunk {c}: {name} differs")
        log(f"[8] f64 kernel B B={FULL_BATCH} T={chunk} on {label} float64 scores, 2 chunks "
            f"with carry: bit-equal {b64_equal}, max abs {b64_abs:.3e}")
        check(carry_k[0].dtype == torch.float64, "f64 kernel B carries float64")
        check(b64_equal, f"f64 kernel B is not bit-equal to its plain version on {label}")

    # -- 9. times of C, D and f64 B against their plain versions ---------------------
    x = torch.as_tensor(np.resize(corpus.features, (gmm.AM_CHUNK, 25)), device=dev)
    c_ms, c_plain_ms, c_all = in_turns(
        lambda: gmm.am_scores_df_reference(packdf_bench, x),
        lambda: gmm.am_scores_df(packdf_bench, x), 1, 10)
    n_c, S_c, D_c = x.shape[0], packdf_bench.num_mixtures, packdf_bench.density_cap
    J_c = S_c * D_c
    elements = n_c * J_c * 25
    c_bound = bound(4 * n_c * 25 + 8 * (2 * J_c * 25 + 2 * J_c) + 8 * n_c * S_c,
                    fp32=elements * C_ELEMENT_OPS + n_c * J_c * C_DENSITY_OPS)
    c_issue = (elements * C_ELEMENT_INSTR + n_c * J_c * C_DENSITY_OPS) / FP32_ISSUE_S * 1e3
    c_issue_dekker = (elements * C_ELEMENT_INSTR_DEKKER + n_c * J_c * C_DENSITY_OPS) / FP32_ISSUE_S * 1e3
    log(f"[9] kernel C time at N={n_c} J={J_c}: kernel {c_ms:.4f} ms, plain "
        f"{c_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in c_all)}); bound {c_bound[0]:.4f} ms ({c_bound[1]}), "
        f"FP32 issue limit {c_issue:.4f} ms at {C_ELEMENT_INSTR} instructions per element "
        f"({c_issue_dekker:.4f} ms at the Dekker product's {C_ELEMENT_INSTR_DEKKER}) on {card}")
    am0 = chunks_df[0]
    d_ms, d_plain_ms, d_all, d_call = kernel_in_turns(
        lambda: dec.decode_scan_df_reference(am0, lens, *largs, *df_tabs, 200.0, t0=0),
        lambda: dec.decode_scan_df(am0, lens, *largs, *df_tabs, 200.0, t0=0), 1, 10,
        "decode_scan_df")
    d_bound = scan_bound(FULL_BATCH, chunk, S_b, W, P, 8, df=True)
    d_warps = _native.load().sr_decode_scan_df_threads(W, P) // 32
    d_issue = (FULL_BATCH * chunk * (W * P * D_SLOT_INSTR + d_warps * 32 * (
        D_LANE_INSTR + (d_warps - 1) * DF_CMP)) / FP32_ISSUE_S * 1e3)
    d_inst = instance("sr_decode_scan_df_instance", W, P)
    log(f"[9] kernel D time at B={FULL_BATCH} T={chunk} ({d_inst}): kernel "
        f"{d_ms:.4f} ms (device time), plain {d_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in d_all)}); a call to the wrapper {d_call:.4f} ms "
        f"(events); bound {d_bound[0]:.4f} ms ({d_bound[1]}), "
        f"FP32 issue limit {d_issue:.4f} ms at {D_SLOT_INSTR} instructions per slot and frame; "
        f"per frame {d_ms / chunk * 1e3:.3f} us on {card}")
    staircase("[9]", "kernel D", _native.load().sr_decode_scan_df_residency(W, P),
              lambda nb: device_ms(lambda: dec.decode_scan_df(
                  dfm.DF(am0.hi[:nb].contiguous(), am0.lo[:nb].contiguous()),
                  lens[:nb].contiguous(), *largs, *df_tabs, 200.0, t0=0), 5, "decode_scan_df"),
              card)
    a64 = ams64[0]
    b64_ms, b64_plain_ms, b64_all, b64_call = kernel_in_turns(
        lambda: dec.decode_scan_reference(a64, lens, *targs64, 200.0, t0=0),
        lambda: dec.decode_scan(a64, lens, *targs64, 200.0, t0=0), 2, 10,
        "decode_scan", "decode_scan_df")
    b64_bound = scan_bound(FULL_BATCH, chunk, S_b, W, P, 8)
    b64_res = _native.load().sr_decode_scan_residency(W, P, 1)
    log(f"[9] f64 kernel B residency {b64_res} blocks per SM, {waves(FULL_BATCH, b64_res)} "
        f"wave(s) for {FULL_BATCH} utterances")
    log(f"[9] f64 kernel B time at B={FULL_BATCH} T={chunk} "
        f"({instance('sr_decode_scan_instance', W, P)}): kernel {b64_ms:.4f} ms (device time), "
        f"plain {b64_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in b64_all)}); a call to the wrapper {b64_call:.4f} ms "
        f"(events); bound {b64_bound[0]:.4f} ms "
        f"({b64_bound[1]}); per frame {b64_ms / chunk * 1e3:.3f} us on {card}")
    b_staircase(dec, _native, a64, lens, targs64, W, P, card, f64=True)
    b_sweep(dev, dec)
    del x, chunks_df, ams64, am0, a64, carry_k, carry_p, out_k, out_p, feats
    torch.cuda.empty_cache()

    # -- 10. golden demo runs, df32 and f64 --------------------------------------------
    for kind in ("df32", "f64"):
        if kind == "df32":
            rec = dec.Recognizer(config, lex, tdp, packdf_iter2, dtype="df32")
            counters = {"am_scores_df": gmm.am_scores_df, "decode_scan_df": dec.decode_scan_df}
        else:
            rec = dec.Recognizer(config, lex, tdp, iter2.pack(dtype=torch.float64, device=dev),
                                 dtype=torch.float64)
            counters = {"decode_scan[f64]": dec.decode_scan}
        for fn in counters.values():
            fn.LAUNCHES = 0
        res = rec.recognize_corpus(corpus, batch_size=35)
        counts = {k: fn.LAUNCHES for k, fn in counters.items()}
        mism = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
        sid = [res["substitutions"], res["insertions"], res["deletions"]]
        log(f"[10] golden iter-2.mix {kind}: WER {res['wer']:.6f} % SER {res['ser']:.6f} % "
            f"S/I/D {sid[0]}/{sid[1]}/{sid[2]}, {len(mism)} mismatches of 35, "
            f"launches {counts}")
        check(not mism, f"{kind} golden transcripts differ at {mism}")
        check(abs(res["wer"] - golden["corpus"]["wer"]) < 1e-5, f"{kind} golden WER")
        check(abs(res["ser"] - golden["corpus"]["ser"]) < 1e-9, f"{kind} golden SER")
        check(sid == golden["corpus"]["sid"], f"{kind} golden S/I/D")
        check(all(v > 0 for v in counts.values()), f"{kind} golden run skipped a kernel")

    # -- 11. full width, df32: the production path ------------------------------------------
    hyps35_df = rec_df.recognize_corpus(corpus, batch_size=35)["hyps"]
    rec_df.warmup(big, batch_size=FULL_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gmm.am_scores_df.LAUNCHES = dec.decode_scan_df.LAUNCHES = 0
    dec.decode_scan_df.SCRATCH_LAUNCHES = 0
    res = rec_df.recognize_corpus(big, batch_size=FULL_BATCH)
    launches = {"am_scores_df": gmm.am_scores_df.LAUNCHES,
                "decode_scan_df": dec.decode_scan_df.LAUNCHES}
    main_scratch = {"decode_scan": f32_launches["decode_scan in scratch"],
                    "decode_scan_df": dec.decode_scan_df.SCRATCH_LAUNCHES}
    peak_df = torch.cuda.max_memory_allocated(dev)
    log(f"[11] full width df32 bench/model.mix, {FULL_BATCH} utterances "
        f"({res['audio_seconds']:.1f} s audio, padded to {T} frames): decode through "
        f"kernels C and D {res['time']:.4f} s, RTF {res['rtf']:.3e}, peak device memory "
        f"{peak_df / 2 ** 20:.1f} MiB; launches {launches}; on {card}")
    check(all(v > 0 for v in launches.values()), f"df32 main path skipped a kernel: {launches}")
    check(res["num_decoded"] == FULL_BATCH, "df32 full batch decoded")
    with torch.profiler.profile(activities=PROFILED) as prof:
        res_prof = rec_df.recognize_corpus(big, batch_size=FULL_BATCH)
    log_profile("[11]", prof, res_prof["time"])
    check(res_prof["hyps"] == res["hyps"], "the profiled df32 decode changed a transcript")
    del prof, res_prof

    # the plain decode's projected time from phase 9: T/chunk scans and
    # FULL_BATCH*T/AM_CHUNK scoring calls
    projected = (T // chunk * d_plain_ms + FULL_BATCH * T / gmm.AM_CHUNK * c_plain_ms) / 1e3
    n_plain = FULL_BATCH if projected <= PLAIN_BUDGET_S else PLAIN_CUT
    with mock.patch.object(gmm, "am_scores_df", gmm.am_scores_df_reference), \
            mock.patch.object(dec, "decode_scan_df", dec.decode_scan_df_reference):
        res_plain = rec_df.recognize_corpus(big, batch_size=n_plain, max_segments=n_plain)
    diff = [s for s in range(n_plain) if res["hyps"][s] != res_plain["hyps"][s]]
    vs35 = [s for s in range(FULL_BATCH) if res["hyps"][s] != hyps35_df[s % 35]]
    cut = "" if n_plain == FULL_BATCH else f" (cut: the full plain decode projects to {projected:.0f} s)"
    log(f"[11] df32 plain comparison on {n_plain} of {FULL_BATCH} utterances{cut}: "
        f"{res_plain['time']:.4f} s, RTF {res_plain['rtf']:.3e}; kernel-vs-plain transcript "
        f"differences {len(diff)}, differences from the 35-utterance df32 run {len(vs35)}")
    check(not diff, f"df32 kernel and plain transcripts differ at {diff[:10]}")
    check(not vs35, f"df32 full-batch transcripts differ from the 35-utterance run at {vs35[:10]}")

    rec64 = dec.Recognizer(config, lex, tdp, bench.pack(dtype=torch.float64, device=dev),
                           dtype=torch.float64)
    rec64.warmup(big, batch_size=FULL_BATCH)
    dec.decode_scan.LAUNCHES = dec.decode_scan.SCRATCH_LAUNCHES = 0
    res64 = rec64.recognize_corpus(big, batch_size=FULL_BATCH)
    launches["decode_scan[f64]"] = dec.decode_scan.LAUNCHES
    main_scratch["decode_scan[f64]"] = dec.decode_scan.SCRATCH_LAUNCHES
    vs64 = [s for s in range(FULL_BATCH) if res["hyps"][s] != res64["hyps"][s]]
    log(f"[11] f64 decode of the same batch (kernel B f64, scores from the float64 "
        f"[x^2, x, 1] product): {res64['time']:.4f} s, RTF {res64['rtf']:.3e}; df32 "
        f"transcripts that differ from f64: {len(vs64)} of {FULL_BATCH}; launches "
        f"{launches['decode_scan[f64]']}")
    check(launches["decode_scan[f64]"] > 0, "the f64 decode skipped kernel B")
    del rec64, res64, res_plain
    torch.cuda.empty_cache()

    # -- 12. the CLI's recognize on the card ------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "demo.json")
        with open(cfg_path, "w") as f:
            json.dump({"corpus": str(FIX / "demo_corpus.json"),
                       "feature-path": str(FIX / "demo_features") + "/",
                       "normalization-path": str(FIX / "normalization-demo.bin"),
                       "load-mixtures-from": str(FIX / "iter-2.mix"), "pooling": "mixture",
                       "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0,
                       **SETTINGS}, f)
        cli = subprocess.run([sys.executable, "-m", "speechrecognition_torch.cli", cfg_path,
                              "recognize", "--device", "cuda"], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
    cli_lines = cli.stderr.strip().splitlines()
    log(f"[12] CLI recognize --device cuda: exit {cli.returncode}; "
        + " | ".join(ln for ln in cli_lines if ln.split(":")[0] in ("WER", "SER", "Time", "RTF")))
    check(cli.returncode == 0, f"CLI recognize failed:\n{cli.stderr[-2000:]}")
    check("WER: 19.587629% (S/I/D) 4/14/1" in cli_lines, "CLI recognize golden WER line")

    check("jax" not in sys.modules, "the port imported jax")
    train, train_scratch = train_phases(dev, card, lex, corpus, big, bench, packdf_bench,
                                        c_plain_ms)
    main_scratch.update(train_scratch)
    log(f"[18] launches with the lattice in device scratch on the main paths: {main_scratch}")
    check(not any(main_scratch.values()), f"a main path kept its lattice in scratch: {main_scratch}")
    t_phase = time.perf_counter()
    large = large_instances(dev, card, main_scratch)
    log(f"[18] phase seconds {time.perf_counter() - t_phase:.1f}")
    nn = nn_phases(dev, card, lex, corpus, big)
    search = search_phases(dev, card, lex, corpus, big, iter2, bench, tdp, wordloop_hyps)
    features_phase(dev, card, big)
    disc = discriminative_phases(dev, card, lex, corpus, big, bench, iter2)
    lvcsr = lvcsr_phases(dev, card)
    char_rnn_phase(dev, card)
    flf_launches = flf_phase(dev, card)
    sprint = sprint_phase(dev, card)
    parallel = parallel_phase(dev, card, lex, big, bench, tdp)
    tools_phase(dev, card, lex, corpus, iter2, tdp)
    gmm_corpus_phase(dev, card, corpus, iter2)
    nan_phase(dev, card)
    j64 = [e for e in search if e["name"] == "decode_scan_bigram[f64]"]
    check(len(j64) == 1, "one decode_scan_bigram[f64] entry in the search tier's kernels")
    log(f"[35] decode_scan_bigram[f64] launches: {j64[0]['launches']} on the bigram decode "
        f"(phase 24) + {flf_launches} on the Flf recognizer")
    j64[0]["launches"] += flf_launches
    check("jax" not in sys.modules, "the port imported jax")

    kernels = [
        entry("mahalanobis_scores", "mahalanobis.cu", "speechrecognition_tpu/ops/mahalanobis.py:90",
              f32_launches["mahalanobis_scores"], a_err["main"], a_ms, a_plain_ms, a_bound),
        entry("mahalanobis_min_scores", "mahalanobis.cu",
              "speechrecognition_tpu/ops/mahalanobis.py:90 + speechrecognition_tpu/models/gmm.py:538",
              f32_launches["mahalanobis_min_scores"], a_err["fused main"], m_ms, m_plain_ms,
              m_bound),
        entry("decode_scan", "decode_scan.cu", "speechrecognition_tpu/search/decoder.py:109",
              f32_launches["decode_scan"], b_abs, b_ms, b_plain_ms, b_bound),
        entry("decode_scan[f64]", "decode_scan.cu", "speechrecognition_tpu/search/decoder.py:109",
              launches["decode_scan[f64]"], b64_abs, b64_ms, b64_plain_ms, b64_bound),
        entry("am_scores_df", "am_scores_df.cu", "speechrecognition_tpu/models/gmm.py:568",
              launches["am_scores_df"], c_err["main"], c_ms, c_plain_ms, c_bound),
        entry("decode_scan_df", "decode_scan_df.cu", "speechrecognition_tpu/search/decoder.py:221",
              launches["decode_scan_df"], d_abs, d_ms, d_plain_ms, d_bound),
        *train,
        *large,
        *nn,
        *search,
        *disc,
        *lvcsr,
        *sprint,
        *parallel,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def tables_module(name):
    """tests/<name>.py, inputs the tests also use (torch_df_tables,
    torch_search_tables, torch_fb_tables), loaded by path (tests/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plain_kernels(stack, gmm, vit, em):
    """Route every kernel wrapper of the training path to its plain version
    (the trainer imports em_pass_sorted by name, so it is patched there)."""
    for mod, name, fn in ((gmm, "am_scores_df", gmm.am_scores_df_reference),
                          (vit, "align_fwd_chunk", vit.align_fwd_chunk_reference),
                          (vit, "align_fwd_chunk_df", vit.align_fwd_chunk_df_reference),
                          (vit, "align_backtrack", vit.align_backtrack_reference),
                          (em, "em_pass_sorted", gmm.em_pass_sorted_reference)):
        stack.enter_context(mock.patch.object(mod, name, fn))


def train_phases(dev, card, lex, corpus, big, bench, packdf_bench, c_plain_ms):
    """Phases 13-17: the trainer's kernels E-H against their plain versions,
    the golden demo trainer, the full-width df32 trainer (the training main
    path) and the CLI's train. Returns the kernels' JSON entries."""
    import contextlib
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.io import read_alignment, read_mixture_set
    from speechrecognition_torch.lexicon import build_segment_automaton
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import doublefloat as dfm
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.tdp import TdpModel
    from speechrecognition_torch.train import em
    from speechrecognition_torch.train.em import Trainer, TrainerConfig

    counters = {"am_scores_df": gmm.am_scores_df, "align_fwd": vit.align_fwd_chunk,
                "align_fwd_df": vit.align_fwd_chunk_df,
                "align_backtrack": vit.align_backtrack, "em_pass_df": gmm.em_pass_sorted}

    scans = {"align_fwd": vit.align_fwd_chunk, "align_fwd_df": vit.align_fwd_chunk_df}

    def zero():
        for fn in counters.values():
            fn.LAUNCHES = 0
        for fn in scans.values():
            fn.SCRATCH_LAUNCHES = 0

    def counts():
        return {**{k: fn.LAUNCHES for k, fn in counters.items()},
                **{f"{k} in scratch": fn.SCRATCH_LAUNCHES for k, fn in scans.items()}}

    # -- 13. kernels E (f32, f64), F and G against their plain versions -------------
    t_phase = time.perf_counter()
    C = vit.ALIGN_CHUNK
    ids = list(range(TRAIN_BATCH))
    T_al = 3 * C
    check(int(big.lengths[:TRAIN_BATCH].max()) <= T_al, "the align batch fits three chunks")
    feats = dec.DeviceCorpus(big, dev).batch(ids, T_al)
    lens = torch.as_tensor(big.lengths[:TRAIN_BATCH], dtype=torch.int32, device=dev)
    tdp_full = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    tables = vit.AlignerTables.build([build_segment_automaton(lex, big.orths[s]) for s in ids],
                                     tdp_full)
    A = tables.states.shape[1]
    st_tbl = torch.as_tensor(tables.states, device=dev)
    aut = torch.as_tensor(tables.lengths, device=dev)
    valid = torch.arange(A, device=dev)[None, :] < aut[:, None]
    idx = st_tbl.long()[:, None, :].expand(TRAIN_BATCH, C, A)
    flat_chunks = [feats[:, c * C:(c + 1) * C].reshape(-1, 25) for c in range(3)]

    def run_fwd(fn, ams, prev, tdp, thr):
        jumps = []
        for c in range(3):
            prev, j = fn(prev, ams[c], tdp, valid, lens, thr, c * C)
            jumps.append(j)
        return prev, torch.cat(jumps)

    res = {}
    for label, dt in (("align_fwd", torch.float32), ("align_fwd[f64]", torch.float64)):
        pack = bench.pack(dtype=dt, device=dev)
        ams = [gmm.am_scores(pack, x).reshape(TRAIN_BATCH, C, -1).to(dt).gather(2, idx)
               .contiguous() for x in flat_chunks]
        tdp = torch.as_tensor(tables.tdp, dtype=dt, device=dev)
        big0 = torch.full((TRAIN_BATCH, A), 1e30, dtype=dt, device=dev)
        k_prev, k_j = run_fwd(vit.align_fwd_chunk, ams, big0, tdp, 200.0)
        p_prev, p_j = run_fwd(vit.align_fwd_chunk_reference, ams, big0, tdp, 200.0)
        torch.cuda.synchronize()
        equal = torch.equal(k_prev, p_prev) and torch.equal(k_j, p_j)
        err = (k_prev - p_prev).abs().max().item()
        live = (k_prev < 1e29).double().mean().item()
        ms, plain_ms, all_ = in_turns(
            lambda: vit.align_fwd_chunk_reference(big0, ams[0], tdp, valid, lens, 200.0, 0),
            lambda: vit.align_fwd_chunk(big0, ams[0], tdp, valid, lens, 200.0, 0), 1, 10)
        bnd = align_bound(TRAIN_BATCH, C, A, 4 if dt == torch.float32 else 8)
        log(f"[13] kernel E {dt} B={TRAIN_BATCH} C={C} A={A} "
            f"({instance('sr_align_fwd_warps', A)}) on "
            f"bench/model.mix scores, "
            f"3 chunks with carry: carry and jumps bit-equal {equal}, max abs {err:.3e}, "
            f"live positions after the chunks {live:.3f}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms per chunk (plain, kernel, kernel, plain: "
            f"{', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms ({bnd[1]}); "
            f"per frame {ms / C * 1e3:.3f} us on {card}")
        check(equal, f"kernel E ({dt}) is not bit-equal to its plain version")
        res[label] = (err, ms, plain_ms, bnd)

    am_df = [gmm.am_scores_df(packdf_bench, x) for x in flat_chunks]
    ams_df = [dfm.DF(a.hi.reshape(TRAIN_BATCH, C, -1).gather(2, idx).contiguous(),
                     a.lo.reshape(TRAIN_BATCH, C, -1).gather(2, idx).contiguous())
              for a in am_df]
    tdp_df = dfm.from_f64(tables.tdp, dev)
    thr_df = dfm.from_f64(np.float64(200.0), dev)
    big_df = dfm.DF(torch.full((TRAIN_BATCH, A), 1e30, device=dev),
                    torch.zeros((TRAIN_BATCH, A), device=dev))
    k_prev, k_j = run_fwd(vit.align_fwd_chunk_df, ams_df, big_df, tdp_df, thr_df)
    p_prev, p_j = run_fwd(vit.align_fwd_chunk_df_reference, ams_df, big_df, tdp_df, thr_df)
    torch.cuda.synchronize()
    equal = (torch.equal(k_prev.hi, p_prev.hi) and torch.equal(k_prev.lo, p_prev.lo)
             and torch.equal(k_j, p_j))
    err = ((k_prev.hi.double() + k_prev.lo.double())
           - (p_prev.hi.double() + p_prev.lo.double())).abs().max().item()
    ms, plain_ms, all_ = in_turns(
        lambda: vit.align_fwd_chunk_df_reference(big_df, ams_df[0], tdp_df, valid, lens,
                                                 thr_df, 0),
        lambda: vit.align_fwd_chunk_df(big_df, ams_df[0], tdp_df, valid, lens, thr_df, 0),
        1, 10)
    bnd = align_bound(TRAIN_BATCH, C, A, 8, df=True)
    log(f"[13] kernel F B={TRAIN_BATCH} C={C} A={A} "
        f"({instance('sr_align_fwd_df_warps', A)}) on df32 "
        f"scores, 3 chunks with carry: "
        f"hi, lo and jumps bit-equal {equal}, max abs {err:.3e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms per chunk (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms ({bnd[1]}); "
        f"per frame {ms / C * 1e3:.3f} us on {card}")
    check(equal, "kernel F is not bit-equal to its plain version")
    check(f_warps(A) > 0, "the SieTill automata take kernel F's warp instance")
    res["align_fwd_df"] = (err, ms, plain_ms, bnd)
    e_sweep(dev, card, vit)
    log_block_instance(dev, card, vit, dfm, C)

    g_args = (k_prev.hi.contiguous(), aut, k_j, lens, st_tbl, int(big.lengths[:TRAIN_BATCH].max()))
    k_states, k_fp = vit.align_backtrack(*g_args)
    p_states, p_fp = vit.align_backtrack_reference(*g_args)
    torch.cuda.synchronize()
    equal = torch.equal(k_states, p_states) and torch.equal(k_fp, p_fp)
    bare = g_bare(*g_args)
    ms, plain_ms, all_, call = kernel_in_turns(lambda: vit.align_backtrack_reference(*g_args),
                                               lambda: vit.align_backtrack(*g_args), 1, 10,
                                               "align_backtrack_kernel", bare=bare)
    bare_ms = cuda_ms(bare, 10)
    # the walk reads one jump byte per utterance and frame, each final row
    # and state-table row once, and writes the states and final positions
    T_g = g_args[-1]
    bnd = bound(TRAIN_BATCH * (T_al + 2 * A * 4 + 4 * T_g + 4 + 3 * 4))
    log(f"[13] kernel G B={TRAIN_BATCH} Tp={T_al} A={A} ({vit_tile(A)} frames a tile): states "
        f"and final positions bit-equal {equal}; kernel {ms:.4f} ms (device time), plain "
        f"{plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in all_)}); a call to the wrapper {call:.4f} ms (events), "
        f"a bare launch {bare_ms:.4f} ms (events around 10 back-to-back); bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); per step of the walk {ms / T_al * 1e3:.3f} us on {card}")
    check(equal, "kernel G is not bit-equal to its plain version")
    res["align_backtrack"] = (0.0, ms, plain_ms, bnd)
    g_floor(dev, card, T_al, ms)
    g_cases(dev, card, vit)
    f_plain_ms, g_plain_ms = res["align_fwd_df"][2], plain_ms
    del feats, flat_chunks, am_df, ams_df, ams, k_prev, p_prev, k_j, p_j
    log(f"[13] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 14. kernel H against its plain version --------------------------------------
    t_phase = time.perf_counter()
    demo_align, _w, _m = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    align_big = np.concatenate([
        demo_align[corpus.feature_offsets[s % 35]:corpus.feature_offsets[s % 35 + 1]]
        for s in range(big.num_segments)])
    frame_idx, block_state, nb = gmm.sorted_blocks(align_big, 106)
    frames = torch.as_tensor(big.features, device=dev)[
        torch.as_tensor(np.maximum(frame_idx, 0), device=dev)]
    mask = torch.as_tensor((frame_idx >= 0).astype(np.float32), device=dev)
    bs = torch.as_tensor(block_state, device=dev)
    got = gmm.em_pass_sorted(packdf_bench, frames, mask, bs)
    again = gmm.em_pass_sorted(packdf_bench, frames, mask, bs)
    ref = gmm.em_pass_sorted_reference(packdf_bench, frames, mask, bs)
    torch.cuda.synchronize()
    ident = all(torch.equal(a, b) for a, b in zip(got, again))
    w_equal = torch.equal(got[1], ref[1])
    rel = max(((g - r).abs().max() / r.abs().max()).item()
              for g, r in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])))
    h_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    ms, plain_ms, all_ = in_turns(
        lambda: gmm.em_pass_sorted_reference(packdf_bench, frames, mask, bs),
        lambda: gmm.em_pass_sorted(packdf_bench, frames, mask, bs), 1, 10)
    NB_h, R_h = frame_idx.shape
    S_h, D_h = packdf_bench.num_mixtures, packdf_bench.density_cap
    live = int((frame_idx >= 0).sum())
    h_bound = bound(4 * NB_h * R_h * 26 + 4 * NB_h + 8 * (2 * S_h * D_h * 25 + 2 * S_h * D_h)
                    + 8 * (2 * S_h * D_h * 25 + S_h * D_h + 1),
                    fp32=live * D_h * (25 * C_ELEMENT_OPS + C_DENSITY_OPS),
                    fp64=live * (25 * H_ROW_DIM_F64 + H_ROW_F64))
    h_issue = live * D_h * (25 * C_ELEMENT_INSTR + C_DENSITY_OPS) / FP32_ISSUE_S * 1e3
    log(f"[14] kernel H NB={NB_h} ({nb} used) x {R_h} rows, {live} live rows, "
        f"S={S_h} D={D_h} dim=25: w bit-equal {w_equal}, "
        f"total/xs/x2s max rel {rel:.3e} (max abs {h_err:.3e}), two launches bit-identical "
        f"{ident}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain, kernel, kernel, "
        f"plain: {', '.join(f'{v:.4f}' for v in all_)}); bound {h_bound[0]:.4f} ms "
        f"({h_bound[1]}), FP32 issue limit of the scoring {h_issue:.4f} ms on {card}")
    check(w_equal, "kernel H counts differ from its plain version")
    check(rel <= 1e-12, f"kernel H sums differ from plain by {rel} > 1e-12 relative")
    check(ident, "kernel H is not deterministic")
    res["em_pass_df"] = (h_err, ms, plain_ms, h_bound)
    h_plain_ms = plain_ms
    del frames, mask, got, again, ref
    torch.cuda.empty_cache()
    log(f"[14] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 15. golden demo trainer on the card ------------------------------------------
    t_phase = time.perf_counter()
    tdp_oracle = TdpModel(silence_state=lex.silence_state, loop=20.0, forward=0.0, skip=20.0)
    ref_align, _w, _m = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    ref_mix = read_mixture_set(str(FIX / "iter-2.mix"), 25)

    def oracle_run(dtype, out, plain=False):
        cfg = TrainerConfig(min_obs=1, num_splits=2, num_aligns=1, num_estimates=3,
                            pruning_threshold=120.0, mixture_path=out + "/iter-",
                            alignment_path=out + "/alignment-")
        model = gmm.MixtureModel(25, lex.num_states, gmm.VarianceModel.MIXTURE_POOLING)
        trainer = Trainer(cfg, lex, model, tdp_oracle, dtype=dtype, device=dev,
                          log=lambda *a: None)
        with contextlib.ExitStack() as stack:
            if plain:
                plain_kernels(stack, gmm, vit, em)
            alignment = trainer.train(corpus)
        return trainer, alignment

    golden_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, dtype in (("df32", "df32"), ("f64", torch.float64)):
            out = os.path.join(tmp, kind)
            os.makedirs(out)
            zero()
            t0 = time.perf_counter()
            trainer, _ = oracle_run(dtype, out)
            golden_counts[kind] = counts()
            scores = [float(ln.split()[3]) for ln in trainer.stats_lines]
            worst = max(abs(g - o) for g, o in zip(scores, ORACLE_AM_SCORES))
            mine, _w, _m = read_alignment(os.path.join(out, "alignment-2-0.dump"))
            mix = read_mixture_set(os.path.join(out, "iter-2.mix"), 25)
            mix_ok = ([len(m) for m in mix.mixtures] == [len(m) for m in ref_mix.mixtures]
                      and np.array_equal(mix.mean_weight, ref_mix.mean_weight)
                      and np.allclose(mix.mean_acc, ref_mix.mean_acc, rtol=1e-9, atol=1e-7))
            log(f"[15] golden trainer {kind} on the card: {time.perf_counter() - t0:.2f} s, "
                f"AM scores {' '.join(ln.split()[3] for ln in trainer.stats_lines)} (worst "
                f"|diff| to the oracle {worst:.2e}); alignment-2-0 frames differing from the "
                f"C++ trainer's {int((mine != ref_align).sum())}; iter-2.mix within rtol 1e-9 "
                f"{mix_ok}; launches {golden_counts[kind]}")
            check(len(scores) == 10 and worst < 1e-4, f"{kind} golden trajectory")
            check(np.array_equal(mine, ref_align), f"{kind} golden alignment")
            check(mix_ok, f"{kind} golden iter-2.mix")
        check(all(golden_counts["df32"][k] > 0 for k in ("am_scores_df", "align_fwd_df",
                                                        "align_backtrack", "em_pass_df")),
              f"the df32 golden trainer skipped a kernel: {golden_counts['df32']}")
        check(golden_counts["f64"]["align_fwd"] > 0 and golden_counts["f64"]["align_backtrack"] > 0,
              f"the f64 golden trainer skipped a kernel: {golden_counts['f64']}")

        os.makedirs(os.path.join(tmp, "f32"))
        os.makedirs(os.path.join(tmp, "f32-plain"))
        zero()
        tr32, al32 = oracle_run(torch.float32, os.path.join(tmp, "f32"))
        f32_counts = counts()
        tr32p, al32p = oracle_run(torch.float32, os.path.join(tmp, "f32-plain"), plain=True)
        check(counts() == f32_counts, "the plain f32 trainer launched a kernel")
        dumps_equal = all(
            np.array_equal(read_alignment(os.path.join(tmp, "f32", n))[0],
                           read_alignment(os.path.join(tmp, "f32-plain", n))[0])
            for n in ("alignment-0-0.dump", "alignment-1-0.dump", "alignment-2-0.dump"))
        log(f"[15] f32 trainer on the card, kernels vs plain: alignments equal "
            f"{dumps_equal and np.array_equal(al32, al32p)}, stats lines equal "
            f"{tr32.stats_lines == tr32p.stats_lines}, frames differing from the C++ trainer "
            f"{int((al32 != ref_align).sum())}; launches {f32_counts}")
        check(dumps_equal and np.array_equal(al32, al32p), "f32 kernel and plain alignments")
        check(f32_counts["align_fwd"] > 0, "the f32 trainer skipped kernel E")
    log(f"[15] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 16. full width: the training main path -----------------------------------------
    t_phase = time.perf_counter()
    cfg_full = TrainerConfig(min_obs=1, num_splits=4, num_aligns=1, num_estimates=2,
                             pruning_threshold=200.0, approx_linear_segmentation=False,
                             batch_size=TRAIN_BATCH)

    def full_run(dtype, corp, plain=False):
        model = gmm.MixtureModel(25, lex.num_states, gmm.VarianceModel.NO_POOLING)
        trainer = Trainer(cfg_full, lex, model, tdp_full, dtype=dtype, device=dev,
                          log=lambda *a: None)
        with contextlib.ExitStack() as stack:
            if plain:
                plain_kernels(stack, gmm, vit, em)
            t0 = time.perf_counter()
            alignment = trainer.train(corp)
            torch.cuda.synchronize()
        return trainer, alignment, time.perf_counter() - t0

    audio = big.total_audio_seconds
    full_run("df32", repeat_corpus(corpus, 35, type(corpus)))       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    tr_df, al_df, secs = full_run("df32", big)
    main_counts = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[16] full-width df32 trainer, {big.num_segments} utterances, {big.total_frames} "
        f"frames ({audio:.1f} s audio): {secs:.4f} s, {secs / audio:.3e} s per second of "
        f"audio; phases {tr_df.phase_seconds}; peak device memory {peak / 2 ** 20:.1f} MiB; "
        f"densities {tr_df.model.num_densities()} (max {tr_df.model.max_densities_per_mixture} "
        f"per mixture); AM scores {' '.join(ln.split()[3] for ln in tr_df.stats_lines)}; "
        f"launches {main_counts}; on {card}")
    check(all(main_counts[k] > 0 for k in ("am_scores_df", "align_fwd_df", "align_backtrack",
                                           "em_pass_df")),
          f"the df32 main path skipped a kernel: {main_counts}")

    with torch.profiler.profile(activities=PROFILED) as prof:
        tr_prof, _al, secs_prof = full_run("df32", big)
    log_profile("[16]", prof, secs_prof)
    log(f"[16] profiled run: stats lines equal to the unprofiled run "
        f"{tr_prof.stats_lines == tr_df.stats_lines}")
    del tr_prof, prof

    # the plain run's projected seconds from phases 9, 13 and 14: the scoring
    # and forward chunks and backtracks of five realignments, 28 E-step passes
    n_batches = -(-big.num_segments // TRAIN_BATCH)
    projected = (5 * (n_batches * 3 * (TRAIN_BATCH * C / gmm.AM_CHUNK * c_plain_ms + f_plain_ms)
                      + n_batches * g_plain_ms) + 28 * h_plain_ms) / 1e3
    if projected <= PLAIN_TRAIN_BUDGET_S:
        sub, tr_k, al_k = big, tr_df, al_df
    else:
        sub = repeat_corpus(corpus, PLAIN_TRAIN_CUT, type(corpus))
        tr_k, al_k, _s = full_run("df32", sub)
    before = counts()
    tr_p, al_p, secs_p = full_run("df32", sub, plain=True)
    check(counts() == before, "the plain trainer launched a kernel")
    n_diff = int((al_k != al_p).sum())
    dens_equal = ([len(m) for m in tr_k.model.mixtures] == [len(m) for m in tr_p.model.mixtures]
                  and np.array_equal(tr_k.model.mean_weight_acc, tr_p.model.mean_weight_acc))
    cut = ("" if sub is big else f" (cut to {sub.num_segments} utterances: the full plain run "
           f"projects to {projected:.0f} s)")
    log(f"[16] plain df32 trainer on {sub.num_segments} utterances{cut}: {secs_p:.4f} s "
        f"(projected for all {projected:.1f} s); stats lines equal "
        f"{tr_k.stats_lines == tr_p.stats_lines}, frames of the final alignment that differ "
        f"{n_diff}, density counts equal {dens_equal}")
    check(tr_k.stats_lines == tr_p.stats_lines, "kernel and plain stats lines differ")
    check(n_diff == 0, f"{n_diff} frames differ between the kernel and plain alignments")
    check(dens_equal, "kernel and plain density counts differ")
    del tr_p, al_p

    zero()
    tr64, al64, secs64 = full_run(torch.float64, big)
    f64_counts = counts()
    log(f"[16] f64 trainer on the same corpus: {secs64:.4f} s; phases {tr64.phase_seconds}; "
        f"frames whose final alignment differs from df32 {int((al64 != al_df).sum())} of "
        f"{al_df.shape[0]}; AM scores {' '.join(ln.split()[3] for ln in tr64.stats_lines)}; "
        f"launches {f64_counts}")
    check(f64_counts["align_fwd"] > 0, "the f64 trainer skipped kernel E")
    with torch.profiler.profile(activities=PROFILED) as prof:
        tr64p, _al, secs64p = full_run(torch.float64, big)
    log_profile("[16] f64 trainer", prof, secs64p)
    e_ms, e_n = kernel_device_ms(prof, "align_fwd")
    log(f"[16] f64 trainer profiled: kernel E {e_ms:.3f} ms of device time over {e_n} "
        f"launches; stats lines equal to the unprofiled run "
        f"{tr64p.stats_lines == tr64.stats_lines}")
    del tr64, al64, tr_df, tr64p, prof
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "the training path imported jax")
    log(f"[16] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 17. the CLI's train on the card ---------------------------------------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "train.json")
        with open(cfg_path, "w") as f:
            json.dump({"corpus": str(FIX / "demo_corpus.json"),
                       "feature-path": str(FIX / "demo_features") + "/",
                       "normalization-path": str(FIX / "normalization-demo.bin"),
                       "pooling": "mixture", "train-dtype": "df32", "tdp-loop": 20.0,
                       "tdp-forward": 0.0, "tdp-skip": 20.0, "min-obs": 1, "num-splits": 2,
                       "num-aligns": 1, "num-estimates": 3, "pruning-threshold": 120.0,
                       "mixture-path": tmp + "/iter-", "alignment-path": tmp + "/alignment-"},
                      f)
        cli = subprocess.run([sys.executable, "-m", "speechrecognition_torch.cli", cfg_path,
                              "train", "--device", "cuda"], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        mix_ok = False
        if cli.returncode == 0:
            mix = read_mixture_set(os.path.join(tmp, "iter-2.mix"), 25)
            mix_ok = ([len(m) for m in mix.mixtures] == [len(m) for m in ref_mix.mixtures]
                      and np.array_equal(mix.mean_weight, ref_mix.mean_weight)
                      and np.allclose(mix.mean_acc, ref_mix.mean_acc, rtol=1e-9, atol=1e-7))
    log(f"[17] CLI train --device cuda (train-dtype df32): exit {cli.returncode}; "
        + " | ".join(ln for ln in cli.stderr.splitlines() if "took" in ln)
        + f"; iter-2.mix within the oracle tolerance {mix_ok}; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    check(cli.returncode == 0, f"CLI train failed:\n{cli.stderr[-2000:]}")
    check(mix_ok, "CLI train iter-2.mix")

    sources = {"align_fwd": ("align_scan.cu", "speechrecognition_tpu/align/viterbi.py:315",
                             f32_counts["align_fwd"]),
               "align_fwd[f64]": ("align_scan.cu", "speechrecognition_tpu/align/viterbi.py:315",
                                  f64_counts["align_fwd"]),
               "align_fwd_df": ("align_scan_df.cu", "speechrecognition_tpu/align/viterbi.py:368",
                                main_counts["align_fwd_df"]),
               "align_backtrack": ("align_backtrack.cu",
                                   "speechrecognition_tpu/align/viterbi.py:582",
                                   main_counts["align_backtrack"]),
               "em_pass_df": ("em_pass_df.cu", "speechrecognition_tpu/models/gmm.py:997",
                              main_counts["em_pass_df"])}
    scratch = {"align_fwd": f32_counts["align_fwd in scratch"],
               "align_fwd[f64]": f64_counts["align_fwd in scratch"],
               "align_fwd_df": main_counts["align_fwd_df in scratch"]}
    return ([entry(name, src, replaces, n, *res[name])
             for name, (src, replaces, n) in sources.items()], scratch)


def log_block_instance(dev, card, vit, dfm, C):
    """Kernel F's wide instance (128 < A <= 1024) on a synthetic batch of
    TRAIN_BATCH utterances: two chunks with carry bit-equal to the plain
    version, as the forced first design (the block instance, its row in
    shared memory); one chunk timed against each in turns."""
    A = F_BLOCK_A
    rng = np.random.default_rng(A)
    ams = [dfm.from_f64(rng.uniform(0.0, 40.0, size=(TRAIN_BATCH, C, A)), dev) for _ in range(2)]
    tdp = dfm.from_f64(rng.uniform(0.0, 20.0, size=(TRAIN_BATCH, A, 3)), dev)
    aut = torch.as_tensor(rng.integers(A // 2, A + 1, size=TRAIN_BATCH), device=dev)
    valid = torch.arange(A, device=dev)[None, :] < aut[:, None]
    lens = torch.as_tensor(rng.integers(C, 2 * C + 1, size=TRAIN_BATCH), dtype=torch.int32,
                           device=dev)
    thr = dfm.from_f64(np.float64(200.0), dev)
    big = dfm.DF(torch.full((TRAIN_BATCH, A), 1e30, device=dev),
                 torch.zeros((TRAIN_BATCH, A), device=dev))
    def first(*a):
        return f_first(vit, *a)

    outs = []
    for fn in (vit.align_fwd_chunk_df, first, vit.align_fwd_chunk_df_reference):
        prev, jumps = big, []
        for c in range(2):
            prev, j = fn(prev, ams[c], tdp, valid, lens, thr, c * C)
            jumps.append(j)
        outs.append((prev.hi, prev.lo, torch.cat(jumps)))
    torch.cuda.synchronize()
    equal = all(torch.equal(k, p) for k, p in zip(outs[0], outs[2]))
    equal_first = all(torch.equal(k, p) for k, p in zip(outs[1], outs[2]))
    ms, plain_ms, all_ = in_turns(
        lambda: vit.align_fwd_chunk_df_reference(big, ams[0], tdp, valid, lens, thr, 0),
        lambda: vit.align_fwd_chunk_df(big, ams[0], tdp, valid, lens, thr, 0), 1, 10)
    wide_ms, first_ms, fall = in_turns(
        lambda: first(big, ams[0], tdp, valid, lens, thr, 0),
        lambda: vit.align_fwd_chunk_df(big, ams[0], tdp, valid, lens, thr, 0), 10, 10)
    log(f"[13] kernel F B={TRAIN_BATCH} C={C} A={A} "
        f"({instance('sr_align_fwd_df_warps', A)}) on "
        f"synthetic scores, 2 chunks with carry: hi, lo and jumps bit-equal {equal} (the first "
        f"design, forced: {equal_first}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per chunk "
        f"(plain, kernel, kernel, plain: {', '.join(f'{v:.4f}' for v in all_)}); first design "
        f"{first_ms:.4f} ms against the wide instance's {wide_ms:.4f} ms in turns (first, wide, "
        f"wide, first: {', '.join(f'{v:.4f}' for v in fall)}); per frame {ms / C * 1e3:.3f} us "
        f"(first design {first_ms / C * 1e3:.3f} us) on {card}")
    check(A > F_WARP_A and f_warps(A) > 0, "kernel F's wide instance runs")
    check(equal and equal_first, "kernel F's wide instance or its first design is not "
          "bit-equal to its plain version")


#: automaton lengths of phase 13's sweep of kernel E's warp instance: every
#: warp count of its layout (1 to 4 warps an utterance)
E_SWEEP_A = (32, 33, 64, 70, 96, 128)


def e_sweep(dev, card, vit):
    """Kernel E's warp instance at B 256, C 320 on synthetic scores, at each
    length of E_SWEEP_A, in both score types: three rounds, the lengths in
    ascending, descending and ascending order, so that a drift of the card's
    clock shows as a spread and not as a trend over A."""
    C = vit.ALIGN_CHUNK
    rng = np.random.default_rng(13)
    lens = torch.full((TRAIN_BATCH,), C, dtype=torch.int32, device=dev)
    for dt in (torch.float64, torch.float32):
        inputs = {}
        for A in E_SWEEP_A:
            ams = torch.as_tensor(rng.uniform(0.0, 40.0, (TRAIN_BATCH, C, A)), dtype=dt, device=dev)
            tdp = torch.as_tensor(rng.uniform(0.0, 20.0, (TRAIN_BATCH, A, 3)), dtype=dt,
                                  device=dev)
            valid = torch.ones((TRAIN_BATCH, A), dtype=torch.bool, device=dev)
            prev = torch.full((TRAIN_BATCH, A), 1e30, dtype=dt, device=dev)
            inputs[A] = (prev, ams, tdp, valid, lens, 200.0, 0)
        times = {A: [] for A in E_SWEEP_A}
        for order in (E_SWEEP_A, E_SWEEP_A[::-1], E_SWEEP_A):
            for A in order:
                times[A].append(cuda_ms(lambda: vit.align_fwd_chunk(*inputs[A]), 10))
        log(f"[13] kernel E sweep {dt} B={TRAIN_BATCH} C={C} on synthetic scores, ms a chunk in "
            f"three rounds: " + "; ".join(
                f"A={A} ({instance('sr_align_fwd_warps', A)}) "
                + ", ".join(f"{v:.4f}" for v in times[A]) for A in E_SWEEP_A) + f" on {card}")
        del inputs


def staircase(tag, name, per_sm, time_at, card):
    """A scan's residency (blocks per SM, from the occupancy calculator), the
    waves its launch takes, and its device time ``time_at(nb)`` at batch
    sizes that fill whole multiples of the SMs: a staircase in time shows
    the waves."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    steps = [f"B={nb} {time_at(nb):.4f} ms ({waves(nb, per_sm)} wave(s))"
             for nb in (132, 264, 528, 924, FULL_BATCH)]
    log(f"{tag} {name} residency {per_sm} blocks (utterances) per SM on {sms} SMs: the "
        f"{FULL_BATCH}-utterance chunk takes {waves(FULL_BATCH, per_sm)} wave(s); "
        f"times {'; '.join(steps)} on {card}")


def b_staircase(dec, native, am, lens, targs, W, P, card, f64):
    """Kernel B's staircase (f32 in phase 4, f64 in phase 9)."""
    staircase("[9]" if f64 else "[4]", f"kernel B {'f64' if f64 else 'f32'}",
              native.load().sr_decode_scan_residency(W, P, int(f64)),
              lambda nb: device_ms(lambda: dec.decode_scan(am[:nb].contiguous(), lens[:nb].contiguous(),
                                                           *targs, 200.0, t0=0), 5,
                                   "decode_scan", "decode_scan_df"), card)


def lattice_tables(W, P):
    """Decoder tables of a W x P lattice from a seeded lexicon with
    repetition 1: silence (P states when it is the only word, else 1) and
    W - 1 words, the first of P states. Returns the tables, the number of
    states and the generator, to draw the scores from."""
    from speechrecognition_torch.lexicon import Lexicon
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.tdp import TdpModel
    rng = np.random.default_rng(W * P)
    lex = Lexicon()
    lex.add_word("[silence]", P if W == 1 else 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == 0 else int(rng.integers(1, P + 1)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    tables = dec.DecoderTables.build(lex, tdp, 15.0)
    check(tables.state_table.shape == (W, P), f"lattice {W}x{P}")
    return tables, lex.num_states, rng


#: the lattices of kernel B's shape sweep: the warp instance's edges (one
#: word; P at, one past and far past a lane's 8 positions; SieTill; its
#: widest lattice), and past them (W 33, P 33), which take the block instance
B_SWEEP = ((1, 2), (4, 8), (4, 9), (12, 24), (32, 32), (33, 8), (4, 33))


def b_sweep(dev, dec):
    """Kernel B at every lattice of B_SWEEP, B 4, T 40, in both score types:
    two chunks with carry bit-equal to its plain version, each utterance
    ending at another frame (40, 23, 0, 39); once with an exit penalty."""
    nb, T = LARGE_B, LARGE_T
    lens = torch.as_tensor([T, 23, 0, T - 1], dtype=torch.int32, device=dev)
    seen = []
    for W, P in B_SWEEP:
        tables, S, rng = lattice_tables(W, P)
        am64 = rng.uniform(0.0, 40.0, size=(nb, T, S))
        xp = torch.as_tensor(rng.uniform(0.0, 20.0, size=W), device=dev)
        lex_t = tuple(torch.as_tensor(a, device=dev) for a in (
            tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
            tables.tdp_within, tables.entry_pen))
        for dt in (torch.float32, torch.float64):
            am = torch.as_tensor(am64, dtype=dt, device=dev)
            for exit_pen in (None, xp) if (W, P) == (4, 9) else (None,):
                outs = []
                for fn in (dec.decode_scan, dec.decode_scan_reference):
                    carry, parts = None, []
                    for t0, n in ((0, 15), (15, T - 15)):
                        carry, out = fn(am[:, t0:t0 + n].contiguous(), lens, *lex_t, 60.0,
                                        carry_in=carry, t0=t0, exit_pen=exit_pen)
                        parts.append(out)
                    outs.append([*carry] + [torch.cat([o[k] for o in parts]) for k in range(3)])
                torch.cuda.synchronize()
                equal = all(k.dtype == p.dtype and torch.equal(k, p) for k, p in zip(*outs))
                check(equal, f"kernel B ({dt}) at {W}x{P} is not bit-equal to its plain version")
        seen.append(f"{W}x{P} ({instance('sr_decode_scan_instance', W, P)})")
    log(f"[9] kernel B sweep, B={nb} T={T}, float32 and float64, 2 chunks with carry "
        f"(4x9 also with an exit penalty): bit-equal at {'; '.join(seen)}")


def vit_tile(A):
    """Frames a tile of kernel G's launch for A positions (0: rows walked
    from device memory)."""
    from speechrecognition_torch.ops import _native
    return _native.load().sr_align_backtrack_tile(A)


#: kernels G's and N's yardsticks, built by this script alone (the port does
#: not carry them): one thread follows a chain of ``steps`` dependent loads,
#: each load's address the value the previous one read, from shared memory
#: (G's) or from device memory through L2 (N's: ld.global.cg, which skips
#: L1, from *start; the last index is written to *out)
CHASE_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void global_chase_kernel(int steps, const int* __restrict__ next,
                                    const int* __restrict__ start, int* __restrict__ out) {
  int cur = *start;
  for (int s = 0; s < steps; ++s) cur = __ldcg(next + cur);
  *out = cur;
}

extern "C" int global_chase(int steps, const int* next, const int* start, int* out, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  global_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(steps, next, start, out);
  return (int)cudaGetLastError();
}

__global__ void shared_chase_kernel(int steps, int* __restrict__ out) {
  __shared__ int next[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) next[i] = (i * 97 + 13) & 1023;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int cur = 0;
#pragma unroll 8
  for (int s = 0; s < steps; ++s) cur = next[cur];
  *out = cur;
}

extern "C" int shared_chase(int steps, int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  shared_chase_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, out);
  return (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def chase_library():
    """CHASE_SOURCE built with the kernels' nvcc flags under build/chase/."""
    from speechrecognition_torch.ops import _native
    out_dir = REPO / "build" / "chase"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "shared_chase.cu", out_dir / "libshared_chase.so"
    src.write_text(CHASE_SOURCE)
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.shared_chase.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.shared_chase.restype = ctypes.c_int
    lib.global_chase.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.global_chase.restype = ctypes.c_int
    return lib


def g_floor(dev, card, Tp, g_ms):
    """The floor of kernel G's serial walk: one dependent shared-memory load
    per step (the chase of chase_library times a chain of them), beside G's
    time."""
    lib = chase_library()
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    steps = 1 << 20
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chase():
        check(lib.shared_chase(steps, out.data_ptr(), dev.index, stream) == 0,
              "the shared-memory chase launches")

    ms = cuda_ms(chase, 3)
    load_ns = ms * 1e6 / steps
    log(f"[13] kernel G chain floor: one dependent shared-memory load takes {load_ns:.3f} ns "
        f"(a chain of {steps} timed), so a walk of {Tp} steps takes at least "
        f"{Tp * load_ns * 1e-6:.4f} ms; kernel G {g_ms:.4f} ms, {g_ms * 1e6 / Tp:.2f} ns a step, "
        f"{g_ms * 1e6 / Tp / load_ns:.2f} loads' latency on {card}")


def g_cases(dev, card, vit):
    """Kernel G on tests/torch_df_tables.py's cases (Tp 1 to 2,000, A 1 to
    1,025, walks below -A, all-BIG final rows, feat_len 0, 1 and Tp, T 0
    to Tp) and at Tp 3,000, A 1,025, on 9 utterances (not a multiple of a
    block's): states and final positions bit-equal to the plain version;
    the largest timed."""
    mod = tables_module("torch_df_tables")
    cases = [*mod.BACKTRACK_CASES, (3000, 1025, "dp", True, "Tp"),
             (3000, 1025, "random", False, "Tp-7")]
    for Tp, A, jumps, tie, which in cases:
        final_hi, aut_len, jmp, lens, tbl = (torch.as_tensor(a, device=dev) for a in
                                             mod.backtrack_inputs(Tp, A, jumps, seed=Tp + A, B=9))
        args = (final_hi, aut_len, jmp, lens, tbl, mod.backtrack_frames(Tp, which))
        got = vit.align_backtrack(*args, tie_pruned=tie)
        want = vit.align_backtrack_reference(*args, tie_pruned=tie)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"kernel G differs from its plain version at Tp={Tp} A={A} {jumps} "
              f"tie_pruned={tie} T={which}")
    ms = device_ms(lambda: vit.align_backtrack(*args, tie_pruned=tie), 10,
                   "align_backtrack_kernel", bare=g_bare(*args, tie_pruned=tie))
    log(f"[13] kernel G on {len(cases)} edge cases (B 9; Tp 1 to 3,000, A 1 to 1,025, walks "
        f"below -A, all-BIG final rows, feat_len 0, 1 and Tp, T 0 to Tp): bit-equal; at "
        f"Tp={Tp} A={A} {ms:.4f} ms, {ms * 1e6 / Tp:.2f} ns a step on {card}")


def kernel_device_ms(prof, name, exclude=None):
    """Device milliseconds and launches of the kernels whose name holds
    ``name`` (and not ``exclude``)."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key
              and (exclude is None or exclude not in e.key)]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in events)
    return us / 1e3, sum(e.count for e in events)


#: the large-lattice and long-automaton shapes of phase 18: just past the
#: block instances' 1,024 threads, and far past them
LARGE_LATTICES = ((44, 24), (1000, 24))
LARGE_AUTOMATA = (1025, 3000)
LARGE_B, LARGE_T = 4, 40


def large_instances(dev, card, main_scratch):
    """Phase 18: every scan with its lattice in device scratch (kernels B in
    f32 and f64 and D at W*P = 1,056 and 24,000; E in f32 and f64 and F at
    A = 1,025 and 3,000) on a small synthetic batch (B 4, T 40, two chunks
    with carry), bit-equal to its plain version, one chunk timed in turns.
    Each entry's launches are ``main_scratch``'s: the wrapper's
    SCRATCH_LAUNCHES over the main paths' runs."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.ops import doublefloat as dfm
    from speechrecognition_torch.search import decoder as dec

    entries = []
    nb, T = LARGE_B, LARGE_T
    lens = torch.as_tensor([T, 23, 0, T - 1], dtype=torch.int32, device=dev)
    halves = ((0, 15), (15, T - 15))

    def both(fn_kernel, fn_plain, run):
        """run(fn) with the wrapper and with its plain version; checks that
        each of the wrapper's launches kept its lattice in scratch."""
        before = (fn_kernel.LAUNCHES, fn_kernel.SCRATCH_LAUNCHES)
        outs = [run(fn_kernel), run(fn_plain)]
        n, n_scratch = fn_kernel.LAUNCHES - before[0], fn_kernel.SCRATCH_LAUNCHES - before[1]
        check(n == n_scratch == len(halves), f"{fn_kernel.__name__}: {n} launches, {n_scratch} "
              f"with the lattice in scratch")
        torch.cuda.synchronize()
        return outs

    def compare(tag, kern, plain):
        equal = all(k.dtype == p.dtype and torch.equal(k, p) for k, p in zip(kern, plain))
        err = max(((k.double() - p.double()).abs().max().item() for k, p in zip(kern, plain)
                   if k.is_floating_point()), default=0.0)
        check(equal, f"{tag} is not bit-equal to its plain version")
        return err

    for W, P in LARGE_LATTICES:
        tables, S, rng = lattice_tables(W, P)
        am64 = rng.uniform(0.0, 40.0, size=(nb, T, S))
        lex_t = tuple(torch.as_tensor(a, device=dev) for a in (
            tables.state_table, tables.last_pos, tables.word_len, tables.first_state))
        for dt, word in ((torch.float32, 4), (torch.float64, 8)):
            am = torch.as_tensor(am64, dtype=dt, device=dev)
            targs = (*lex_t, torch.as_tensor(tables.tdp_within, device=dev),
                     torch.as_tensor(tables.entry_pen, device=dev))
            def run_b(fn):
                carry, parts = None, []
                for t0, n in halves:
                    carry, out = fn(am[:, t0:t0 + n].contiguous(), lens, *targs, 60.0,
                                    carry_in=carry, t0=t0)
                    parts.append(out)
                return [*carry] + [torch.cat([o[k] for o in parts]) for k in range(3)]

            outs = both(dec.decode_scan, dec.decode_scan_reference, run_b)
            name = "decode_scan" if dt == torch.float32 else "decode_scan[f64]"
            err = compare(f"{name} at {W}x{P}", *outs)
            a0 = am[:, :T].contiguous()
            ms, plain_ms, all_, _call = kernel_in_turns(
                lambda: dec.decode_scan_reference(a0, lens, *targs, 60.0),
                lambda: dec.decode_scan(a0, lens, *targs, 60.0), 1, 5, "decode_scan",
                "decode_scan_df")
            bnd = scan_bound(nb, T, S, W, P, word)
            log(f"[18] kernel B {dt} W*P={W}x{P}={W * P} B={nb} T={T} "
                f"({instance('sr_decode_scan_instance', W, P)}): "
                f"bit-equal over 2 chunks with carry; kernel {ms:.4f} ms (device time), plain "
                f"{plain_ms:.4f} "
                f"ms (plain, kernel, kernel, plain: {', '.join(f'{v:.4f}' for v in all_)}); "
                f"bound {bnd[0]:.4f} ms ({bnd[1]}); per frame {ms / T * 1e3:.3f} us on {card}")
            entries.append(entry(f"{name}[W*P={W * P}]", "decode_scan.cu",
                                 "speechrecognition_tpu/search/decoder.py:109",
                                 main_scratch[name], err, ms, plain_ms, bnd))
        am = dfm.from_f64(am64, dev)
        dargs = (*lex_t, dfm.from_f64(tables.tdp_within, dev),
                 dfm.from_f64(tables.entry_pen, dev))
        def run_d(fn):
            carry, parts = None, []
            for t0, n in halves:
                chunk = dfm.DF(am.hi[:, t0:t0 + n].contiguous(), am.lo[:, t0:t0 + n].contiguous())
                carry, out = fn(chunk, lens, *dargs, 60.0, carry_in=carry, t0=t0)
                parts.append(out)
            (hyp, bk, book) = carry
            return ([hyp.hi, hyp.lo, bk, book.hi, book.lo]
                    + [torch.cat([o[k] for o in parts]) for k in range(3)])

        outs = both(dec.decode_scan_df, dec.decode_scan_df_reference, run_d)
        err = compare(f"decode_scan_df at {W}x{P}", *outs)
        ms, plain_ms, all_, _call = kernel_in_turns(
            lambda: dec.decode_scan_df_reference(am, lens, *dargs, 60.0),
            lambda: dec.decode_scan_df(am, lens, *dargs, 60.0), 1, 5, "decode_scan_df")
        bnd = scan_bound(nb, T, S, W, P, 8, df=True)
        log(f"[18] kernel D W*P={W}x{P}={W * P} B={nb} T={T} "
            f"({instance('sr_decode_scan_df_instance', W, P)}): bit-equal "
            f"over 2 chunks with carry; kernel {ms:.4f} ms (device time), plain {plain_ms:.4f} "
            f"ms (plain, "
            f"kernel, kernel, plain: {', '.join(f'{v:.4f}' for v in all_)}); bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); per frame {ms / T * 1e3:.3f} us on {card}")
        entries.append(entry(f"decode_scan_df[W*P={W * P}]", "decode_scan_df.cu",
                             "speechrecognition_tpu/search/decoder.py:221",
                             main_scratch["decode_scan_df"], err, ms, plain_ms, bnd))

    for A in LARGE_AUTOMATA:
        rng = np.random.default_rng(A)
        ams64 = rng.uniform(0.0, 40.0, size=(nb, T, A))
        tdp64 = rng.uniform(0.0, 20.0, size=(nb, A, 3))
        aut = torch.as_tensor([A, A - 37, 5, A], device=dev)
        valid = torch.arange(A, device=dev)[None, :] < aut[:, None]
        # a live cost row entering at frame 3, so that every position takes part
        prev64 = rng.uniform(0.0, 50.0, size=(nb, A))
        for dt, word in ((torch.float32, 4), (torch.float64, 8)):
            ams = torch.as_tensor(ams64, dtype=dt, device=dev)
            tdp = torch.as_tensor(tdp64, dtype=dt, device=dev)
            prev0 = torch.as_tensor(prev64, dtype=dt, device=dev)
            def run_e(fn):
                prev, jumps = prev0, []
                for t0, n in halves:
                    prev, j = fn(prev, ams[:, t0:t0 + n].contiguous(), tdp, valid, lens, 60.0,
                                 3 + t0)
                    jumps.append(j)
                return [prev, torch.cat(jumps)]

            outs = both(vit.align_fwd_chunk, vit.align_fwd_chunk_reference, run_e)
            name = "align_fwd" if dt == torch.float32 else "align_fwd[f64]"
            err = compare(f"{name} at A={A}", *outs)
            ms, plain_ms, all_ = in_turns(
                lambda: vit.align_fwd_chunk_reference(prev0, ams, tdp, valid, lens, 60.0, 3),
                lambda: vit.align_fwd_chunk(prev0, ams, tdp, valid, lens, 60.0, 3), 1, 5)
            bnd = align_bound(nb, T, A, word)
            log(f"[18] kernel E {dt} A={A} B={nb} C={T} "
                f"({instance('sr_align_fwd_warps', A)}): bit-equal over 2 "
                f"chunks with carry; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain, kernel, "
                f"kernel, plain: {', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms "
                f"({bnd[1]}); per frame {ms / T * 1e3:.3f} us on {card}")
            entries.append(entry(f"{name}[A={A}]", "align_scan.cu",
                                 "speechrecognition_tpu/align/viterbi.py:315",
                                 main_scratch[name], err, ms, plain_ms, bnd))
        ams, tdp = dfm.from_f64(ams64, dev), dfm.from_f64(tdp64, dev)
        prev0, thr = dfm.from_f64(prev64, dev), dfm.from_f64(np.float64(60.0), dev)
        def run_f(fn):
            prev, jumps = prev0, []
            for t0, n in halves:
                chunk = dfm.DF(ams.hi[:, t0:t0 + n].contiguous(), ams.lo[:, t0:t0 + n].contiguous())
                prev, j = fn(prev, chunk, tdp, valid, lens, thr, 3 + t0)
                jumps.append(j)
            return [prev.hi, prev.lo, torch.cat(jumps)]

        outs = both(vit.align_fwd_chunk_df, vit.align_fwd_chunk_df_reference, run_f)
        err = compare(f"align_fwd_df at A={A}", *outs)
        ms, plain_ms, all_ = in_turns(
            lambda: vit.align_fwd_chunk_df_reference(prev0, ams, tdp, valid, lens, thr, 3),
            lambda: vit.align_fwd_chunk_df(prev0, ams, tdp, valid, lens, thr, 3), 1, 5)
        bnd = align_bound(nb, T, A, 8, df=True)
        log(f"[18] kernel F A={A} B={nb} C={T} "
            f"({instance('sr_align_fwd_df_warps', A)}): bit-equal over 2 chunks with "
            f"carry; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain, kernel, kernel, plain: "
            f"{', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms ({bnd[1]}); per "
            f"frame {ms / T * 1e3:.3f} us on {card}")
        entries.append(entry(f"align_fwd_df[A={A}]", "align_scan_df.cu",
                             "speechrecognition_tpu/align/viterbi.py:368",
                             main_scratch["align_fwd_df"], err, ms, plain_ms, bnd))
    return entries


#: phase 19's model and settings: bench/nn_run/model.json (1x150 tanh,
#: context 2, bench/nn_tanh/models_r/24/, prior bench/nn_tanh/prior.txt at
#: scale 1.2, TDP 4-0-30, word penalty 105, threshold 200); its 35 demo
#: transcripts are tests/fixtures/demo_recognition_nn.json
NN_MODEL = REPO / "bench" / "nn_run" / "model.json"
NN_FIXTURE = FIX / "demo_recognition_nn.json"
#: the card's NN scores against the same network evaluated in float64 on the
#: same features: float32 products of 125 and 150 terms, so |card - ref| <=
#: NN_AM_ATOL + NN_AM_RTOL * |ref|. The CPU port's float32 scores are printed
#: beside them, not held to a limit: a second float32 evaluation, whose
#: rounding depends on the host's BLAS, drifted 1.993e-04 from the card's on
#: one host and 5.722e-06 on others (NVIDIA H100 80GB HBM3, 700.00 W), while
#: both stayed within 2.1e-05 of float64 where measured.
NN_AM_RTOL, NN_AM_ATOL = 1e-5, 1e-4
#: the MLP's two products per frame (125 -> 150 -> 106), an FMA as two
NN_GEMM_FLOPS = 2 * (125 * 150 + 150 * 106)
#: bytes the MLP's products must move: per frame its input read and its
#: scores written once (the hidden layer need not leave the chip), and per
#: call its weights read once
NN_FRAME_BYTES = 4 * (125 + 106)
NN_WEIGHT_BYTES = 4 * (150 * (125 + 1) + 106 * (150 + 1))
#: phase 20's recipe: bench/nn_tanh/train_nn_restore.config, cut to
#: NN_TRAIN_EPOCHS epochs and run with its gradient check
NN_RECIPE = REPO / "bench" / "nn_tanh" / "train_nn_restore.config"
NN_TRAIN_EPOCHS = 2
#: the card's training against the CPU port's, both in float32 with their
#: products summed in other orders. A full-width run on an NVIDIA H100 80GB
#: HBM3 (700 W) read equal FERs and final weights within 1.6e-7 of their
#: layer's largest weight; the limits
#: leave room on both sides: each epoch's frame error rates within
#: NN_FER_ATOL (three CV frames; a near-tie's argmax may flip), every final
#: weight within NN_PARAM_RTOL of its layer's largest
NN_FER_ATOL = 1e-4
NN_PARAM_RTOL = 1e-5
#: the first batch's gradients, the card's float32 against the CPU port's
#: float64, within NN_GRAD_RTOL of each tensor's largest. On an NVIDIA
#: H100 80GB HBM3 (700 W) the full float32 products read 3.95e-7; the TF32
#: control run of phase 20, which must fail this check or another of the
#: above, read 2.54e-4 (its FERs 1.53e-4, its weights 4.71e-3). AdaDelta's
#: first steps are nearly sign(gradient), so the weights alone could hide
#: a lower-precision product.
NN_GRAD_RTOL = 1e-5
#: t-SNE of 1,000 frames of hidden activations, card against the CPU port:
#: float64 sums in other orders, so TSNE_STEPS steps from the same state
#: (t-SNE's start, and the card's final embedding) agree within
#: TSNE_STEP_RTOL of the embedding's scale. Longer runs multiply any
#: difference (tenfold every three steps in the early phase,
#: tests/test_torch_tsne.py), so the whole 500-step runs are held to each
#: other by what they show: their costs KL(P||Q) within TSNE_KL_RTOL, and
#: within TSNE_SHARE_ATOL the share of points whose nearest embedded
#: neighbour is among their 10 nearest activations, and the share whose
#: nearest embedded neighbour has their state. On an NVIDIA H100 80GB HBM3
#: (700 W) the card and the CPU read KL 5.715723 and 5.715598 (2.2e-5
#: apart), shares 0.425 and 0.423, 0.633 and 0.634.
TSNE_FRAMES = 1000
TSNE_STEPS = 10
TSNE_STEP_RTOL = 1e-10
TSNE_KL_RTOL = 1e-3
TSNE_SHARE_ATOL = 0.02


def nn_scorer(device):
    """model.json's NN scorer on ``device``, and the model's settings."""
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.models.nn import MLP, NNScorer, layer_specs_from_config
    with open(NN_MODEL) as f:
        m = json.load(f)
    k = m["context_frames"]
    mlp = MLP(layer_specs_from_config(Configuration({"layers": m["layers"]})),
              input_dim=25 * (2 * k + 1), device=device)
    mlp.load(str(REPO / m["model_path"]) + "/")
    prior = NNScorer.load_prior(str(REPO / m["prior_file"]), 106, m["prior_scale"],
                                device=device)
    return NNScorer(mlp, prior, k), m


def nn_scores_f64(scorer, feats):
    """The scorer's network in float64 on its device: its weights, context
    windows, formulas and prior, every product and sum in float64."""
    from speechrecognition_torch.models.nn import build_context_windows
    x = torch.as_tensor(feats, dtype=torch.float64, device=scorer.device)
    with torch.no_grad():
        params = {n: {k: v.double() for k, v in p.items()}
                  for n, p in scorer.mlp.params().items()}
        windows = build_context_windows(x, scorer.context_frames)
        log_probs = scorer.mlp.apply(params, windows)["__log_probs__"]
    return -log_probs + scorer.log_prior.double()


def gemm_device_ms(prof):
    """(device ms, launches) of the GEMM kernels in a profile, and the
    profile's whole device ms."""
    def us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    gemms = [e for e in events if "gemm" in e.key.lower()]
    return (sum(us(e) for e in gemms) / 1e3, sum(e.count for e in gemms),
            sum(us(e) for e in events) / 1e3)


def b_two_chunks(dec, am, lens, targs, tag):
    """Kernel B against its plain version over the first two chunks of
    ``am`` [B, T, S] with carry; returns the largest difference (0.0 when
    bit-equal, which is checked)."""
    chunk = dec.DECODE_CHUNK
    carry_k = carry_p = None
    err = 0.0
    for c in range(2):
        a = am[:, c * chunk:(c + 1) * chunk].contiguous()
        carry_k, out_k = dec.decode_scan(a, lens, *targs, 200.0, prune=True,
                                         carry_in=carry_k, t0=c * chunk)
        carry_p, out_p = dec.decode_scan_reference(a, lens, *targs, 200.0, prune=True,
                                                   carry_in=carry_p, t0=c * chunk)
        torch.cuda.synchronize()
        for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"),
                              (*carry_k, *out_k), (*carry_p, *out_p)):
            check(k.dtype == p.dtype and torch.equal(k, p),
                  f"{tag}: chunk {c} {name} differs from the plain version")
            if k.is_floating_point():
                err = max(err, (k.double() - p.double()).abs().max().item())
    return err


def nn_phases(dev, card, lex, corpus, big):
    """Phases 19-22: the NN decode and the NN trainer at full width, the
    CLI's NN actions and t-SNE, the native corpus loader. Returns the
    kernels line's entries of kernel B on the NN decodes."""
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.tdp import TdpModel

    entries = []
    chunk = dec.DECODE_CHUNK
    t_phase = time.perf_counter()
    # -- 19. the NN decode at full width --------------------------------------------
    scorer, m = nn_scorer(dev)
    scorer_cpu, _ = nn_scorer("cpu")
    loop, forward, skip = m["tdp"]
    tdp_nn = TdpModel(silence_state=lex.silence_state, loop=loop, forward=forward, skip=skip)
    settings = Configuration({"am-threshold": m["am_threshold"], "word-penalty": m["word_penalty"],
                              "pruned-search": True, "max-recognition-runs": 10 ** 9})

    def recognizer(dtype):
        rec = dec.Recognizer(settings, lex, tdp_nn, dtype=dtype)
        rec.nn_scorer = scorer
        return rec

    with open(NN_FIXTURE) as f:
        fixture = json.load(f)
    rec = recognizer(torch.float32)
    dec.decode_scan.LAUNCHES = 0
    res35 = rec.recognize_corpus(corpus, batch_size=35)
    n35 = dec.decode_scan.LAUNCHES
    mism = [u["idx"] for u in fixture["utts"] if res35["hyps"][u["idx"]] != u["hyp"]]
    sid = [res35["substitutions"], res35["insertions"], res35["deletions"]]
    log(f"[19] NN decode of the 35 demo utterances (bench/nn_run/model.json, f32): WER "
        f"{res35['wer']:.6f} % SER {res35['ser']:.6f} % S/I/D {sid[0]}/{sid[1]}/{sid[2]}, "
        f"{len(mism)} mismatches of 35 against {NN_FIXTURE.name}; kernel B launches {n35}")
    check(not mism, f"NN transcripts differ from the fixture at {mism}")
    check(res35["wer"] == fixture["corpus"]["wer"] and res35["ser"] == fixture["corpus"]["ser"]
          and sid == fixture["corpus"]["sid"], "NN WER, SER or S/I/D differ from the fixture")
    check(n35 > 0, "the NN demo decode did not launch kernel B")

    feats35, _ = corpus.padded_batch(list(range(35)))
    am_card = scorer.am_batch(feats35).cpu().double()
    am_ref = nn_scores_f64(scorer, feats35).cpu()
    am_cpu = scorer_cpu.am_batch(feats35).double()
    diff = (am_card - am_ref).abs()
    excess = (diff - (NN_AM_ATOL + NN_AM_RTOL * am_ref.abs())).max().item()
    log(f"[19] the card's NN scores against the network in float64 on the 35 utterances "
        f"({am_ref.shape[0]} x {am_ref.shape[1]} x {am_ref.shape[2]}): max abs "
        f"{diff.max().item():.3e}; worst excess over {NN_AM_ATOL:g} + {NN_AM_RTOL:g}*|ref| "
        f"{excess:.3e}; the CPU port's float32 scores: max abs "
        f"{(am_cpu - am_ref).abs().max().item():.3e} from float64, "
        f"{(am_card - am_cpu).abs().max().item():.3e} from the card's (not a gate)")
    check(excess <= 0, "the card's NN scores differ from the CPU port's beyond the tolerance")

    T = rec._bucket(big.max_seq_length)
    feats = dec.DeviceCorpus(big, dev).batch(list(range(FULL_BATCH)), T)
    lens = torch.as_tensor(big.lengths, dtype=torch.int32, device=dev)
    tables = rec.tables
    W, P = tables.state_table.shape
    targs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
        tables.tdp_within, tables.entry_pen))
    am_big = scorer.am_batch(feats)
    b_entries = {}
    for label, dt, word in (("decode_scan[nn]", torch.float32, 4),
                            ("decode_scan[nn, f64]", torch.float64, 8)):
        am = am_big.to(dt)
        err = b_two_chunks(dec, am, lens, targs, f"kernel B {label}")
        a0 = am[:, :chunk].contiguous()
        ms, plain_ms, all_, call = kernel_in_turns(
            lambda: dec.decode_scan_reference(a0, lens, *targs, 200.0, prune=True, t0=0),
            lambda: dec.decode_scan(a0, lens, *targs, 200.0, prune=True, t0=0), 2, 10,
            "decode_scan", "decode_scan_df")
        bnd = scan_bound(FULL_BATCH, chunk, a0.shape[2], W, P, word)
        log(f"[19] kernel B {dt} B={FULL_BATCH} T={chunk} on the MLP's scores, 2 chunks with "
            f"carry: bit-equal True, max abs {err:.3e}; kernel {ms:.4f} ms (device time), plain "
            f"{plain_ms:.4f} ms (plain, kernel, kernel, plain: "
            f"{', '.join(f'{v:.4f}' for v in all_)}); a call to the wrapper {call:.4f} ms "
            f"(events); bound {bnd[0]:.4f} ms ({bnd[1]}) on {card}")
        b_entries[label] = (err, ms, plain_ms, bnd)
        del am, a0

    # the MLP's products per 32,768 frames: the library call is the port
    from speechrecognition_torch.models.gmm import _full_f32_matmul
    from speechrecognition_torch.models.nn import build_context_windows
    X = build_context_windows(feats, scorer.context_frames).reshape(-1, 125)[:32768].contiguous()
    weights = scorer.mlp.params()
    W1, b1 = weights["hidden-layer1"]["W"], weights["hidden-layer1"]["b"]
    W2 = weights["output-layer"]["W"]
    H = torch.tanh(X @ W1.T + b1)
    with _full_f32_matmul(), torch.no_grad():
        gemm_ms, fwd_ms, g_all = in_turns(lambda: scorer.mlp(X),
                                          lambda: (X @ W1.T, H @ W2.T), 20, 20)
    n_x = X.shape[0]
    g_bound = bound(n_x * NN_FRAME_BYTES + NN_WEIGHT_BYTES, fp32=n_x * NN_GEMM_FLOPS)
    log(f"[19] the MLP's two GEMMs (cuBLAS, full float32) per {n_x} frames: {gemm_ms:.4f} ms; "
        f"the whole forward (GEMMs, bias, tanh, log-softmax, exp) {fwd_ms:.4f} ms (forward, "
        f"GEMMs, GEMMs, forward: {', '.join(f'{v:.4f}' for v in g_all)}); bound "
        f"{g_bound[0]:.4f} ms ({g_bound[1]}); {NN_GEMM_FLOPS * n_x / gemm_ms / 1e9:.1f} TFLOP/s "
        f"on {card}")
    del X, H, feats, am_big
    torch.cuda.empty_cache()

    res_f32 = None
    for label, dt in (("decode_scan[nn]", torch.float32), ("decode_scan[nn, f64]", torch.float64)):
        rec = recognizer(dt)
        hyps35 = rec.recognize_corpus(corpus, batch_size=35)["hyps"]
        rec.warmup(big, batch_size=FULL_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dec.decode_scan.LAUNCHES = dec.decode_scan.SCRATCH_LAUNCHES = 0
        res = rec.recognize_corpus(big, batch_size=FULL_BATCH)
        launches, scratch = dec.decode_scan.LAUNCHES, dec.decode_scan.SCRATCH_LAUNCHES
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.profiler.profile(activities=PROFILED) as prof:
            res_prof = rec.recognize_corpus(big, batch_size=FULL_BATCH)
        log_profile("[19]", prof, res_prof["time"])
        g_ms, g_n, dev_ms = gemm_device_ms(prof)
        frames = FULL_BATCH * T
        f_bound = bound(frames * NN_FRAME_BYTES + NN_WEIGHT_BYTES, fp32=frames * NN_GEMM_FLOPS)
        log(f"[19] {dt} NN decode's GEMMs: {g_ms:.3f} ms in {g_n} launches, "
            f"{g_ms / dev_ms if dev_ms else float('nan'):.4f} of its {dev_ms:.3f} ms of device "
            f"time; their bound over the {frames} padded frames {f_bound[0]:.4f} ms "
            f"({f_bound[1]})")
        check(res_prof["hyps"] == res["hyps"], f"the profiled {dt} NN decode changed a transcript")
        del prof, res_prof
        vs35 = [s for s in range(FULL_BATCH) if res["hyps"][s] != hyps35[s % 35]]
        log(f"[19] full width {dt} NN decode, {FULL_BATCH} utterances ({res['audio_seconds']:.1f} "
            f"s audio, padded to {T} frames): {res['time']:.4f} s, RTF {res['rtf']:.3e}, peak "
            f"device memory {peak / 2 ** 20:.1f} MiB; kernel B launches {launches} ({scratch} "
            f"with the lattice in scratch); differences from the 35-utterance run {len(vs35)}; "
            f"WER {res['wer']:.6f} % on {card}")
        check(res["num_decoded"] == FULL_BATCH, f"{dt} NN full batch decoded")
        check(launches > 0, f"the {dt} NN decode did not launch kernel B")
        check(scratch == 0, f"the {dt} NN decode kept its lattice in scratch")
        check(not vs35, f"{dt} NN full-batch transcripts differ from the 35-utterance run at "
              f"{vs35[:10]}")
        if res_f32 is None:
            check(hyps35 == res35["hyps"], "the NN demo decode is not repeatable")
            res_f32 = res
        else:
            n_diff = sum(res["hyps"][s] != res_f32["hyps"][s] for s in range(FULL_BATCH))
            log(f"[19] f64 NN transcripts that differ from f32: {n_diff} of {FULL_BATCH}")
        err, ms, plain_ms, bnd = b_entries[label]
        entries.append(entry(label, "decode_scan.cu", "speechrecognition_tpu/search/decoder.py:109",
                             launches, err, ms, plain_ms, bnd))
        del rec
        torch.cuda.empty_cache()
    log(f"[19] phase seconds {time.perf_counter() - t_phase:.1f}")

    nn_train_phase(dev, card, lex, corpus, big)
    nn_cli_phase(dev, card)
    native_phase()
    return entries


def nn_train_phase(dev, card, lex, corpus, big):
    """Phase 20: the NN trainer at full width on the card, against the same
    recipe with the port on this machine's CPU; and a control run on the
    card with TF32 products, which the same comparison must reject."""
    import contextlib
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.io import read_alignment
    from speechrecognition_torch.models import nn as nn_mod
    from speechrecognition_torch.models.nn import MLP, layer_specs_from_config
    from speechrecognition_torch.train import nn_training
    from speechrecognition_torch.train.nn_training import MiniBatchBuilder, NnTrainer

    t_phase = time.perf_counter()
    states, _, _ = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    check(states.shape[0] == corpus.total_frames, "the demo alignment covers the demo corpus")
    offs = corpus.feature_offsets
    targets = np.concatenate([states[offs[s % 35]:offs[s % 35 + 1]]
                              for s in range(big.num_segments)])
    with open(NN_RECIPE) as f:
        recipe = json.load(f)

    def first_grads(trainer, dtype):
        """The first batch's gradients at the initial weights, in ``dtype``,
        as float64 on the host."""
        params = trainer.mlp.init_params(np.random.default_rng(trainer.seed))
        f, t, m = (a.to(dtype) for a in trainer._host_batch(0, cv=False))
        p = {n: {k: v.to(dtype) for k, v in d.items()} for n, d in params.items()}
        _, g = trainer.loss_and_grads(p, f, t, m)
        return {n: {k: v.cpu().double() for k, v in d.items()} for n, d in g.items()}

    def train(device, out, **overrides):
        cfg = {**recipe, "num-epochs": NN_TRAIN_EPOCHS, "gradient-check": True,
               "output-dir": os.path.join(out, "models"),
               "nn-training-stats-path": os.path.join(out, "nn_stats.data"), **overrides}
        config = Configuration(cfg)
        builder = MiniBatchBuilder(corpus=big, batch_size=cfg["batch-size"], num_classes=106,
                                   silence_state=lex.silence_state, alignment=targets,
                                   context_frames=cfg["context-frames"], cv_size=cfg["cv-size"])
        mlp = MLP(layer_specs_from_config(config), input_dim=builder.feature_size, device=device)
        logs = []
        trainer = NnTrainer(config, builder, mlp, log=logs.append, device=device)
        grads = first_grads(trainer, torch.float64 if device == "cpu" else torch.float32)
        t0 = time.perf_counter()
        result = trainer.train()
        if device != "cpu":
            torch.cuda.synchronize()
        frames = int(big.lengths[builder.train_segments].sum())
        params = {n: {k: v.cpu() for k, v in d.items()} for n, d in result["params"].items()}
        return params, grads, logs, trainer.stats_lines, time.perf_counter() - t0, frames

    @contextlib.contextmanager
    def tf32_products():
        """The control: the NN's products in TF32 (the guard made a no-op)."""
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with mock.patch.object(nn_mod, "_full_f32_matmul", contextlib.nullcontext), \
                    mock.patch.object(nn_training, "_full_f32_matmul", contextlib.nullcontext):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        params, grads, logs, stats, secs, frames = train(dev, os.path.join(tmp, "card"))
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.profiler.profile(activities=PROFILED) as prof:
            _, _, _, _, secs_prof, _ = train(dev, os.path.join(tmp, "prof"), **{
                "num-epochs": 1, "gradient-check": False})
        with tf32_products():
            ctl_params, ctl_grads, _, ctl_stats, _, _ = train(dev, os.path.join(tmp, "tf32"))
        cpu_params, cpu_grads, cpu_logs, cpu_stats, cpu_secs, _ = train(
            "cpu", os.path.join(tmp, "cpu"))
    epoch_s = [float(ln.split(" # ")[2]) for ln in stats]

    def fer_pairs(lines):
        return [tuple(float(v) for v in ln.split(" # ")[:2]) for ln in lines]

    fers, cpu_fers = fer_pairs(stats), fer_pairs(cpu_stats)
    log(f"[20] full-width NN training ({NN_RECIPE.relative_to(REPO)}, cut to "
        f"{NN_TRAIN_EPOCHS} epochs), {big.num_segments} utterances, {frames} training frames "
        f"an epoch: {secs:.4f} s with the gradient check; seconds per epoch "
        f"{', '.join(f'{s:.4f}' for s in epoch_s)}; frames per second "
        f"{', '.join(f'{frames / s:.0f}' for s in epoch_s)}; (train FER, CV FER) per epoch "
        f"{fers}; peak device memory {peak / 2 ** 20:.1f} MiB on {card}")
    log(f"[20] {logs[0]} (card), {cpu_logs[0]} (CPU)")
    log_profile("[20]", prof, secs_prof)
    g_ms, g_n, dev_ms = gemm_device_ms(prof)
    log(f"[20] one profiled epoch: GEMMs {g_ms:.3f} ms in {g_n} launches of {dev_ms:.3f} ms "
        f"of device time")
    del prof

    def deviations(run_params, run_grads, run_stats):
        """(FER, final weight, first gradient) deviations from the CPU port."""
        fer = max(abs(a - b) for x, y in zip(fer_pairs(run_stats), cpu_fers)
                  for a, b in zip(x, y))
        weight = max((run_params[n][k] - cpu_params[n][k]).abs().max().item()
                     / cpu_params[n][k].abs().max().item()
                     for n in cpu_params for k in ("W", "b"))
        grad = max((run_grads[n][k] - cpu_grads[n][k]).abs().max().item()
                   / cpu_grads[n][k].abs().max().item()
                   for n in cpu_grads for k in ("W", "b"))
        return fer, weight, grad

    limits = (NN_FER_ATOL, NN_PARAM_RTOL, NN_GRAD_RTOL)
    run = deviations(params, grads, stats)
    ctl = deviations(ctl_params, ctl_grads, ctl_stats)

    def show(d):
        return (f"largest FER difference {d[0]:.2e}, largest weight difference {d[1]:.2e} of its "
                f"layer's largest, first gradients {d[2]:.2e} of their largest")

    log(f"[20] the same recipe with the port on the CPU: {cpu_secs:.2f} s; (train FER, CV "
        f"FER) per epoch {cpu_fers}; the card against it: {show(run)} (tolerances "
        f"{', '.join(f'{v:g}' for v in limits)})")
    log(f"[20] control, the card with TF32 products: (train FER, CV FER) per epoch "
        f"{fer_pairs(ctl_stats)}; against the CPU port: {show(ctl)}; rejected "
        f"{any(d > lim for d, lim in zip(ctl, limits))}")
    check(logs[0].startswith("gradient check max rel dev") and
          float(logs[0].split()[-1]) < 1e-2, "the gradient check on the card")
    check(len(fers) == len(cpu_fers) == len(fer_pairs(ctl_stats)) == NN_TRAIN_EPOCHS,
          "every trainer ran every epoch")
    check(run[0] <= NN_FER_ATOL, "the card's NN training FERs differ from the CPU port's")
    check(run[1] <= NN_PARAM_RTOL, "the card's NN weights differ from the CPU port's")
    check(run[2] <= NN_GRAD_RTOL, "the card's NN gradients differ from the CPU port's float64")
    check(any(d > lim for d, lim in zip(ctl, limits)),
          "the comparison did not reject the trainer with TF32 products")
    log(f"[20] phase seconds {time.perf_counter() - t_phase:.1f}")


def run_cli(argv):
    """The port's CLI in this process: (exit code, standard error lines)."""
    import contextlib
    import io
    from speechrecognition_torch import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, err.getvalue().splitlines()


def nn_cli_phase(dev, card):
    """Phase 21: the CLI's NN actions with --device cuda on temporary demo
    configs, and t-SNE of hidden activations against the CPU port."""
    from speechrecognition_torch.tools import tsne as tsne_mod

    t_phase = time.perf_counter()
    with open(NN_MODEL) as f:
        m = json.load(f)
    with open(NN_FIXTURE) as f:
        fix = json.load(f)["corpus"]
    with tempfile.TemporaryDirectory() as tmp:
        base = {"corpus": str(FIX / "demo_corpus.json"),
                "feature-path": str(FIX / "demo_features") + "/",
                "normalization-path": str(FIX / "normalization-demo.bin"),
                "target-file": str(FIX / "demo_alignments" / "alignment-2-0.dump"),
                "layers": m["layers"], "context-frames": m["context_frames"],
                "batch-size": 8, "num-epochs": 2, "cv-size": 0.1, "updater": "adadelta",
                "gradient-check": False, "output-dir": os.path.join(tmp, "models"),
                "nn-training-stats-path": os.path.join(tmp, "nn_stats.data"),
                "activations-path": os.path.join(tmp, "activations"),
                "model-path": os.path.join(tmp, "models", "2") + "/",
                "pooling": "none", "feature-scorer": "nn", "tdp-loop": m["tdp"][0],
                "tdp-forward": m["tdp"][1], "tdp-skip": m["tdp"][2],
                "word-penalty": m["word_penalty"], "am-threshold": m["am_threshold"],
                "pruned-search": True, "max-recognition-runs": 10 ** 9}

        def config(name, **overrides):
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump({**base, **overrides}, f)
            return path

        t0 = time.perf_counter()
        rc, err = run_cli([config("train"), "train-nn", "--device", "cuda"])
        secs = time.perf_counter() - t0
        sizes = {e: {layer: os.path.getsize(os.path.join(tmp, "models", e, layer))
                     for layer in ("hidden-layer1", "output-layer")} for e in ("1", "2")}
        with open(os.path.join(tmp, "nn_stats.data")) as f:
            stats = f.read().splitlines()
        log(f"[21] CLI train-nn --device cuda: exit {rc} in {secs:.2f} s; "
            f"{' | '.join(err)}; models/1, models/2 file bytes {sizes}; stats lines {len(stats)}")
        check(rc == 0, "CLI train-nn failed")
        expect = {"hidden-layer1": 4 * (150 * 125 + 150), "output-layer": 4 * (106 * 150 + 106)}
        check(all(s == expect for s in sizes.values()), "train-nn's models are not the raw layout")
        check(len(stats) == 3, "train-nn's stats file has a header and one line an epoch")

        prior = {}
        for device in ("cuda", "cpu"):
            path = config(f"prior-{device}", **{"prior-file": os.path.join(tmp, f"prior-{device}.txt")})
            rc, _ = run_cli([path, "compute-prior", "--device", device])
            check(rc == 0, f"CLI compute-prior --device {device} failed")
            with open(os.path.join(tmp, f"prior-{device}.txt")) as f:
                prior[device] = f.read()
        log(f"[21] CLI compute-prior --device cuda: the same text as --device cpu "
            f"{prior['cuda'] == prior['cpu']} ({len(prior['cuda'].split())} values)")
        check(prior["cuda"] == prior["cpu"], "compute-prior's text differs between the devices")

        rc, err = run_cli([config("recognize", **{
            "model-path": str(REPO / m["model_path"]) + "/",
            "prior-file": str(REPO / m["prior_file"]), "prior-scale": m["prior_scale"]}),
            "recognize", "--device", "cuda"])
        wer_line = f"WER: {fix['wer']:.6f}% (S/I/D) {fix['sid'][0]}/{fix['sid'][1]}/{fix['sid'][2]}"
        log(f"[21] CLI recognize feature-scorer=nn --device cuda: exit {rc}; " + " | ".join(err))
        check(rc == 0, "CLI recognize with the NN scorer failed")
        check(wer_line in err, f"CLI recognize did not print the fixture's line {wer_line!r}")

        rc, err = run_cli([config("plot"), "plot-activations", "--device", "cuda"])
        acts = os.path.join(tmp, "activations")
        labels = np.fromfile(os.path.join(acts, "labels.bin"), np.int32)
        out = np.fromfile(os.path.join(acts, "output-layer.activations"), np.float32)
        hidden = np.fromfile(os.path.join(acts, "hidden-layer1.activations"),
                             np.float32).reshape(labels.size, 150)
        row_err = np.abs(out.reshape(labels.size, 106).sum(axis=1) - 1.0).max()
        log(f"[21] CLI plot-activations --device cuda: exit {rc}; {' | '.join(err)}; output rows "
            f"sum to 1 within {row_err:.2e}")
        check(rc == 0, "CLI plot-activations failed")
        check(np.isfinite(hidden).all() and row_err <= 1e-4,
              "plot-activations' output rows do not sum to 1")

    X = hidden[:TSNE_FRAMES].astype(np.float64)
    check(X.shape[0] == TSNE_FRAMES, "the first batch has 1,000 frames of activations")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y = tsne_mod.tsne(X, perplexity=30.0, device=dev)
    tsne_s = time.perf_counter() - t0
    Xc = X - X.mean(axis=0)
    sq = (Xc * Xc).sum(axis=1)
    P = tsne_mod.binary_search_perplexity(np.maximum(sq[:, None] + sq[None, :] - 2.0 * Xc @ Xc.T,
                                                     0.0), 30.0)
    P = (P + P.T) / P.sum()
    Y0 = np.random.default_rng(0).normal(0, 1e-4, (TSNE_FRAMES, 2))
    worst = {}
    for label, P_run, start in (("from t-SNE's start", 4.0 * P, Y0),
                                ("from the card's embedding", P, Y)):
        got = tsne_mod._tsne_optimize(torch.as_tensor(P_run, device=dev),
                                      torch.as_tensor(start, device=dev),
                                      n_iter=TSNE_STEPS).cpu().numpy()
        ref = tsne_mod._tsne_optimize(torch.as_tensor(P_run), torch.as_tensor(start),
                                      n_iter=TSNE_STEPS).numpy()
        worst[label] = np.abs(got - ref).max() / np.abs(ref).max()
    t0 = time.perf_counter()
    Y_cpu = tsne_mod.tsne(X, perplexity=30.0, device="cpu")
    cpu_s = time.perf_counter() - t0
    d_x = np.maximum(sq[:, None] + sq[None, :] - 2.0 * Xc @ Xc.T, 0.0)
    np.fill_diagonal(d_x, np.inf)
    near_x = np.argsort(d_x, axis=1)[:, :10]
    state = labels[:TSNE_FRAMES]

    def structure(Yr):
        """(KL(P||Q), share of nearest neighbours among the 10 nearest
        activations, share of nearest neighbours with the point's state)."""
        s2 = (Yr * Yr).sum(axis=1)
        d_y = s2[:, None] + s2[None, :] - 2.0 * Yr @ Yr.T
        num = 1.0 / (1.0 + d_y)
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / num.sum(), 1e-12)
        on = P > 0
        np.fill_diagonal(d_y, np.inf)
        nearest = d_y.argmin(axis=1)
        return (float((P[on] * np.log(P[on] / Q[on])).sum()),
                float((near_x == nearest[:, None]).any(axis=1).mean()),
                float((state[nearest] == state).mean()))

    card_st, cpu_st = structure(Y), structure(Y_cpu)
    log(f"[21] t-SNE of {TSNE_FRAMES} frames of hidden-layer1 (500 steps, float64 on the card): "
        f"{tsne_s:.3f} s, finite {bool(np.isfinite(Y).all())}; card against the CPU port, "
        f"{TSNE_STEPS} steps: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" of the scale (tolerance {TSNE_STEP_RTOL:g}); the whole runs (CPU {cpu_s:.2f} s): "
        f"KL {card_st[0]:.6f} / {cpu_st[0]:.6f}, nearest neighbour among the 10 nearest "
        f"activations {card_st[1]:.3f} / {cpu_st[1]:.3f}, of the same state {card_st[2]:.3f} / "
        f"{cpu_st[2]:.3f} (card / CPU; tolerances {TSNE_KL_RTOL:g} relative, "
        f"{TSNE_SHARE_ATOL:g})")
    check(Y.shape == (TSNE_FRAMES, 2) and np.isfinite(Y).all(), "t-SNE on the card")
    check(max(worst.values()) <= TSNE_STEP_RTOL, "t-SNE steps on the card differ from the CPU port's")
    check(abs(card_st[0] - cpu_st[0]) <= TSNE_KL_RTOL * cpu_st[0]
          and abs(card_st[1] - cpu_st[1]) <= TSNE_SHARE_ATOL
          and abs(card_st[2] - cpu_st[2]) <= TSNE_SHARE_ATOL,
          "the card's t-SNE embedding differs in structure from the CPU port's")
    log(f"[21] phase seconds {time.perf_counter() - t_phase:.1f}")


def native_phase():
    """Phase 22: the native corpus loader, built afresh, against the
    pure-Python path on the demo corpus."""
    from speechrecognition_torch.corpus import Corpus, CorpusDescription
    from speechrecognition_torch.features.frontend import SignalAnalysisConfig
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.native import loader

    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), build_sietill_lexicon())

    def read(**kw):
        return Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                           normalization_path=str(FIX / "normalization-demo.bin"), **kw)

    py = read(use_native=False)
    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(loader, "BUILD_DIR", Path(tmp) / "native"):
        t0 = time.perf_counter()
        lib = loader.load()
        build_s = time.perf_counter() - t0
        fresh = loader.library_path()
        nat = read()
    equal = (np.array_equal(nat.feature_offsets, py.feature_offsets)
             and np.array_equal(nat.features.view(np.int32), py.features.view(np.int32)))
    default = loader.library_path()
    log(f"[22] native corpus loader built afresh ({fresh.name}, g++ {build_s:.2f} s; the "
        f"script's own under {default.parent.relative_to(REPO)}: exists {default.exists()}): "
        f"{nat.num_segments} utterances, {nat.total_frames} frames bit-equal to the "
        f"pure-Python path {equal}")
    check(lib is not None and equal, "the native corpus loader differs from the Python path")
    check(default.exists(), "the native loader's library is not under build/native")

#: operations per unit of work of the search tier's scans, what the function
#: needs (not how a kernel reduces). Kernel I per utterance, frame and node:
#: five adds (loop, forward, skip, emission, the renormalisation), five
#: compares (two candidates, one step of the minimum, the prune, one of the
#: word-end argmin) and two guards (the BIG cap, the BIG/2 test); the exit
#: penalty's add at word ends is left out. Kernel J per slot: B's twelve;
#: per word, the min-plus product's W adds and W compares. Kernel K per slot:
#: seven adds (loop, forward, skip, the emission, the entry's two, the
#: renormalisation), five compares (two candidates, the entry, one step of
#: the minimum, the prune) and two guards; with the lookahead five more (the
#: prospect's add, guard, minimum, subtract, compare), with the histogram
#: three (the bin's subtract and multiply, the keep compare); per context and
#: word the end's add and the recombination's compare.
I_NODE_OPS = 5 + 5 + 2
J_SLOT_OPS = B_SLOT_OPS
K_SLOT_OPS = 7 + 5 + 2
K_LA_OPS = 5
K_HIST_OPS = 3
#: phase 25's synthetic shapes past shared memory: a 9,499-node tree (kernel
#: I), a 200 x 24 lattice (J) and a 201 x 722 = 145,122-slot WCTS (K), on a
#: small batch
SEARCH_SCRATCH_B, SEARCH_SCRATCH_T = 4, 40
#: kernel K's configurations at full width: name → wcts_scan options (the
#: demo bigram LM; "lookahead" also with its tables)
K_CONFIGS = {"pruned": {}, "lookahead": {"use_lookahead": True},
             "limit-48": {"state_limit": 48}, "limit-1e6": {"state_limit": 10 ** 6}}
#: feed sizes of phase 26's streams (frames a feed; the word-loop chunk is
#: DECODE_CHUNK, the WCTS chunk 64)
STREAM_FEED = 160
WCTS_CHUNK = 64


def bit_equal(got, ref):
    """Every tensor the same dtype, shape and bits; and the largest float
    difference."""
    same = len(got) == len(ref)
    err = 0.0
    for g, r in zip(got, ref):
        same &= g.dtype == r.dtype and g.shape == r.shape
        if same and g.is_floating_point():
            iv = torch.int64 if g.dtype == torch.float64 else torch.int32
            same &= torch.equal(g.view(iv), r.view(iv))
            both = (g < 1e29) & (r < 1e29)
            if bool(both.any()):
                err = max(err, (g[both].double() - r[both].double()).abs().max().item())
        elif same:
            same &= torch.equal(g, r)
    return bool(same), err


def tree_bound(nb, T, S, N, word):
    nbytes = nb * T * S * word + nb * T * (word + 8) + nb * 4
    ops = nb * T * N * I_NODE_OPS
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def bigram_bound(nb, T, S, W, P, word):
    nbytes = nb * T * S * word + nb * T * W * (word + 8) + nb * T * word + nb * 4
    ops = nb * T * (W * P * J_SLOT_OPS + 2 * W * W)
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def wcts_bound(nb, T, S, C, N, W, word, la=False, hist=False):
    nbytes = (nb * T * S * word + nb * T * W * (word + 8) + nb * T * word
              + 2 * nb * (C * N * (word + 4) + W * word + C * (word + 4)) + nb * 4)
    slot = K_SLOT_OPS + (K_LA_OPS if la else 0) + (K_HIST_OPS if hist else 0)
    ops = nb * T * (C * N * slot + 2 * C * W)
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


#: __syncthreads a frame of kernel I's instances: the owner instance (one),
#: the block instance (the first design: the minimum twice, the argmin
#: twice, the book)
I_BARRIERS = {"owner": 1, "block": 5}


def ptxas_usage(fragment):
    """Registers and spills of the kernel whose mangled name holds
    ``fragment``, as -Xptxas -v printed them in this run's build."""
    from speechrecognition_torch.ops import _native
    name, found = "", []
    for line in _native.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif fragment in name and ("Used" in line or "spill stores" in line):
            found.append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return "; ".join(found) or "not reported"


def i_designs(lib, card, am, lens, args, ref, nb, T, N, dt):
    """Kernel I at full width: the instance its C entry chooses (the owner
    instance), and the first design (the block instance, forced) bit-equal to
    the plain version; both timed in turns (first, owner, owner, first), with
    their registers and spills, residency, waves and barriers a frame.
    Returns (first design ms, its max abs error against the plain version)."""
    from speechrecognition_torch.search import tree_decoder as td
    f64 = int(dt == torch.float64)
    k = lib.sr_tree_scan_instance(N, f64)
    check(k > 0, f"kernel I {dt} at N {N} did not choose its owner instance")
    first, scratch = td.tree_scan_cuda(am, lens, *args, 200.0, first_design=True)
    torch.cuda.synchronize()
    same, err = bit_equal(first, ref)
    check(same and not scratch, f"kernel I's first design {dt} is not bit-equal to its plain "
          f"version")
    new_ms, first_ms, all_ = in_turns(
        lambda: td.tree_scan_cuda(am, lens, *args, 200.0, first_design=True),
        lambda: td.tree_scan(am, lens, *args, 200.0), 5, 5)
    per_sm = lib.sr_tree_scan_residency(N, f64, 0)
    per_sm_first = lib.sr_tree_scan_residency(N, f64, 1)
    lanes = -(-N // k)
    threads = -(-lanes // 32) * 32
    ty = "d" if f64 else "f"
    log(f"[23] kernel I {dt}: owner instance, {k} nodes a lane, {threads} threads "
        f"({ptxas_usage(f'tree_scan_owner_kernelI{ty}Li{k}E')}), {per_sm} utterances an SM, "
        f"{waves(nb, per_sm)} wave(s), {I_BARRIERS['owner']} barrier a frame; first design "
        f"(block instance, {-(-N // 32) * 32} threads, "
        f"{ptxas_usage(f'tree_scan_kernelI{ty}E')}): {per_sm_first} an SM, "
        f"{waves(nb, per_sm_first)} wave(s), {I_BARRIERS['block']} barriers a frame, bit-equal "
        f"{same}; in turns (first, owner, owner, first: {', '.join(f'{v:.4f}' for v in all_)} "
        f"ms): first design {first_ms:.4f} ms ({first_ms / T * 1e3:.3f} us a frame) -> owner "
        f"instance {new_ms:.4f} ms ({new_ms / T * 1e3:.3f} us a frame) on {card}")
    # the C entry launches the owner instance at this size: it must be the faster
    check(new_ms < first_ms, f"kernel I {dt}: the owner instance ({new_ms:.4f} ms) is not "
          f"faster than the first design ({first_ms:.4f} ms)")
    return first_ms, err


#: __syncthreads a frame of kernel J's instances: the warp instance (one),
#: the block instance (the first design: entries, minimum twice, word ends)
J_BARRIERS = {"warp": 1, "block": 3}


def j_designs(lib, card, am, lens, jargs, ref, nb, T, W, P, dt):
    """Kernel J at full width: the instance its C entry chooses, and the
    first design (the block instance, forced) bit-equal to the plain
    version; both timed in turns (first, chosen, chosen, first), with their
    residency, waves and barriers a frame."""
    from speechrecognition_torch.search import ngram_decoder as ng
    f64 = int(dt == torch.float64)
    inst = lib.sr_decode_scan_bigram_instance(W, P, f64)
    check(inst > 0, f"kernel J {dt} at {W} x {P} did not choose its warp instance")
    first, _scratch = ng.decode_scan_bigram_cuda(am, lens, *jargs, 200.0, first_design=True)
    torch.cuda.synchronize()
    same, _err = bit_equal(first, ref)
    check(same, f"kernel J's first design {dt} is not bit-equal to its plain version")
    new_ms, first_ms, all_ = in_turns(
        lambda: ng.decode_scan_bigram_cuda(am, lens, *jargs, 200.0, first_design=True),
        lambda: ng.decode_scan_bigram(am, lens, *jargs, 200.0), 5, 5)
    per_sm = lib.sr_decode_scan_bigram_residency(W, P, f64, 0)
    per_sm_first = lib.sr_decode_scan_bigram_residency(W, P, f64, 1)
    log(f"[24] kernel J {dt}: {instance('sr_decode_scan_bigram_instance', W, P, f64)}, "
        f"{-(-W // 4) * 32} threads, {per_sm} utterances an SM, {waves(nb, per_sm)} wave(s), "
        f"{J_BARRIERS['warp']} barrier a frame; first design (block instance, "
        f"{-(-W * P // 32) * 32} threads): {per_sm_first} an SM, {waves(nb, per_sm_first)} "
        f"wave(s), {J_BARRIERS['block']} barriers a frame, bit-equal {same}; in turns (first, "
        f"warp, warp, first: {', '.join(f'{v:.4f}' for v in all_)} ms): first design "
        f"{first_ms:.4f} ms ({first_ms / T * 1e3:.3f} us a frame) -> warp instance "
        f"{new_ms:.4f} ms ({new_ms / T * 1e3:.3f} us a frame) on {card}")


def k_barriers(first, la, hist):
    """__syncthreads a frame of kernel K's owner instance (the minimum, the
    word ends; one more for the lookahead's minimum and one for the
    histogram's counts) and of its block instance (the first design)."""
    if first:
        return 5 + 2 * la + 2 * hist
    return 2 + la + hist


def k_threads(C, N, spt):
    """Threads a block of kernel K's owner instance at ``spt`` contexts a
    thread: a thread a node (whole warps) in each group of contexts."""
    return -(-C // spt) * (-(-N // 32) * 32)


#: contexts a thread of the owner instance's sweep on SieTill (its C entry
#: chooses 16: one thread a node in all 13 contexts; 8: two threads a node)
K_SWEEP = (8, 16)


def k_designs(lib, card, name, am, lens, kargs, opts, ref, nb, T, C, N, W, S, dt):
    """Kernel K at full width in one configuration: the instance its C entry
    chooses, and the first design (the block instance, forced) bit-equal to
    the plain version; both timed in turns (first, chosen, chosen, first),
    with residency, waves and barriers a frame; for the pruned scans, the
    owner instance at each of K_SWEEP's contexts a thread."""
    from speechrecognition_torch.search import histogram
    from speechrecognition_torch.search import wcts as wc
    f64 = int(dt == torch.float64)
    la, hist = bool(opts.get("use_lookahead")), bool(opts.get("state_limit"))
    bins = histogram.DEFAULT_BINS if hist else 0
    inst = lib.sr_wcts_scan_instance(C, N, W, S, bins, f64)
    check(inst > 0, f"kernel K {name} at C {C} x N {N} did not choose its owner instance")

    def forced(force):
        return lambda: wc.wcts_scan_cuda(am, lens, *kargs, 200.0, force=force, **opts)

    carry, outs, _scratch = forced(1)()
    torch.cuda.synchronize()
    same, _err = bit_equal(list(carry) + list(outs), list(ref[0]) + list(ref[1]))
    check(same, f"kernel K's first design {name} is not bit-equal to its plain version")
    new_ms, first_ms, all_ = in_turns(forced(1), lambda: wc.wcts_scan(am, lens, *kargs, 200.0,
                                                                     **opts), 2, 3)
    per_sm = lib.sr_wcts_scan_residency(C, N, W, S, bins, f64, int(la), 0)
    per_sm_first = lib.sr_wcts_scan_residency(C, N, W, S, bins, f64, int(la), 1)
    log(f"[25] kernel K {name}: {instance('sr_wcts_scan_instance', C, N, W, S, bins, f64)}, "
        f"{k_threads(C, N, inst)} threads, {per_sm} utterances an SM, {waves(nb, per_sm)} wave(s), "
        f"{k_barriers(False, la, hist)} barriers a frame; first design (block instance, "
        f"{min(-(-C * N // 32) * 32, 512)} threads): {per_sm_first} an SM, "
        f"{waves(nb, per_sm_first)} wave(s), {k_barriers(True, la, hist)} barriers a frame, "
        f"bit-equal {same}; in turns (first, owner, owner, first: "
        f"{', '.join(f'{v:.4f}' for v in all_)} ms): first design {first_ms:.4f} ms "
        f"({first_ms / T * 1e3:.3f} us a frame) -> owner instance {new_ms:.4f} ms "
        f"({new_ms / T * 1e3:.3f} us a frame) on {card}")
    if name not in ("pruned", "pruned[f64]"):
        return
    for spt in K_SWEEP:
        ms = cuda_ms(forced(spt), 3)
        per = lib.sr_wcts_scan_residency(C, N, W, S, bins, f64, int(la), spt)
        log(f"[25] kernel K owner sweep, {name} {dt}: {spt} contexts a thread, "
            f"{k_threads(C, N, spt)} threads, {per} utterances an SM, "
            f"{waves(nb, per)} wave(s): {ms:.4f} ms ({ms / T * 1e3:.3f} us a frame) on {card}")


def golden_check(tag, res, golden):
    mism = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
    sid = [res["substitutions"], res["insertions"], res["deletions"]]
    log(f"{tag}: WER {res['wer']:.6f} % SER {res['ser']:.6f} % S/I/D {sid[0]}/{sid[1]}/"
        f"{sid[2]}, {len(mism)} mismatches of 35")
    check(not mism, f"{tag}: golden transcripts differ at {mism}")
    check(abs(res["wer"] - golden["corpus"]["wer"]) < 1e-5, f"{tag}: golden WER")
    check(abs(res["ser"] - golden["corpus"]["ser"]) < 1e-9, f"{tag}: golden SER")
    check(sid == golden["corpus"]["sid"], f"{tag}: golden S/I/D")


def search_phases(dev, card, lex, corpus, big, iter2, bench, tdp, wordloop_hyps):
    """Phases 23-26: the search tier at full width — kernel I (tree search)
    and the Recognizer's search-type=tree, kernel J (the bigram decode),
    kernel K (WCTS, with lookahead and histogram pruning, the lattice path,
    transparent silence), every scan past shared memory, and streaming with
    1,024 streams. Returns the kernels line's entries of I, J and K."""
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.search import online
    from speechrecognition_torch.search import tree_decoder as td
    from speechrecognition_torch.search import wcts as wc

    st = tables_module("torch_search_tables")
    entries = []
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    nb = FULL_BATCH
    T = dec.Recognizer(Configuration(SETTINGS), lex, tdp, None)._bucket(big.max_seq_length)
    ids = list(range(nb))
    feats_np, lens_np = big.padded_batch(ids, pad_to=T)
    lens_np = np.asarray(lens_np)
    feats = torch.as_tensor(feats_np, device=dev)
    lens = torch.as_tensor(lens_np, dtype=torch.int32, device=dev)
    packs = {torch.float32: bench.pack(method="pallas", device=dev),
             torch.float64: bench.pack(dtype=torch.float64, device=dev)}
    ams = {dt: gmm.am_scores(p, feats.reshape(-1, 25)).reshape(nb, T, -1).to(dt).contiguous()
           for dt, p in packs.items()}
    S = ams[torch.float32].shape[2]
    word_of = {torch.float32: 4, torch.float64: 8}
    tag_of = {torch.float32: "", torch.float64: "[f64]"}
    settings = {**SETTINGS, "search-type": "tree"}

    # -- 23. kernel I and search-type=tree ---------------------------------------------
    t_phase = time.perf_counter()
    tree = td.TreeTables.build(lex, tdp, SETTINGS["word-penalty"])
    N = tree.num_nodes
    lib = _native.load()
    i_meas, i_first = {}, {}
    for dt in (torch.float32, torch.float64):
        args = tree.device_args(dev, dt, S)
        am = ams[dt]
        got = td.tree_scan(am, lens, *args, 200.0)
        ref = td.tree_scan_reference(am, lens, *args, 200.0)
        torch.cuda.synchronize()
        same, err = bit_equal(got, ref)
        check(same, f"kernel I {dt} is not bit-equal to its plain version at full width")
        ms, plain_ms, all_ = in_turns(lambda: td.tree_scan_reference(am, lens, *args, 200.0),
                                      lambda: td.tree_scan(am, lens, *args, 200.0), 1, 5)
        bnd = tree_bound(nb, T, S, N, word_of[dt])
        i_meas[dt] = (err, ms, plain_ms, bnd)
        log(f"[23] kernel I {dt} B={nb} T={T} S={S} N={N}: bit-equal to plain {same}, max abs "
            f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain, kernel, kernel, "
            f"plain: {', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms ({bnd[1]}); "
            f"per frame {ms / T * 1e3:.3f} us on {card}")
        i_first[dt] = i_designs(lib, card, am, lens, args, ref, nb, T, N, dt)
    del got, ref

    tree_launches = {}
    tree_scratch = {}
    for dt in (torch.float32, torch.float64):
        demo_pack = (iter2.pack(method="pallas", device=dev) if dt == torch.float32
                     else iter2.pack(dtype=torch.float64, device=dev))
        rec35 = dec.Recognizer(Configuration(settings), lex, tdp, demo_pack, dtype=dt)
        before = td.tree_scan.LAUNCHES
        res = rec35.recognize_corpus(corpus, batch_size=35)
        golden_check(f"[23] golden iter-2.mix tree {dt}", res, golden)
        check(td.tree_scan.LAUNCHES > before, "the golden tree run skipped kernel I")
        rec = dec.Recognizer(Configuration(settings), lex, tdp, packs[dt], dtype=dt)
        hyps35 = rec.recognize_corpus(corpus, batch_size=35)["hyps"]
        rec.warmup(big, batch_size=nb)
        torch.cuda.synchronize()
        td.tree_scan.LAUNCHES = td.tree_scan.SCRATCH_LAUNCHES = 0
        res = rec.recognize_corpus(big, batch_size=nb)
        tree_launches[dt] = td.tree_scan.LAUNCHES
        tree_scratch[dt] = td.tree_scan.SCRATCH_LAUNCHES
        with mock.patch.object(td, "tree_scan", td.tree_scan_reference):
            res_plain = rec.recognize_corpus(big, batch_size=nb)
        diff = [s for s in ids if res["hyps"][s] != res_plain["hyps"][s]]
        vs35 = [s for s in ids if res["hyps"][s] != hyps35[s % 35]]
        vs_loop = [s for s in ids if res["hyps"][s] != wordloop_hyps[s]]
        log(f"[23] full width tree {dt}, {nb} utterances: {res['time']:.4f} s, RTF "
            f"{res['rtf']:.3e} (plain {res_plain['time']:.4f} s); kernel-vs-plain transcript "
            f"differences {len(diff)}, differences from the 35-utterance run {len(vs35)}; "
            f"transcripts that differ from phase 6's f32 word-loop decode {len(vs_loop)} (not a "
            f"gate); launches tree_scan {tree_launches[dt]} on {card}")
        check(tree_launches[dt] > 0, f"the full-width tree decode {dt} skipped kernel I")
        if dt == torch.float32:
            with torch.profiler.profile(activities=PROFILED) as prof:
                res_prof = rec.recognize_corpus(big, batch_size=nb)
            log_profile("[23] tree f32", prof, res_prof["time"])
            check(res_prof["hyps"] == res["hyps"], "the profiled tree decode changed a transcript")
            del prof
        check(not diff, f"tree {dt}: kernel and plain transcripts differ at {diff[:10]}")
        check(not vs35, f"tree {dt}: full width differs from the 35-utterance run at {vs35[:10]}")
    del res_plain

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "tree.json")
        with open(cfg_path, "w") as f:
            json.dump({"corpus": str(FIX / "demo_corpus.json"),
                       "feature-path": str(FIX / "demo_features") + "/",
                       "normalization-path": str(FIX / "normalization-demo.bin"),
                       "load-mixtures-from": str(FIX / "iter-2.mix"), "pooling": "mixture",
                       "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0, **settings}, f)
        rc, err_lines = run_cli([cfg_path, "recognize", "--device", "cuda"])
    log(f"[23] CLI recognize search-type=tree --device cuda: exit {rc}; "
        + " | ".join(ln for ln in err_lines if ln.split(":")[0] in ("WER", "SER")))
    check(rc in (0, None), "CLI recognize with search-type=tree failed")
    check("WER: 19.587629% (S/I/D) 4/14/1" in err_lines, "CLI tree recognize golden WER line")
    log(f"[23] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 24. kernel J at full width -------------------------------------------------------
    t_phase = time.perf_counter()
    lm, lm_start = st.demo_bigram_lm()
    lin = dec.DecoderTables.build(lex, tdp, 0.0)
    W, P = lin.state_table.shape
    j_meas, j_launches, j_scratch = {}, {}, {}
    for dt in (torch.float32, torch.float64):
        jargs = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                 for a in (lin.state_table, lin.last_pos, lin.word_len)]
        jargs += [torch.as_tensor(a, dtype=dt, device=dev)
                  for a in (lin.tdp_within, lin.entry_pen, lm, lm_start)]
        am = ams[dt]
        got = ng.decode_scan_bigram(am, lens, *jargs, 200.0)
        ref = ng.decode_scan_bigram_reference(am, lens, *jargs, 200.0)
        torch.cuda.synchronize()
        same, err = bit_equal(got, ref)
        check(same, f"kernel J {dt} is not bit-equal to its plain version at full width")
        ms, plain_ms, all_ = in_turns(
            lambda: ng.decode_scan_bigram_reference(am, lens, *jargs, 200.0),
            lambda: ng.decode_scan_bigram(am, lens, *jargs, 200.0), 1, 5)
        bnd = bigram_bound(nb, T, S, W, P, word_of[dt])
        j_meas[dt] = (err, ms, plain_ms, bnd)
        j_designs(lib, card, am, lens, jargs, ref, nb, T, W, P, dt)
        ng.decode_scan_bigram.LAUNCHES = ng.decode_scan_bigram.SCRATCH_LAUNCHES = 0
        t0 = time.perf_counter()
        hyps_j = ng.decode_batch_bigram(None, feats_np, lens_np, lin, lm, lm_start, 200.0,
                                        lex.silence_idx, dtype=dt, am=am)
        j_launches[dt] = ng.decode_scan_bigram.LAUNCHES
        j_scratch[dt] = ng.decode_scan_bigram.SCRATCH_LAUNCHES
        log(f"[24] kernel J {dt} B={nb} T={T} W={W} P={P} (demo bigram LM): bit-equal to plain "
            f"{same}, max abs {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (plain, "
            f"kernel, kernel, plain: {', '.join(f'{v:.4f}' for v in all_)}); bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); per frame {ms / T * 1e3:.3f} us; decode_batch_bigram "
            f"{time.perf_counter() - t0:.4f} s, launches {j_launches[dt]} on {card}")
        check(j_launches[dt] > 0, f"the full-width bigram decode {dt} skipped kernel J")
        if dt == torch.float64:
            hyps_j64 = hyps_j
    del got, ref
    log(f"[24] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 25. kernel K at full width, the lattice path, scratch ---------------------------
    t_phase = time.perf_counter()
    tree0 = td.TreeTables.build(lex, tdp, 0.0)
    la_tables = wc.LookaheadTables.build(tree0)
    k_meas, k_launches = {}, {}
    C = lex.num_words + 1
    for name, opts in list(K_CONFIGS.items()) + [("pruned[f64]", {})]:
        dt = torch.float64 if name.endswith("[f64]") else torch.float32
        wt = wc.WctsTables.build(tree0, tdp, lm, lm_start,
                                 la_tables if opts.get("use_lookahead") else None)
        kargs = wt.args(dev, dt, S)
        am = ams[dt]
        got = wc.wcts_scan(am, lens, *kargs, 200.0, **opts)
        ref = wc.wcts_scan_reference(am, lens, *kargs, 200.0, **opts)
        torch.cuda.synchronize()
        same, err = bit_equal(list(got[0]) + list(got[1]), list(ref[0]) + list(ref[1]))
        check(same, f"kernel K {name} is not bit-equal to its plain version at full width")
        ms, plain_ms, all_ = in_turns(
            lambda: wc.wcts_scan_reference(am, lens, *kargs, 200.0, **opts),
            lambda: wc.wcts_scan(am, lens, *kargs, 200.0, **opts), 1, 3)
        bnd = wcts_bound(nb, T, S, C, N, lex.num_words, word_of[dt],
                         la=bool(opts.get("use_lookahead")), hist=bool(opts.get("state_limit")))
        k_meas[name] = (err, ms, plain_ms, bnd)
        k_designs(lib, card, name, am, lens, kargs, opts, ref, nb, T, C, N, lex.num_words, S, dt)
        # the main path: decode_batch_wcts at full width with these options
        wc.wcts_scan.LAUNCHES = wc.wcts_scan.SCRATCH_LAUNCHES = 0
        t0 = time.perf_counter()
        hyps_k = wc.decode_batch_wcts(
            None, feats_np, lens_np, tree0, tdp, lm, lm_start, 200.0, lex.silence_idx,
            lookahead=la_tables if opts.get("use_lookahead") else None,
            state_limit=opts.get("state_limit", 0), dtype=dt, am=am)
        k_launches[name] = (wc.wcts_scan.LAUNCHES, wc.wcts_scan.SCRATCH_LAUNCHES)
        dec_s = time.perf_counter() - t0
        if name == "pruned":
            hyps_k32 = hyps_k
        if name == "lookahead":
            with torch.profiler.profile(activities=PROFILED) as prof:
                t0 = time.perf_counter()
                hyps_prof = wc.decode_batch_wcts(
                    packs[dt], feats_np, lens_np, tree0, tdp, lm, lm_start, 200.0,
                    lex.silence_idx, lookahead=la_tables, dtype=dt)
                prof_s = time.perf_counter() - t0
            log_profile("[25] WCTS lookahead f32 from features", prof, prof_s)
            k_dev, k_n = kernel_device_ms(prof, "wcts_owner_kernel")
            log(f"[25] WCTS lookahead f32 from features: kernel K (owner instance) {k_dev:.4f} ms "
                f"of device time in {k_n} launch(es), decode {prof_s:.4f} s on {card}")
            check(k_n == 1, "the profiled WCTS decode did not run K's owner instance once")
            check(hyps_prof == hyps_k, "the profiled WCTS decode changed a transcript")
            del prof
        vs_j = ""
        if name == "pruned[f64]":
            differ = [s for s in ids if hyps_k[s] != hyps_j64[s]]
            vs_j = f"; transcripts that differ from kernel J's f64 decode {len(differ)}"
            check(not differ, f"f64 WCTS differs from the bigram decode at {differ[:10]}")
        log(f"[25] kernel K {name} B={nb} T={T} C={C} N={N} ({C * N} slots): bit-equal to plain "
            f"{same} (carry and outputs), max abs {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (plain, kernel, kernel, plain: "
            f"{', '.join(f'{v:.4f}' for v in all_)}); bound {bnd[0]:.4f} ms ({bnd[1]}); per "
            f"frame {ms / T * 1e3:.3f} us; decode_batch_wcts {dec_s:.4f} s, launches "
            f"{k_launches[name][0]}{vs_j} on {card}")
        check(k_launches[name][0] > 0, f"the full-width WCTS decode {name} skipped kernel K")
        if name == "limit-1e6":
            check(hyps_k == hyps_k32, "state_limit 10^6 changed a full-width transcript")
        if name == "limit-48":
            kept = sum(a == b for a, b in zip(hyps_k, hyps_k32))
            log(f"[25] state_limit 48 keeps {kept} of {nb} full-width transcripts")
    del got, ref

    # the 35 demo utterances: every output option bit-equal, golden and bigram checks
    demo_feats, demo_lens = corpus.padded_batch(list(range(35)))
    demo_lens = np.asarray(demo_lens)
    for dt in (torch.float32, torch.float64):
        demo_pack = (iter2.pack(method="pallas", device=dev) if dt == torch.float32
                     else iter2.pack(dtype=torch.float64, device=dev))
        dam = gmm.am_scores(demo_pack, torch.as_tensor(demo_feats, device=dev).reshape(-1, 25))
        dam = dam.reshape(35, demo_feats.shape[1], -1).to(dt).contiguous()
        dlens = torch.as_tensor(demo_lens, dtype=torch.int32, device=dev)
        wt = wc.WctsTables.build(tree0, tdp, lm, lm_start, la_tables)
        kargs = wt.args(dev, dt, S)
        opts = {"use_lookahead": True, "state_limit": 40, "emit_ends": True, "emit_stats": True,
                "transparent_silence": lex.silence_idx}
        half = dam.shape[1] // 2
        outs_k, outs_p = [], []
        for fn, outs in ((wc.wcts_scan, outs_k), (wc.wcts_scan_reference, outs_p)):
            carry, parts = None, []
            for t0, n in ((0, half), (half, dam.shape[1] - half)):
                carry, o = fn(dam[:, t0:t0 + n].contiguous(), dlens, *kargs, 200.0,
                              carry_in=carry, t0=t0, **opts)
                parts.append(o)
            outs.extend(list(carry) + [torch.cat([o[k] for o in parts])
                                       for k in range(len(parts[0]))])
        torch.cuda.synchronize()
        same, _err = bit_equal(outs_k, outs_p)
        check(same, f"kernel K {dt} with emit_ends, emit_stats and transparent silence is not "
                    f"bit-equal to its plain version")
        uni = wc.decode_batch_wcts(demo_pack, demo_feats, demo_lens, tree0, tdp,
                                   *st.uniform_lm(lex), 200.0, lex.silence_idx, dtype=dt)
        gold = [u["hyp"] for u in sorted(golden["utts"], key=lambda u: u["idx"])]
        check(uni == gold, f"uniform-LM WCTS {dt} differs from the golden transcripts")
        msg = ""
        for prune in (True, False):
            kw = wc.decode_batch_wcts(demo_pack, demo_feats, demo_lens, tree0, tdp, lm,
                                      lm_start, 200.0, lex.silence_idx, prune=prune, dtype=dt)
            jw = ng.decode_batch_bigram(demo_pack, demo_feats, demo_lens, lin, lm, lm_start,
                                        200.0, lex.silence_idx, prune=prune, dtype=dt)
            differ = [b for b in range(35) if kw[b] != jw[b]]
            msg += f"; WCTS vs bigram decode ({'pruned' if prune else 'unpruned'}) differ {len(differ)}"
            if dt == torch.float64:
                check(not differ, f"f64 WCTS differs from the bigram decode (prune={prune})")
        hy, lats, stats = wc.decode_batch_wcts(
            demo_pack, demo_feats, demo_lens, tree0, tdp, lm, lm_start, 200.0,
            lex.silence_idx, lookahead=la_tables, dtype=dt, emit_lattice=True, emit_stats=True)
        best_ok = all(lats[b].best_words() == hy[b] for b in range(35))
        if dt == torch.float64:   # the lattice sums float32 arc scores in float64
            check(best_ok, "f64: a lattice's best path differs from the decoder's 1-best")
        log(f"[25] 35 demo utterances {dt}: emit_ends + emit_stats + transparent silence + "
            f"lookahead + state_limit 40 bit-equal over 2 chunks with carry {same}; uniform-LM "
            f"WCTS golden 35/35{msg}; lattice best paths equal the 1-best {best_ok}; active "
            f"states per frame {stats['active_states'].mean():.1f}")

    # every scan past shared memory (device scratch), small batch, two chunks for K
    sb, sT = SEARCH_SCRATCH_B, SEARCH_SCRATCH_T
    slens = torch.as_tensor([sT, 23, 0, sT - 1], dtype=torch.int32, device=dev)
    big_lex = st.PrefixLexicon(2000, 3, max_len=16, branch=4)
    big_tree = td.TreeTables.build(big_lex, st.prefix_tdp(big_lex), 15.0)
    wide, S_w = st.wide_linear_tables(200, 8, 3)
    wlex = st.PrefixLexicon(200, 2)
    wlm, wlm_start = st.random_lm(wlex.num_words, seed=2)
    _t, wwt = st.wcts_inputs(wlex, st.prefix_tdp(wlex), wlm, wlm_start, lookahead=True)
    for dt in (torch.float32, torch.float64):
        tag = tag_of[dt]
        # kernel I
        am = st.am_scores(sb, sT, big_lex.num_states, seed=1, dtype=dt, device=dev)
        args = big_tree.device_args(dev, dt, big_lex.num_states)
        check(lib.sr_tree_scan_instance(big_tree.num_nodes, int(dt == torch.float64)) == -1,
              f"kernel I {dt} at N {big_tree.num_nodes}: not the block instance in scratch")
        before = td.tree_scan.SCRATCH_LAUNCHES
        same, err = bit_equal(td.tree_scan(am, slens, *args, 60.0),
                              td.tree_scan_reference(am, slens, *args, 60.0))
        check(same and td.tree_scan.SCRATCH_LAUNCHES == before + 1,
              f"kernel I {dt} in scratch: bit-equal {same}")
        ms, plain_ms, _a = in_turns(lambda: td.tree_scan_reference(am, slens, *args, 60.0),
                                    lambda: td.tree_scan(am, slens, *args, 60.0), 1, 5)
        bnd = tree_bound(sb, sT, big_lex.num_states, big_tree.num_nodes, word_of[dt])
        log(f"[25] kernel I {dt} in device scratch, N={big_tree.num_nodes} B={sb} T={sT}: "
            f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); per frame {ms / sT * 1e3:.3f} us on {card}")
        entries.append(entry(f"tree_scan{tag}[N={big_tree.num_nodes}]", "tree_scan.cu",
                             "speechrecognition_tpu/search/tree_decoder.py:124",
                             tree_scratch[dt], err, ms, plain_ms, bnd))
        # kernel J
        Ww, Pw = wide.state_table.shape
        am = st.am_scores(sb, sT, S_w, seed=2, dtype=dt, device=dev)
        wlm_j, wstart_j = st.random_lm(Ww, seed=3)
        jargs = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                 for a in (wide.state_table, wide.last_pos, wide.word_len)]
        jargs += [torch.as_tensor(a, dtype=dt, device=dev)
                  for a in (wide.tdp_within, wide.entry_pen, wlm_j, wstart_j)]
        before = ng.decode_scan_bigram.SCRATCH_LAUNCHES
        same, err = bit_equal(ng.decode_scan_bigram(am, slens, *jargs, 60.0),
                              ng.decode_scan_bigram_reference(am, slens, *jargs, 60.0))
        check(same and ng.decode_scan_bigram.SCRATCH_LAUNCHES == before + 1,
              f"kernel J {dt} in scratch: bit-equal {same}")
        ms, plain_ms, _a = in_turns(
            lambda: ng.decode_scan_bigram_reference(am, slens, *jargs, 60.0),
            lambda: ng.decode_scan_bigram(am, slens, *jargs, 60.0), 1, 5)
        bnd = bigram_bound(sb, sT, S_w, Ww, Pw, word_of[dt])
        log(f"[25] kernel J {dt} in device scratch, W*P={Ww}x{Pw}={Ww * Pw} B={sb} T={sT}: "
            f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); per frame {ms / sT * 1e3:.3f} us on {card}")
        entries.append(entry(f"decode_scan_bigram{tag}[W*P={Ww * Pw}]", "decode_scan_bigram.cu",
                             "speechrecognition_tpu/search/ngram_decoder.py:39",
                             j_scratch[dt], err, ms, plain_ms, bnd))
        # kernel K, two chunks with carry, every option
        am = st.am_scores(sb, sT, wlex.num_states, seed=3, dtype=dt, device=dev)
        kargs = wwt.args(dev, dt, wlex.num_states)
        opts = {"use_lookahead": True, "state_limit": 500, "emit_ends": True,
                "emit_stats": True, "transparent_silence": 0}
        outs = []
        before = wc.wcts_scan.SCRATCH_LAUNCHES
        for fn in (wc.wcts_scan, wc.wcts_scan_reference):
            carry, parts = None, []
            for t0, n in ((0, 15), (15, sT - 15)):
                carry, o = fn(am[:, t0:t0 + n].contiguous(), slens, *kargs, 60.0,
                              carry_in=carry, t0=t0, **opts)
                parts.append(o)
            outs.append(list(carry) + [torch.cat([o[k] for o in parts])
                                       for k in range(len(parts[0]))])
        same, err = bit_equal(*outs)
        check(same and wc.wcts_scan.SCRATCH_LAUNCHES == before + 2,
              f"kernel K {dt} in scratch: bit-equal {same}")
        ms, plain_ms, _a = in_turns(
            lambda: wc.wcts_scan_reference(am, slens, *kargs, 60.0, use_lookahead=True),
            lambda: wc.wcts_scan(am, slens, *kargs, 60.0, use_lookahead=True), 1, 5)
        Cw, Nw = wwt.num_contexts, wwt.tables.num_nodes
        bnd = wcts_bound(sb, sT, wlex.num_states, Cw, Nw, wlex.num_words, word_of[dt], la=True)
        log(f"[25] kernel K {dt} in device scratch, C*N={Cw}x{Nw}={Cw * Nw} B={sb} T={sT}: "
            f"bit-equal over 2 chunks with every option; lookahead scan kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); per frame "
            f"{ms / sT * 1e3:.3f} us on {card}")
        entries.append(entry(f"wcts_scan{tag}[C*N={Cw * Nw}]", "wcts_scan.cu",
                             "speechrecognition_tpu/search/wcts.py:156",
                             k_launches["pruned[f64]" if dt == torch.float64 else "pruned"][1],
                             err, ms, plain_ms, bnd))
    log(f"[25] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 26. streaming with 1,024 streams --------------------------------------------------
    t_phase = time.perf_counter()
    word_tables = dec.DecoderTables.build(lex, tdp, SETTINGS["word-penalty"])
    packdf = bench.pack_df(device=dev)
    for kind, pack, dt in (("f32", packs[torch.float32], torch.float32),
                           ("f64", packs[torch.float64], torch.float64),
                           ("df32", packdf, "df32")):
        rec = dec.Recognizer(Configuration(SETTINGS), lex, tdp, pack, dtype=dt)
        offline = rec.recognize_corpus(big, batch_size=nb)["hyps"]
        stream = online.OnlineRecognizer(pack, word_tables, 200.0, lex.silence_idx, dtype=dt,
                                         num_streams=nb)
        for start in range(0, T, STREAM_FEED):
            stream.feed(feats_np[:, start:start + STREAM_FEED])
            stream.partial(lens_np)
        got = stream.finish(lens_np)
        differ = [s for s in ids if got[s] != offline[s]]
        ls = stream.latency_stats
        log(f"[26] OnlineRecognizer {kind}, {nb} streams, feeds of {STREAM_FEED} frames, chunk "
            f"{stream.chunk}: {len(differ)} transcripts differ from the offline Recognizer; "
            f"commit p50 {ls['commit']['p50_s'] * 1e3:.2f} ms max "
            f"{ls['commit']['max_s'] * 1e3:.2f} ms ({ls['commit']['n']}), partial p50 "
            f"{ls['partial']['p50_s'] * 1e3:.2f} ms max {ls['partial']['max_s'] * 1e3:.2f} ms "
            f"({ls['partial']['n']}) on {card}")
        check(not differ, f"online {kind} differs from offline at {differ[:10]}")
    stream = online.OnlineWctsRecognizer(packs[torch.float32], tree0, tdp, lm, lm_start, 200.0,
                                         lex.silence_idx, lookahead=la_tables,
                                         dtype=torch.float32, num_streams=nb, chunk=WCTS_CHUNK)
    offline = wc.decode_batch_wcts(packs[torch.float32], feats_np, lens_np, tree0, tdp, lm,
                                   lm_start, 200.0, lex.silence_idx, lookahead=la_tables,
                                   dtype=torch.float32)
    before = wc.wcts_scan.LAUNCHES
    for start in range(0, T, STREAM_FEED):
        stream.feed(feats_np[:, start:start + STREAM_FEED])
        stream.partial(lens_np)
    got = stream.finish(lens_np)
    differ = [s for s in ids if got[s] != offline[s]]
    ls = stream.latency_stats
    log(f"[26] OnlineWctsRecognizer f32 with lookahead, {nb} streams, chunk {WCTS_CHUNK}: "
        f"{len(differ)} transcripts differ from decode_batch_wcts; kernel K launches "
        f"{wc.wcts_scan.LAUNCHES - before}; commit p50 {ls['commit']['p50_s'] * 1e3:.2f} ms "
        f"max {ls['commit']['max_s'] * 1e3:.2f} ms ({ls['commit']['n']}), partial p50 "
        f"{ls['partial']['p50_s'] * 1e3:.2f} ms max {ls['partial']['max_s'] * 1e3:.2f} ms "
        f"({ls['partial']['n']}) on {card}")
    check(not differ, f"online WCTS differs from offline at {differ[:10]}")
    log(f"[26] phase seconds {time.perf_counter() - t_phase:.1f}")

    scratch = {"tree_scan": tree_scratch, "decode_scan_bigram": j_scratch,
               "wcts_scan": {k: v[1] for k, v in k_launches.items()}}
    log(f"[26] launches with the lattice in device scratch on the search tier's main paths: "
        f"{scratch}")
    check(not any(v for d in scratch.values() for v in d.values()),
          "a search-tier main path kept its lattice in scratch")
    main_entries = []
    for dt in (torch.float32, torch.float64):
        err, ms, plain_ms, bnd = i_meas[dt]
        main_entries.append(entry(f"tree_scan{tag_of[dt]}", "tree_scan.cu",
                                  "speechrecognition_tpu/search/tree_decoder.py:124",
                                  tree_launches[dt], err, ms, plain_ms, bnd))
        # the first design (the block instance), forced beside it: not on a main path
        main_entries.append(entry(
            f"tree_scan[{'f64, ' if dt == torch.float64 else ''}first design]", "tree_scan.cu",
            "speechrecognition_tpu/search/tree_decoder.py:124", 0, i_first[dt][1],
            i_first[dt][0], plain_ms, bnd))
    for dt in (torch.float32, torch.float64):
        err, ms, plain_ms, bnd = j_meas[dt]
        main_entries.append(entry(f"decode_scan_bigram{tag_of[dt]}", "decode_scan_bigram.cu",
                                  "speechrecognition_tpu/search/ngram_decoder.py:39",
                                  j_launches[dt], err, ms, plain_ms, bnd))
    for name, (err, ms, plain_ms, bnd) in k_meas.items():
        label = "wcts_scan[f64]" if name == "pruned[f64]" else f"wcts_scan[{name}]"
        main_entries.append(entry(label, "wcts_scan.cu",
                                  "speechrecognition_tpu/search/wcts.py:156 + "
                                  "speechrecognition_tpu/search/histogram.py:55",
                                  k_launches[name][0], err, ms, plain_ms, bnd))
    return main_entries + entries


#: phase 27: the card's float64 cepstra against the CPU port's, relative
#: to 1 + |CPU|: the products sum in another order (cuBLAS against the CPU's
#: BLAS), nothing else differs
FEATURES_REL = 1e-9
#: utterances of the CPU comparison a call (bounds its host memory)
FEATURES_CPU_CHUNK = 128


def synthetic_audio(lengths, seed):
    """int16 [B, max(lengths)] from a seed, zero past each length: two tones
    and noise an utterance, made in chunks of FEATURES_CPU_CHUNK rows."""
    rng = np.random.default_rng(seed)
    S = int(max(lengths))
    t = np.arange(S) / 8000.0
    out = np.zeros((len(lengths), S), np.int16)
    for c in range(0, len(lengths), FEATURES_CPU_CHUNK):
        rows = range(c, min(c + FEATURES_CPU_CHUNK, len(lengths)))
        f = rng.uniform(100.0, 3500.0, size=(len(rows), 2, 1))
        x = (6000 * np.sin(2 * np.pi * f[:, 0] * t) + 2500 * np.sin(2 * np.pi * f[:, 1] * t)
             + rng.normal(0.0, 400.0, size=(len(rows), S)))
        x = np.clip(np.round(x), -32768, 32767).astype(np.int16)
        x[np.arange(S)[None, :] >= np.asarray(lengths)[list(rows), None]] = 0
        out[c:c + len(rows)] = x
    return out


def features_phase(dev, card, big):
    """Phase 27: the batched feature front end (extract_features_batch) on the
    card in float64, on 1,024 synthetic utterances with the full-width
    batch's frame counts: finite, of the expected shape, within FEATURES_REL
    of the CPU port on the same samples; its time beside its products'
    bound."""
    from speechrecognition_torch.features import SignalAnalysisConfig, extract_features_batch
    t_phase = time.perf_counter()
    cfg = SignalAnalysisConfig()
    frames = np.asarray(big.lengths, np.int64)
    rng = np.random.default_rng(27)
    lengths = np.maximum(frames * cfg.window_shift
                         - rng.integers(0, cfg.window_shift, size=len(frames)), 0)
    samples = synthetic_audio(lengths, seed=28)
    B, S = samples.shape
    T = -(-S // cfg.window_shift)
    s_dev = torch.as_tensor(samples, device=dev)
    n_dev = torch.as_tensor(lengths, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = extract_features_batch(s_dev, n_dev, cfg, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(out.dtype == torch.float64 and out.device == dev and tuple(out.shape) == (B, T, 12),
          f"features on the card: {out.dtype} {tuple(out.shape)} on {out.device}")
    check(bool(torch.isfinite(out).all()), "features on the card are not finite")
    rel = 0.0
    for c in range(0, B, FEATURES_CPU_CHUNK):
        cpu = extract_features_batch(samples[c:c + FEATURES_CPU_CHUNK],
                                     lengths[c:c + FEATURES_CPU_CHUNK], cfg, device="cpu")
        got = out[c:c + FEATURES_CPU_CHUNK].cpu()
        rel = max(rel, ((got - cpu).abs() / (1.0 + cpu.abs())).max().item())
    ms = cuda_ms(lambda: extract_features_batch(s_dev, n_dev, cfg, device=dev), 3)
    bins = cfg.dft_length // 2 + 1
    frames_all = B * T
    ops = frames_all * 2 * (2 * cfg.window_size * bins + bins * cfg.n_mel_filters
                            + cfg.n_mel_filters * cfg.n_features_in_file)
    nbytes = (2 * B * S + 8 * B + 8 * frames_all * cfg.n_features_in_file
              + 8 * (2 * cfg.window_size * bins + bins * cfg.n_mel_filters
                     + cfg.n_mel_filters * cfg.n_features_in_file))
    bnd = bound(nbytes, fp64_mma=ops)
    log(f"[27] feature front end float64, B={B} S={S} T={T} ({frames.sum()} valid frames): "
        f"max rel vs the CPU port {rel:.3e} (limit {FEATURES_REL:g}); {ms:.4f} ms a call "
        f"({ms / B * 1e3:.3f} us an utterance); bound of its products {bnd[0]:.4f} ms "
        f"({bnd[1]}, {ops / 1e9:.1f} GFLOP); the call's peak device memory {peak / 2 ** 30:.2f} "
        f"GiB on {card}")
    check(rel < FEATURES_REL, f"features on the card vs the CPU port: {rel} >= {FEATURES_REL}")
    log(f"[27] phase seconds {time.perf_counter() - t_phase:.1f}")


#: kernel L per utterance, frame and position, the operations its function
#: needs (an exponential or a logarithm counted as one): the forward step 22
#: (three candidate adds; lse3's 14: three maxima, three subtractions, three
#: exponentials, two adds, a logarithm, an add and a compare; the emission's
#: add, the mask, a step of the row maximum, the shift's compare and
#: subtraction), the backward step 22 likewise, the posterior 7 (alpha +
#: beta, a step of the maximum, a subtraction, an exponential, a compare, a
#: step of the sum, a division)
L_POS_OPS = 22 + 22 + 7
#: utterances a Baum-Welch batch (kernel E's phase-13 batch)
L_BATCH = 256
#: utterances of phase 30's plain comparison
PLAIN_DISC_CUT = 32
#: phase 30's demo run on the card against the CPU port (float64)
DISC_CPU_TOL = 1e-9


def fb_bound(B, T, A, word, live):
    """Kernel L on ``live`` frames (the lengths' sum, each at most T): their
    emissions read once, every row of gamma written once, the TDP, valid and
    length tables read once, log_z written; the operations per position of
    each live frame (no step runs past an utterance's length)."""
    nbytes = (live + B * T) * A * word + B * A * (3 * word + 1) + 8 * B + B * word
    ops = live * A * L_POS_OPS
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def same_fb(g, z, gr, zr):
    """Kernel L's outputs bit-equal to its plain version's, gamma and log_z."""
    return torch.equal(g, gr) and torch.equal(z, zr)


def max_rel(got, ref):
    """max |got - ref| / |ref| over the elements (0 where both are 0)."""
    got, ref = got.double(), ref.double()
    return ((got - ref).abs() / ref.abs().clamp(min=1e-300)).max().item()


def discriminative_phases(dev, card, lex, corpus, big, bench, iter2):
    """Phases 28-30: kernel L (the forward-backward scan) against its plain
    version at full width and across its instances, Baum-Welch at full width
    (posteriors and accumulation, float64 "mxu" and float32 "pallas"), and
    the MMI and MPE iterations of tools/mpe_run.py's recipe at full width.
    Returns the kernels line's entries of kernel L."""
    import contextlib
    import copy
    from speechrecognition_torch.align import baumwelch as bw
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.lexicon import build_segment_automaton
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.ops import mahalanobis as maha
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.tdp import TdpModel
    from speechrecognition_torch.train import ebw as ebw_mod
    from speechrecognition_torch.train.ebw import EbwConfig, EbwTrainer
    from speechrecognition_torch.train.em import Trainer, TrainerConfig
    from speechrecognition_torch.train.mpe import MpeTrainer

    lib = _native.load()
    fbt = tables_module("torch_fb_tables")
    torch.cuda.empty_cache()
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    T = 3 * vit.ALIGN_CHUNK
    check(int(big.lengths.max()) <= T, "the Baum-Welch batches fit 960 frames")
    tables_all = vit.AlignerTables.build([build_segment_automaton(lex, o) for o in big.orths],
                                         tdp)
    word_of = {torch.float32: 4, torch.float64: 8}
    tag_of = {torch.float32: "", torch.float64: "[f64]"}

    # -- 28. kernel L against its plain version -------------------------------------------
    t_phase = time.perf_counter()
    ids = list(range(L_BATCH))
    feats_np, lens_np = big.padded_batch(ids, pad_to=T)
    tables = tables_all.rows(ids)
    A = tables.states.shape[1]
    feats = torch.as_tensor(feats_np, device=dev)
    lens = torch.as_tensor(np.asarray(lens_np), dtype=torch.int32, device=dev)
    states = torch.as_tensor(tables.states, dtype=torch.long, device=dev)
    aut = torch.as_tensor(tables.lengths, dtype=torch.int32, device=dev)
    valid = torch.arange(A, device=dev)[None, :] < aut[:, None]
    res, first_res = {}, {}
    for dt in (torch.float32, torch.float64):
        pack = bench.pack(dtype=dt, device=dev)
        am = gmm.am_scores(pack, feats.reshape(-1, 25)).reshape(L_BATCH, T, -1).to(dt)
        lams = (-am.gather(2, states[:, None, :].expand(L_BATCH, T, A))).contiguous()
        ltdp = (-torch.as_tensor(tables.tdp, dtype=dt, device=dev)).contiguous()
        args = (lams, ltdp, valid, lens, aut)
        g, z = bw.forward_backward(*args)
        gf, zf, _scratch = bw.forward_backward_cuda(*args, first_design=True)
        gr, zr = bw.forward_backward_reference(*args)
        torch.cuda.synchronize()
        bits, bits_first = same_fb(g, z, gr, zr), same_fb(gf, zf, gr, zr)
        g_err = (g - gr).abs().max().item()
        sums = g.sum(dim=2)
        live = torch.arange(T, device=dev)[None, :] < lens[:, None]
        sum_err = (sums[live] - 1.0).abs().max().item()
        check(bool(torch.isfinite(g).all() and torch.isfinite(z).all()), "kernel L: not finite")
        check(bits and bits_first, f"kernel L ({dt}) is not bit-equal to its plain version: the "
              f"two chains {bits}, the first design {bits_first}")
        new_ms, first_ms, all_ = in_turns(
            lambda: bw.forward_backward_cuda(*args, first_design=True),
            lambda: bw.forward_backward_cuda(*args), 5, 5)
        plain_ms = cuda_ms(lambda: bw.forward_backward_reference(*args), 1)
        # the split: each chain alone, and the chains' launch and the
        # posterior pass by device time
        fwd_ms = cuda_ms(lambda: bw.forward_backward_chain_cuda(0, *args), 5)
        bwd_ms = cuda_ms(lambda: bw.forward_backward_chain_cuda(1, *args), 5)
        chains_dev = device_ms(lambda: bw.forward_backward_cuda(*args), 5, "fb_chain_kernel")
        post_dev = device_ms(lambda: bw.forward_backward_cuda(*args), 5, "fb_posterior_kernel")
        bnd = fb_bound(L_BATCH, T, A, word_of[dt], int(lens.clamp(max=T).sum()))
        # the posterior pass reads alpha and beta of the live rows and
        # writes every row of gamma
        post_bnd = bound((2 * int(lens.sum()) + L_BATCH * T) * A * word_of[dt])
        f64 = int(dt == torch.float64)
        per_sm = lib.sr_forward_backward_residency(A, f64, 0)
        per_sm_first = lib.sr_forward_backward_residency(A, f64, 1)
        longest = int(lens.max())
        ty = "d" if f64 else "f"
        k = lib.sr_forward_backward_instance(A)
        log(f"[28] kernel L {dt} B={L_BATCH} T={T} A={A} on bench/model.mix scores of the "
            f"corpus's segment automata (longest utterance {longest} frames): two chains "
            f"({k} positions a lane, two warps an utterance, "
            f"{ptxas_usage(f'fb_chain_kernelI{ty}Li{k}E')}; {per_sm} utterances an SM, "
            f"{waves(L_BATCH, per_sm)} wave(s)) and the posterior pass "
            f"({ptxas_usage(f'fb_posterior_kernelI{ty}Li{k}E')}); the backward chain's buffer "
            f"{L_BATCH * T * A * word_of[dt] / 1e6:.1f} MB; first design (a warp an utterance, "
            f"{ptxas_usage(f'fb_warp_kernelI{ty}Li{k}E')}; {per_sm_first} an SM, "
            f"{waves(L_BATCH, per_sm_first)} wave(s))")
        log(f"[28] kernel L {dt}: bit-equal to its plain version (gamma and log_z): two chains "
            f"{bits}, first design {bits_first}; rows sum to 1 within {sum_err:.3e}; in turns "
            f"(first, chains, chains, first: {', '.join(f'{v:.4f}' for v in all_)} ms): first "
            f"design {first_ms:.4f} ms ({first_ms / longest * 1e3:.3f} us a frame of the longest "
            f"utterance) -> two chains {new_ms:.4f} ms ({new_ms / longest * 1e3:.3f} us a "
            f"frame); plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}) on {card}")
        log(f"[28] kernel L {dt} split: forward chain alone {fwd_ms:.4f} ms, backward chain "
            f"alone {bwd_ms:.4f} ms (a warp an utterance, by events); device time of the "
            f"chains' launch {chains_dev:.4f} ms and of the posterior pass {post_dev:.4f} ms "
            f"(its bytes' bound {post_bnd[0]:.4f} ms) on {card}")
        # the C entry launches the chains at this size: they must be the faster
        check(new_ms < first_ms, f"kernel L {dt}: the two chains ({new_ms:.4f} ms) are not "
              f"faster than the first design ({first_ms:.4f} ms)")
        res[dt] = (g_err, new_ms, plain_ms, bnd)
        first_res[dt] = ((gf - gr).abs().max().item(), first_ms, plain_ms, bnd)
        del am, lams, g, gf, gr
    scratch_res = None
    for A_s, inst in fbt.L_INSTANCES.items():
        got = lib.sr_forward_backward_instance(A_s)
        check(got == inst, f"kernel L's instance at A={A_s}: {got}, expected {inst}")
        for dt in (torch.float32, torch.float64):
            lams, ltdp, pv, fl, al = fbt.fb_inputs(4, 40, A_s, seed=A_s)
            args = (torch.as_tensor(lams, dtype=dt, device=dev),
                    torch.as_tensor(ltdp, dtype=dt, device=dev), torch.as_tensor(pv, device=dev),
                    torch.as_tensor(fl, device=dev), torch.as_tensor(al, device=dev))
            g, z = bw.forward_backward(*args)
            gf, zf, _scratch = bw.forward_backward_cuda(*args, first_design=True)
            gr, zr = bw.forward_backward_reference(*args)
            torch.cuda.synchronize()
            g_err = (g - gr).abs().max().item()
            bits, bits_first = same_fb(g, z, gr, zr), same_fb(gf, zf, gr, zr)
            ms, plain_ms, _ = in_turns(lambda: bw.forward_backward_reference(*args),
                                       lambda: bw.forward_backward(*args), 1, 10)
            bnd = fb_bound(4, 40, A_s, word_of[dt], int(np.minimum(fl, 40).sum()))
            log(f"[28] kernel L sweep {dt} B=4 T=40 A={A_s} ({instance('sr_forward_backward_instance', A_s).replace('warp(s) per utterance', 'position(s) a lane')}): "
                f"bit-equal {bits} (first design {bits_first}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), per frame "
                f"{ms / 40 * 1e3:.2f} us")
            check(bits and bits_first, f"kernel L ({dt}, A={A_s}) is not bit-equal to its plain "
                  f"version: {bits}, first design {bits_first}")
            if inst < 0 and dt == torch.float32:
                scratch_res = (A_s, (g_err, ms, plain_ms, bnd))
    del feats
    log(f"[28] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 29. Baum-Welch at full width -----------------------------------------------------
    t_phase = time.perf_counter()
    runs = {"f64 mxu": (torch.float64, bench.pack(dtype=torch.float64, device=dev)),
            "f32 pallas": (torch.float32, bench.pack(method="pallas", device=dev))}

    def bw_pass(pack, dt):
        """Posteriors and statistics over the corpus in batches of L_BATCH:
        (summed w, xs, x2s; log_z; best paths per batch; gamma per batch)."""
        stats, log_z, paths, gammas = None, [], [], []
        for i in range(0, big.num_segments, L_BATCH):
            b_ids = list(range(i, min(i + L_BATCH, big.num_segments)))
            f_np, l_np = big.padded_batch(b_ids, pad_to=T)
            tb = tables_all.rows(b_ids)
            g, z = bw.baum_welch_posteriors(pack, f_np, l_np, tb, dtype=dt)
            s = bw.accumulate_baum_welch(pack, f_np, g, torch.as_tensor(tb.states, device=dev))
            stats = s if stats is None else tuple(a + b for a, b in zip(stats, s))
            log_z.append(z)
            paths.append(bw.best_path_from_posteriors(g, tb))
            gammas.append(g)
        return stats, torch.cat(log_z), paths, gammas

    l_launches = {}
    for label, (dt, pack) in runs.items():
        bw.forward_backward.LAUNCHES = bw.forward_backward.SCRATCH_LAUNCHES = 0
        maha.mahalanobis_scores.LAUNCHES = maha.mahalanobis_min_scores.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, log_z, paths, gammas = bw_pass(pack, dt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_l, n_scratch = bw.forward_backward.LAUNCHES, bw.forward_backward.SCRATCH_LAUNCHES
        n_a = (maha.mahalanobis_min_scores.LAUNCHES, maha.mahalanobis_scores.LAUNCHES)
        l_launches[dt] = (n_l, n_scratch)
        with mock.patch.object(bw, "forward_backward", bw.forward_backward_reference):
            t0 = time.perf_counter()
            p_stats, p_log_z, p_paths, p_gammas = bw_pass(pack, dt)
            torch.cuda.synchronize()
            p_secs = time.perf_counter() - t0
        same_paths = all(np.array_equal(a, b) for a, b in zip(paths, p_paths))
        same_gamma = all(torch.equal(a, b) for a, b in zip(gammas, p_gammas))
        same_stats = all(torch.equal(a, b) for a, b in zip(stats, p_stats))
        errs = [max_rel(a, b) for a, b in zip(stats, p_stats)]
        z_err = max_rel(log_z, p_log_z)
        same_z = torch.equal(log_z, p_log_z)
        del gammas, p_gammas
        # the frames where the posterior's best path leaves the forced (full
        # DP, final position forced) Viterbi alignment
        differ = 0
        for k, i in enumerate(range(0, big.num_segments, L_BATCH)):
            b_ids = list(range(i, min(i + L_BATCH, big.num_segments)))
            f_np, l_np = big.padded_batch(b_ids, pad_to=T)
            vs, _ = vit.align_batch(pack, f_np, l_np, tables_all.rows(b_ids),
                                    pruning_threshold=None, tie_pruned=False, dtype=dt)
            live_np = np.arange(T)[None, :] < np.asarray(l_np)[:, None]
            differ += int(((vs != paths[k]) & live_np).sum())
        log(f"[29] Baum-Welch {label}, {big.num_segments} utterances in batches of {L_BATCH}: "
            f"{secs:.3f} s (the plain run {p_secs:.3f} s); launches of L {n_l} (in scratch "
            f"{n_scratch}), of A's fused / unfused entries {n_a[0]} / {n_a[1]}; against the "
            f"run with L's plain version: gamma bit-equal {same_gamma}, log_z bit-equal "
            f"{same_z}, w / xs / x2s bit-equal {same_stats} (max rel {errs[0]:.3e} / "
            f"{errs[1]:.3e} / {errs[2]:.3e}, log_z {z_err:.3e}), best paths equal {same_paths}; "
            f"occupancy {stats[0].sum().item():.1f} of {int(big.lengths.sum())} frames; "
            f"frames whose posterior best path differs from the forced alignment: {differ} of "
            f"{int(big.lengths.sum())} on {card}")
        check(n_l == -(-big.num_segments // L_BATCH) and n_scratch == 0,
              f"Baum-Welch {label} launched kernel L {n_l} times ({n_scratch} in scratch)")
        if pack.method == "pallas":
            check(min(n_a) > 0, f"the pallas Baum-Welch skipped an entry of kernel A: {n_a}")
        check(same_gamma and same_z and same_stats and same_paths,
              f"Baum-Welch {label} is not bit-equal to its plain-L run: gamma {same_gamma}, "
              f"log_z {same_z}, statistics {same_stats} ({errs}), paths {same_paths}")
        del stats, p_stats
    # accumulate_baum_welch's products on one batch (cuBLAS, no hand kernel)
    pack64 = runs["f64 mxu"][1]
    b_ids = list(range(L_BATCH))
    f_np, l_np = big.padded_batch(b_ids, pad_to=T)
    tb = tables_all.rows(b_ids)
    g0, _ = bw.baum_welch_posteriors(pack64, f_np, l_np, tb, dtype=torch.float64)
    f_dev, st_dev = torch.as_tensor(f_np, device=dev), torch.as_tensor(tb.states, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    acc_ms = cuda_ms(lambda: bw.accumulate_baum_welch(pack64, f_dev, g0, st_dev), 3)
    acc_peak = torch.cuda.max_memory_allocated(dev)
    n, S, D, K = L_BATCH * T, pack64.num_mixtures, pack64.density_cap, 2 * 25 + 1
    acc_bnd = bound(4 * n * 25 + 8 * n * A + 8 * L_BATCH * A + 8 * S * D * (1 + 2 * 25),
                    fp64_mma=2 * n * K * S * D + 2 * 2 * n * S * D * 25)
    log(f"[29] accumulate_baum_welch float64 \"mxu\", one batch ({L_BATCH} x {T} frames, "
        f"cuBLAS products, no hand kernel): {acc_ms:.4f} ms a call; bound {acc_bnd[0]:.4f} ms "
        f"({acc_bnd[1]}: its density-score and statistics products at the FP64 tensor cores' "
        f"67 TFLOP/s); peak device memory {acc_peak / 2 ** 30:.2f} GiB on {card}")
    del g0, f_dev
    log(f"[29] phase seconds {time.perf_counter() - t_phase:.1f}")

    # -- 30. MMI and MPE at full width: tools/mpe_run.py's recipe -------------------------
    t_phase = time.perf_counter()
    with open(REPO / "bench" / "model.mix.json") as f:
        meta = json.load(f)

    def bench_model():
        return gmm.MixtureModel.from_raw(read_mixture_set(str(REPO / "bench" / "model.mix"), 25),
                                         gmm.VarianceModel.from_string(meta["pooling"]),
                                         max_approx=True)

    tdp_b = TdpModel(silence_state=lex.silence_state, loop=meta["tdp"][0],
                     forward=meta["tdp"][1], skip=meta["tdp"][2])
    cfg_kw = dict(e_constant=2.0, i_smoothing_tau=50.0, posterior_threshold=5.0,
                  word_penalty=float(meta["word_penalty"]),
                  am_threshold=float(meta["am_threshold"]), batch_size=256)
    # the numerator alignment: the df32 trainer's realignment (mpe_run.py:136-143)
    t0 = time.perf_counter()
    tables_b = vit.AlignerTables.build([build_segment_automaton(lex, o) for o in big.orths],
                                       tdp_b)
    alignment = np.zeros(big.total_frames, np.int32)
    Trainer(TrainerConfig(pruning_threshold=200.0, batch_size=256), lex, bench_model(), tdp_b,
            dtype="df32", log=lambda *a: None, device=dev)._realign(big, tables_b, alignment)
    log(f"[30] numerator alignment (df32 realignment): {time.perf_counter() - t0:.2f} s, "
        f"silence {100.0 * (alignment == lex.silence_state).mean():.1f} % of "
        f"{big.total_frames} frames")
    # accumulate_chunk on one chunk of the numerator's frames (cuBLAS, no hand
    # kernel), float32 "mxu" as the recipe runs it
    pack32 = bench_model().pack(dtype=torch.float32, device=dev)
    C = min(EbwConfig().chunk_frames, big.total_frames)
    ch = (torch.as_tensor(big.features[:C], device=dev),
          torch.as_tensor(alignment[:C].astype(np.int64), device=dev),
          torch.ones(C, device=dev))
    ch_ms = cuda_ms(lambda: gmm.accumulate_chunk(pack32, *ch, first_pass=False), 10)
    S, D, K = pack32.num_mixtures, pack32.density_cap, 2 * 25 + 1
    ch_bnd = bound(C * (4 * 25 + 8 + 4) + 8 * S * D * (1 + 2 * 25),
                   fp32=2 * C * K * D, fp64_mma=2 * S * C * D * (1 + 2 * 25))
    log(f"[30] accumulate_chunk float32 \"mxu\", {C} frames (the aligned mixture's "
        f"product and one-hot float64 products on cuBLAS, no hand kernel): {ch_ms:.4f} ms a "
        f"call; bound {ch_bnd[0]:.4f} ms ({ch_bnd[1]}) on {card}")
    del ch
    counters = {"decode_scan_bigram": ng.decode_scan_bigram, "align_fwd": vit.align_fwd_chunk,
                "align_backtrack": vit.align_backtrack, "forward_backward": bw.forward_backward}

    def zero():
        for fn in counters.values():
            fn.LAUNCHES = 0

    def launches():
        return {k: fn.LAUNCHES for k, fn in counters.items()}

    zero()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mpe = MpeTrainer(EbwConfig(**cfg_kw), lex, bench_model(), tdp_b, dtype=torch.float32,
                     device=dev)
    t0 = time.perf_counter()
    out = mpe.iterate(big, alignment, compute_after=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_mpe = launches()
    log(f"[30] MPE iteration (E 2, tau 50, posterior threshold 5, batch 256, float32 "
        f"statistics) on {big.num_segments} utterances: {secs:.2f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in mpe.phase_seconds.items())} s); expected "
        f"accuracy {out['expected_accuracy_before'] / big.num_segments:.4f} -> "
        f"{out['expected_accuracy_after'] / big.num_segments:.4f} an utterance, masses num "
        f"{out['num_mass']:.3f} den {out['den_mass']:.3f}; launches {n_mpe}; peak device "
        f"memory {peak / 2 ** 30:.2f} GiB on {card}")
    check(all(np.isfinite(v) for v in out.values()), f"MPE diagnostics not finite: {out}")
    check(min(n_mpe[k] for k in ("decode_scan_bigram", "align_fwd", "align_backtrack")) > 0,
          f"the MPE iteration skipped a kernel: {n_mpe}")
    zero()
    torch.cuda.reset_peak_memory_stats(dev)
    mmi = EbwTrainer(EbwConfig(**cfg_kw), lex, bench_model(), tdp_b, dtype=torch.float32,
                     device=dev)
    decoded = []
    decode = mmi.decode_lattices
    mmi.decode_lattices = lambda c: decoded.append(decode(c)) or decoded[-1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = mmi.iterate(big, alignment)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_mmi = launches()
    log(f"[30] MMI iteration (the same settings, a fresh model; profiled) on "
        f"{big.num_segments} utterances: {secs:.2f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in mmi.phase_seconds.items())} s); criterion "
        f"{out['criterion_before']:.6f} -> {out['criterion_after']:.6f}, masses num "
        f"{out['num_frames_mass']:.1f} den {out['den_frames_mass']:.1f}; launches {n_mmi}; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB on {card}")
    log_profile("[30] MMI iteration", prof, secs)
    # the criterion is -inf where an updated model's lattice has no complete
    # path (the reference's mmi_criterion sums such a lattice's +inf total)
    dead = [s for s, lat in enumerate(decoded[-1])
            if not np.isfinite(lat.forward_backward()[0][lat.num_frames])]
    log(f"[30] lattices without a complete path after the update: {len(dead)} (utterances "
        f"{dead[:8]}{' ...' if len(dead) > 8 else ''}; demo utterances "
        f"{sorted({s % corpus.num_segments for s in dead})})")
    check(np.isfinite(out["criterion_before"]) and np.isfinite(out["num_frames_mass"])
          and np.isfinite(out["den_frames_mass"]), f"MMI diagnostics not finite: {out}")
    check(np.isfinite(out["criterion_after"]) == (not dead),
          f"the MMI criterion after the update is {out['criterion_after']} with {len(dead)} "
          f"lattices without a complete path")
    check(min(n_mmi[k] for k in ("decode_scan_bigram", "align_fwd", "align_backtrack")) > 0,
          f"the MMI iteration skipped a kernel: {n_mmi}")
    del prof

    # the kernels' run against the plain versions' on the first PLAIN_DISC_CUT utterances
    cut = repeat_corpus(big, PLAIN_DISC_CUT, type(big))
    ali_cut = alignment[:cut.total_frames]

    def disc_steps(plain):
        """Lattices, the arcs' alignments, the MPE and MMI statistics and
        the updated model on the cut, through the kernels or their plain
        versions."""
        aligned = []

        def recording(*a, **k):
            st, c = vit.align_batch(*a, **k)
            aligned.append(st)
            return st, c

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(ebw_mod, "align_batch", recording))
            if plain:
                for mod, name, fn in ((ebw_mod, "decode_scan_bigram", ng.decode_scan_bigram_reference),
                                      (vit, "align_fwd_chunk", vit.align_fwd_chunk_reference),
                                      (vit, "align_backtrack", vit.align_backtrack_reference)):
                    stack.enter_context(mock.patch.object(mod, name, fn))
            tr = MpeTrainer(EbwConfig(**cfg_kw), lex, bench_model(), tdp_b, dtype=torch.float32,
                            device=dev)
            lats = tr.decode_lattices(cut)
            num, den, acc = tr.mpe_statistics(cut, ali_cut, lats)
            mmi_den = tr.denominator_statistics(cut, lats)
            tr.ebw_update(num, den)
        return lats, aligned, (*num, *den, *mmi_den), acc, tr.model

    t0 = time.perf_counter()
    k_run = disc_steps(False)
    p_run = disc_steps(True)
    p_secs = time.perf_counter() - t0
    same_lats = all([(a.start, a.end, a.word, a.score) for a in x.arcs]
                    == [(a.start, a.end, a.word, a.score) for a in y.arcs]
                    for x, y in zip(k_run[0], p_run[0]))
    same_align = (len(k_run[1]) == len(p_run[1])
                  and all(np.array_equal(a, b) for a, b in zip(k_run[1], p_run[1])))
    stat_err = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
                   for a, b in zip(k_run[2], p_run[2]))
    par_err = max(float(np.max(np.abs(getattr(k_run[4], n) - getattr(p_run[4], n))
                            / np.maximum(np.abs(getattr(p_run[4], n)), 1e-300)))
                  for n in ("means", "vars", "mean_weights"))
    log(f"[30] kernels against plain versions on the first {PLAIN_DISC_CUT} utterances "
        f"({sum(len(l.arcs) for l in k_run[0])} lattice arcs, {len(k_run[1])} alignment "
        f"batches; {p_secs:.1f} s both): lattices identical {same_lats}, arc alignments "
        f"identical {same_align}, statistics max rel {stat_err:.3e}, expected accuracy "
        f"{k_run[3]:.6f} / {p_run[3]:.6f}, updated means / variances / weights max rel "
        f"{par_err:.3e}")
    check(same_lats and same_align, "phase 30's lattices or arc alignments differ from the plain run")
    check(stat_err <= 1e-12 and par_err <= 1e-12 and k_run[3] == p_run[3],
          f"phase 30's statistics or parameters differ from the plain run: {stat_err}, {par_err}")
    del k_run, p_run

    # the demo utterances in float64: the card against the CPU port
    from speechrecognition_torch.io import read_alignment
    demo = corpus
    demo_ali = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))[0]
    demo_kw = dict(e_constant=2.0, i_smoothing_tau=10.0, word_penalty=80.0, am_threshold=200.0,
                   batch_size=demo.num_segments)
    diag, models_ = {}, {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        mp = MpeTrainer(EbwConfig(**demo_kw), lex, copy.deepcopy(iter2), tdp,
                        dtype=torch.float64, device=where)
        d_mpe = mp.iterate(demo, demo_ali.astype(np.int64))
        mm = EbwTrainer(EbwConfig(**demo_kw), lex, copy.deepcopy(iter2), tdp,
                        dtype=torch.float64, device=where)
        d_mmi = mm.iterate(demo, demo_ali.astype(np.int64))
        diag[str(where)] = {**d_mpe, **d_mmi}
        models_[str(where)] = (mp.model, mm.model)
        log(f"[30] demo MPE + MMI iterations in float64 on {where}: "
            f"{time.perf_counter() - t0:.1f} s")
    worst = max(abs(diag[str(dev)][k] - diag["cpu"][k]) / max(abs(diag["cpu"][k]), 1e-300)
                for k in diag["cpu"])
    for a, b in zip(models_[str(dev)], models_["cpu"]):
        for n in ("means", "vars", "mean_weights"):
            x, y = getattr(a, n), getattr(b, n)
            worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300))))
    log(f"[30] demo (35 utterances, iter-2.mix, float64): the card's diagnostics and updated "
        f"models against the CPU port's, max rel {worst:.3e} (limit {DISC_CPU_TOL:g}); "
        f"MPE expected accuracy {diag[str(dev)]['expected_accuracy_before']:.6f} -> "
        f"{diag[str(dev)]['expected_accuracy_after']:.6f}, MMI criterion "
        f"{diag[str(dev)]['criterion_before']:.6f} -> {diag[str(dev)]['criterion_after']:.6f}")
    check(worst <= DISC_CPU_TOL, f"phase 30's demo run on the card differs from the CPU: {worst}")
    log(f"[30] phase seconds {time.perf_counter() - t_phase:.1f}")

    replaces = "speechrecognition_tpu/align/baumwelch.py:44"
    entries = [entry(f"forward_backward{tag_of[dt]}", "forward_backward.cu", replaces,
                     l_launches[dt][0], *res[dt]) for dt in (torch.float32, torch.float64)]
    # the first design, forced beside the two chains: no main path launches it
    entries += [entry(f"forward_backward[first design{', f64' if dt == torch.float64 else ''}]",
                      "forward_backward.cu", replaces, 0, *first_res[dt])
                for dt in (torch.float32, torch.float64)]
    A_s, r = scratch_res
    entries.append(entry(f"forward_backward[A={A_s}]", "forward_backward.cu", replaces,
                         sum(n for _, n in l_launches.values()), *r))
    return entries


#: utterances of phases 32's plain comparisons of the unpruned scans
PLAIN_LIN_CUT = 16
#: kernel M, per utterance and frame: per live (word, position) slot (a
#: slot past its word's length is a constant BIG) and per silence-copy slot
#: five adds (three transitions, the score, the renormalisation's
#: subtraction) and seven compares (the two within-word takes, the entry's
#: take, the cap at BIG, the frame's minimum, the renormalisation's and the
#: pruning's tests); per (predecessor, word) pair the min-plus product's add
#: and compare; per word and silence-copy end the book's test, the exit, the
#: entry's add and the frozen utterance's select
LIN_SLOT_OPS = 12
LIN_PAIR_OPS = 2
LIN_END_OPS = 4
#: the AN4 test corpus's audio: 35,570 frames of 10 ms
AN4_AUDIO_S = 355.7


def linear_bound(B, T, S, word_len, Ps, word):
    """Kernel M over a batch: the scores read once, the eight per-frame
    outputs written, the tables read; the operations of every frame (the
    scan's outputs are defined for every frame, finished utterances too)
    over the lexicon's live slots, sum(word_len), and the V·Ps silence
    copies."""
    W, P = len(word_len), int(max(word_len))
    V = W + 1
    nbytes = (B * T * S * word + T * B * W * (word + 4 + 4 + 1) + T * B * V * (4 + word + 4)
              + T * B * word + V * W * word + W * P * (4 + 3 * word) + Ps * (4 + 3 * word))
    ops = B * T * ((int(np.sum(word_len)) + V * Ps) * LIN_SLOT_OPS + V * W * LIN_PAIR_OPS
                   + (W + V) * LIN_END_OPS)
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def traceback_bound(B, W, word, steps, sil_starts, max_words):
    """Kernel N over this run's walks: per utterance its length, the last
    frame's W word ends and W + 1 silence ends and the [max_words] words
    written; the chosen silence copy's origin for the ``sil_starts`` walks
    that start there; three ints (bkp, pred, origin) for each of the
    ``steps`` steps the walks take (walk_steps)."""
    return bound(B * (4 + (2 * W + 1) * word + max_words * 4) + sil_starts * 4 + steps * 3 * 4)


def walk_steps(words, max_words):
    """Per utterance the words a walk emitted and the steps it took: one a
    word, the last word's step the one that finds the walk done; a walk cut
    at max_words takes no step after its last word."""
    n = (words != -1).sum(0)
    return n, n - (n == max_words).long()


def n_floor(dev, card, longest):
    """Kernel N's chain floor: a walk of ``longest`` steps is 2 x longest + 1
    dependent loads (the start's silence origin or first bkp, then bkp and
    pred together and origin a step). Measured by chase_library's global
    chase: a random cycle of 2^20 ints (4 MB) walked twice from its start, so
    the timed walk hits L2, and one of 2^26 (256 MB, past L2) walked on from
    where it stopped, so every load goes to device memory. Returns (L2 ns a
    load, device-memory ns a load, the floor in ms by L2)."""
    lib = chase_library()
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def cycle(n):
        perm = torch.randperm(n, device=dev, generator=gen)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt[perm] = perm.roll(-1).to(torch.int32)
        return nxt

    steps = 1 << 14
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    ns = []
    for nxt, first in ((cycle(1 << 20), start), (cycle(1 << 26), out)):
        def chase():
            check(lib.global_chase(steps, nxt.data_ptr(), first.data_ptr(), out.data_ptr(),
                                   dev.index, stream) == 0, "the global-memory chase launches")

        ns.append(cuda_ms(chase, 3) * 1e6 / steps)
    torch.cuda.empty_cache()
    loads = 2 * longest + 1
    log(f"[32] kernel N chain floor: one dependent load through L2 takes {ns[0]:.1f} ns, from "
        f"device memory {ns[1]:.1f} ns (chains of {steps} timed), so the longest walk, "
        f"{longest} steps, {loads} loads, takes at least {loads * ns[0] * 1e-6:.6f} ms "
        f"({loads * ns[1] * 1e-6:.6f} ms from device memory); {card}")
    return ns[0], ns[1], loads * ns[0] * 1e-6


def n_books(dev, card, tl, lin):
    """Kernel N's two designs on tests/torch_linear_tables.py's forced starts
    (NaNs, ties across lane boundaries, -0.0 against +0.0) at W 1, 33, 130,
    300 and on its long walks (traceback_books seeds 0 and 1: past
    MAX_TRACE_WORDS words), float32 and float64: torch.equal to the plain
    version."""
    cases = [(W, W, name, dict(B=5, T=160, W=W, **opts)) for W in (1, 33, 130, 300)
             for name, opts in lin.TRACEBACK_STARTS.items()]
    cases += [(seed, 3, f"seed {seed}", {}) for seed in (0, 1)]
    bad = []
    for seed, W, name, kw in cases:
        arrays = lin.traceback_books(seed, **kw)
        for dt, fl in ((torch.float32, np.float32), (torch.float64, np.float64)):
            args = [torch.as_tensor(a.astype(fl) if a.dtype.kind == "f" else a, device=dev)
                    for a in arrays]
            new = tl.traceback_linear_cuda(*args)
            first = tl.traceback_linear_cuda(*args, first_design=True)
            ref = tl.traceback_linear_reference(*args)
            torch.cuda.synchronize()
            if not (torch.equal(new, ref) and torch.equal(first, ref)):
                bad.append((W, name, str(dt)))
    log(f"[32] kernel N on {len(cases)} books x 2 types (NaN first, middle, last in the word and "
        f"silence ends; ties at 0/31/32/63 won by the word, the silence copy or neither; -0.0 "
        f"against +0.0; W 1, 33, 130, 300; walks past {tl.MAX_TRACE_WORDS} words): both designs "
        f"{'torch.equal to' if not bad else 'DIFFER from'} the plain version {bad[:6]}; {card}")
    check(not bad, f"kernel N differs from its plain version on {bad}")


def n_in_turns(dev, card, tl, walk, lens_t, W, word):
    """Kernel N's warp design and first design timed in turns (plain, new,
    first, first, new, plain), by events around the wrapper's calls and by
    device time (torch.profiler); the phase fails unless the warp design's
    device time is the smaller. Returns the two designs' entries' numbers."""
    B = lens_t.shape[0]
    words = tl.traceback_linear_cuda(*walk, lens_t)
    n, steps = walk_steps(words, tl.MAX_TRACE_WORDS)
    last = ((lens_t.long().clamp(min=1) - 1).clamp(max=walk[0].shape[0] - 1),
            torch.arange(B, device=dev))
    fb, fs = walk[0][last], walk[4][last]
    sil_starts = int((fs.amin(1) < fb.gather(1, fb.argmin(1, keepdim=True))[:, 0]).sum())
    bnd = traceback_bound(B, W, word, int(steps.sum()), sil_starts, tl.MAX_TRACE_WORDS)
    plain = lambda: tl.traceback_linear_reference(*walk, lens_t)         # noqa: E731
    new = lambda: tl.traceback_linear_cuda(*walk, lens_t)                # noqa: E731
    first = lambda: tl.traceback_linear_cuda(*walk, lens_t, first_design=True)   # noqa: E731
    ev_ms, ev_first, _p, ev_turns = designs_in_turns(plain, new, first, 3, 50)
    p1 = cuda_ms(plain, 3)
    d = [device_ms(new, 20, "linear_traceback_warp_kernel"),
         device_ms(first, 20, "linear_traceback_kernel"),
         device_ms(first, 20, "linear_traceback_kernel"),
         device_ms(new, 20, "linear_traceback_warp_kernel")]
    p2 = cuda_ms(plain, 3)
    ms, first_ms, plain_ms = (d[0] + d[3]) / 2, (d[1] + d[2]) / 2, (p1 + p2) / 2
    l2_ns, dram_ns, floor_ms = n_floor(dev, card, int(steps.max()))
    log(f"[32] kernel N: {int(n.sum())} words walked over {B} utterances, the longest walk "
        f"{int(n.max())} words; {int(steps.sum())} steps taken against the first design's "
        f"{B} x {tl.MAX_TRACE_WORDS} = {B * tl.MAX_TRACE_WORDS}; {sil_starts} walks start at a "
        f"silence copy")
    log(f"[32] kernel N device time (torch.profiler), in turns plain, new, first, first, new, "
        f"plain {[round(t, 5) for t in (p1, *d, p2)]}: warp design {ms:.5f} ms, first design "
        f"{first_ms:.5f} ms ({first_ms / ms:.2f}x), plain {plain_ms:.2f} ms; by events around "
        f"the wrapper {ev_ms:.5f} / {ev_first:.5f} ms (turns {[round(t, 5) for t in ev_turns]}); "
        f"bound {bnd[0]:.6f} ms ({bnd[1]}), {ms / bnd[0]:.0f}x; chain floor {floor_ms:.6f} ms "
        f"({ms / floor_ms:.2f}x; {2 * int(steps.max()) + 1} loads of {l2_ns:.1f} ns through L2, "
        f"{dram_ns:.1f} ns from device memory); {card}")
    log(f"[32] kernel N registers: warp design {ptxas_usage('linear_traceback_warp_kernel')}; "
        f"first design {ptxas_usage('linear_traceback_kernel')}")
    check(ms < first_ms, f"kernel N's warp design is not faster than its first design in turns "
          f"({ms:.5f} against {first_ms:.5f} ms of device time)")
    return (0.0, ms, plain_ms, bnd), (0.0, first_ms, plain_ms, bnd)


def quantized_bound(N, S, J, dim, C=0):
    """Kernel O over N frames: the features read and the scores written
    once, the tables read; 2·N·(J + C)·dim int8 operations (the products
    with the means and the centers) at the tensor cores' int8 peak."""
    nbytes = N * dim * 4 + N * S * 4 + J * (dim + 8) + (C * (dim + 4) + J * 4 if C else 0)
    return bound(nbytes, int8=2.0 * N * (J + C) * dim)


def lvcsr_phases(dev, card):
    """Phases 31-33: the LVCSR tier's 1-best path at AN4 width."""
    from speechrecognition_torch.corpus import Corpus
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.models import quantized as tq
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import linear_lvcsr as tl
    from speechrecognition_torch.search.decoder import DecoderTables
    from speechrecognition_torch.search.ngram_decoder import decode_batch_bigram
    from speechrecognition_torch.sprint import SprintConfig, TransitionModel
    from speechrecognition_torch.tdp import TdpModel
    from speechrecognition_torch.tools import an4_system
    lin = tables_module("torch_linear_tables")
    t_phase = time.perf_counter()
    work = REPO / "build" / "lvcsr"
    work.mkdir(parents=True, exist_ok=True)

    # -- 31. set-up at AN4 width, and kernel O ---------------------------------------
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(REPO / "bench" / "an4" / "am.mix"), 45),
                                      gmm.VarianceModel.GLOBAL_POOLING, max_approx=True)
    S, D, dim = model.num_mixtures, model.max_densities_per_mixture, model.dim
    J = S * D
    lex = lin.an4_lexicon(0, S)
    (work / "an4.config").write_text(lin.AN4_TDP_CONFIG)
    tm = TransitionModel.from_config(SprintConfig.read(str(work / "an4.config")))
    check(tm == lin.AN4_TDP, "TransitionModel.from_config of the AN4 TDP block")
    (work / "an4.arpa").write_text(lin.arpa_text(lex.orth[1:], seed=0))
    lm, lm_start = an4_system.build_lm_matrices(lex, tm, **lin.AN4_TUNED,
                                                arpa_path=str(work / "an4.arpa"))
    rng = np.random.default_rng(2026)
    lengths = lin.utterance_lengths(rng, lin.AN4_UTTERANCES, lin.AN4_FRAMES)
    spoken = [lin.utterance_states(rng, lex, int(n)) for n in lengths]
    corpus = Corpus(features=np.concatenate([lin.features_near_means(rng, model, s)
                                             for s, _w in spoken]),
                    feature_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
                    orths=[w for _s, w in spoken],
                    names=[f"an4-{i:03d}" for i in range(len(lengths))],
                    frame_duration=0.01, dim=dim)
    feats, lens = corpus.padded_batch(range(corpus.num_segments))
    B, T = feats.shape[:2]
    tables = tm.decoder_tables(lex)
    lt = tl.LinearTables.build(tables, lm, lm_start, lex.silence_idx)
    W, P = lt.state_table.shape
    Ps = len(lt.sil_states)
    audio_s = float(lens.sum()) * corpus.frame_duration
    log(f"[31] LVCSR set-up: bench/an4/am.mix (S {S}, J {J} = {model.num_densities()} densities "
        f"padded to {D}, dim {dim}, global pooling, max-approximation); a seeded lexicon of "
        f"{W} words ({lt.word_len.min()}-{P} positions, mean {lt.word_len.mean():.2f}) and a "
        f"{Ps}-state silence; TDPs from the AN4 config block; a seeded bigram ARPA LM at lm-scale "
        f"{lin.AN4_TUNED['lm_scale']:g}, word-exit {lin.AN4_TUNED['word_exit']:g}, sil-exit "
        f"{lin.AN4_TUNED['sil_exit']:g}; B {B}, T {T}, {int(lens.sum())} frames ({audio_s:.1f} s); "
        f"{time.perf_counter() - t_phase:.1f} s")
    check(int(lens.sum()) == lin.AN4_FRAMES and B == lin.AN4_UTTERANCES, "the AN4 corpus's size")

    flat = torch.as_tensor(feats.reshape(B * T, dim), device=dev)
    N, chunk = B * T, 1 << 15
    real_rows = torch.as_tensor((np.arange(T)[None, :] < lens[:, None]).reshape(-1), device=dev)
    t0 = time.perf_counter()
    qp = tq.build_quant_pack(model, device=dev)
    t1 = time.perf_counter()
    qps = tq.build_quant_pack(model, preselection=True, device=dev)
    log(f"[31] quantized packs: {t1 - t0:.2f} s; with preselection (k-means of {J} slots into "
        f"{qps.qcenters.shape[0]} clusters on the host, {qps.n_selected} selected) "
        f"{time.perf_counter() - t1:.2f} s")
    o_res, o_first, q8_am = {}, {}, None
    x = flat[:chunk]
    lib = _native.load()
    for tag, pack in (("", qp), ("[preselect]", qps)):
        C = 0 if pack.qcenters is None else pack.qcenters.shape[0]
        got = torch.cat([tq.am_scores_q_cuda(pack, flat[i:i + chunk]) for i in range(0, N, chunk)])
        first = torch.cat([tq.am_scores_q_cuda(pack, flat[i:i + chunk], first_design=True)
                           for i in range(0, N, chunk)])
        ref = torch.cat([tq.am_scores_q_reference(pack, flat[i:i + chunk])
                         for i in range(0, N, chunk)])
        torch.cuda.synchronize()
        same, err = bit_equal([got], [ref])
        same_f, err_f = bit_equal([first], [ref])
        backoff = (got[real_rows] == pack.backoff).double().mean().item()
        ms, first_ms, plain_ms, turns = designs_in_turns(
            lambda: tq.am_scores_q_reference(pack, x), lambda: tq.am_scores_q_cuda(pack, x),
            lambda: tq.am_scores_q_cuda(pack, x, first_design=True), 2, 10)
        bnd = quantized_bound(chunk, S, J, dim, C)
        o_res[tag] = (err, ms, plain_ms, bnd)
        o_first[tag] = (err_f, first_ms, plain_ms, bnd)
        rb = tq.kernel_row_bytes(dim)
        log(f"[31] kernel O{tag} on {N} frames ({-(-N // chunk)} chunks of {chunk}): tensor-core "
            f"design {'torch.equal' if same else 'DIFFERS'}, first design "
            f"{'torch.equal' if same_f else 'DIFFERS'} to the plain version (max abs err {err:g}, "
            f"{err_f:g}); backoff cells {backoff:.4f} of the live frames'; a {chunk}-frame launch "
            f"{ms:.4f} ms, first design {first_ms:.4f} ms ({first_ms / ms:.2f}x), plain "
            f"{plain_ms:.2f} ms (in turns plain, new, first, first, new, plain "
            f"{[round(t, 4) for t in turns]}), bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"{ms / bnd[0]:.1f}x; rows of {rb} bytes, {lib.sr_quantized_scores_tile(rb)} frames a "
            f"block, {lib.sr_quantized_scores_residency(rb, C, D, 0)} blocks an SM (first design "
            f"{lib.sr_quantized_scores_residency(tq.kernel_dim4(dim) * 4, C, D, 1)}); {card}")
        check(same and same_f, f"kernel O{tag} differs from its plain version")
        check(ms < first_ms, f"kernel O{tag}'s tensor-core design is not faster than its first "
              f"design in turns ({ms:.4f} against {first_ms:.4f} ms)")
        if not tag:
            q8_am = got.reshape(B, T, S)
    log(f"[31] kernel O registers: tensor-core design {ptxas_usage('quantized_mma_kernel')}; "
        f"first design {ptxas_usage('quantized_scores_kernel')}")
    # past the first design's limits: dim 200 (256-byte rows) and 512
    # clusters (the selection in device scratch), a synthetic pooled model
    wrng = np.random.default_rng(200)
    wide = gmm.MixtureModel.from_raw(lin.pooled_raw(wrng, 200, 6, 200, empty_share=0.1),
                                     gmm.VarianceModel.GLOBAL_POOLING, max_approx=True)
    xw = torch.as_tensor(lin.features_near_means(wrng, wide, wrng.integers(0, 200, chunk)),
                         device=dev)
    wide_res = {}
    for tag, pack in (("[dim 200]", tq.build_quant_pack(wide, device=dev)),
                      ("[dim 200, preselect]", tq.build_quant_pack(
                          wide, preselection=True, num_clusters=512, device=dev))):
        C = 0 if pack.qcenters is None else pack.qcenters.shape[0]
        got = tq.am_scores_q_cuda(pack, xw)
        ref = tq.am_scores_q_reference(pack, xw)
        torch.cuda.synchronize()
        same, err = bit_equal([got], [ref])
        ms, plain_ms, turns = in_turns(lambda: tq.am_scores_q_reference(pack, xw),
                                       lambda: tq.am_scores_q_cuda(pack, xw), 2, 10)
        bnd = quantized_bound(chunk, 200, 200 * pack.density_cap, 200, C)
        wide_res[tag] = (err, ms, plain_ms, bnd)
        scratch = lib.sr_quantized_scores_scratch(tq.kernel_row_bytes(200), C)
        log(f"[31] kernel O{tag} ({C} clusters, {pack.n_selected if C else 0} selected; scratch "
            f"{scratch} bytes a block): {'torch.equal' if same else 'DIFFERS'} to the plain version "
            f"on {chunk} frames; {ms:.4f} ms, plain {plain_ms:.2f} ms (in turns "
            f"{[round(t, 4) for t in turns]}), bound {bnd[0]:.4f} ms ({bnd[1]}); {card}")
        check(same and (not C or (C > 256 and scratch > 0)),
              f"kernel O{tag} past the first design's limits")
    # the library's context, a different function: one int8 product of the
    # [chunk, 48] quantized frames and the [48, J] means, no minimum, no mask
    a8 = torch.nn.functional.pad(tq.quantize_features(qp, x), (0, 48 - dim)).contiguous()
    b8 = torch.nn.functional.pad(qp.qmeans, (0, 48 - dim)).t().contiguous()
    cross = torch._int_mm(a8, b8)
    check(torch.equal(cross[:64], (a8[:64].double() @ b8.double()).to(torch.int32)),
          "torch._int_mm's cross product")
    int_mm_ms = cuda_ms(lambda: torch._int_mm(a8, b8), 20)
    log(f"[31] library context: torch._int_mm [{chunk}, 48] x [48, {J}] int8 -> int32 "
        f"{int_mm_ms:.4f} ms ({2.0 * chunk * 48 * J / int_mm_ms / 1e9:.1f} TOP/s); {card}")

    # -- 32. kernels M and N, and the decode ---------------------------------------
    pack64 = model.pack(dtype=torch.float64, device=dev)
    am64 = gmm.am_scores(pack64, flat).reshape(B, T, S).contiguous()
    lens_t = torch.as_tensor(lens, device=dev)

    def walk_args(outs):
        return tuple(outs[i] for i in (0, 1, 2, 4, 5, 6))

    m_res, m_first, n_res, n_first, cut = {}, {}, None, None, PLAIN_LIN_CUT
    n_books(dev, card, tl, lin)
    for dt, am in ((torch.float32, q8_am.contiguous()), (torch.float64, am64)):
        word = 8 if dt == torch.float64 else 4
        f64 = int(word == 8)
        args = lt.args(dev, dt, S)
        for prune, thr in ((True, 200.0), (False, 1e9)):
            held = {}

            def kernel():
                held["k"] = tl.decode_scan_linear_cuda(am, lens_t, *args, thr, prune=prune)

            def first():
                held["f"] = tl.decode_scan_linear_cuda(am, lens_t, *args, thr, prune=prune,
                                                       first_design=True)

            def plain():
                held["p"] = tl.decode_scan_linear_reference(am, lens_t, *args, thr, prune=prune)

            if prune:       # timed in turns on the whole batch
                ms, first_ms, plain_ms, turns = designs_in_turns(plain, kernel, first, 1, 5)
                ref = held["p"]
            else:
                kernel()
                first()
                ref = tl.decode_scan_linear_reference(am[:cut].contiguous(), lens_t[:cut], *args,
                                                      thr, prune=prune)
            outs, in_scratch = held["k"]
            fouts, f_in_scratch = held["f"]
            n = ref[0].shape[1]
            same, err = bit_equal([o[:, :n] for o in outs], ref)
            same_f, err_f = bit_equal([o[:, :n] for o in fouts], ref)
            words = tl.traceback_linear_cuda(*walk_args(outs), lens_t)
            words_first = tl.traceback_linear_cuda(*walk_args(outs), lens_t, first_design=True)
            words_ref = tl.traceback_linear_reference(*walk_args(outs), lens_t)
            torch.cuda.synchronize()
            same_n = torch.equal(words, words_ref) and torch.equal(words_first, words_ref)
            log(f"[32] kernel M {dt} {'pruned at 200' if prune else 'unpruned'}: eight outputs of the "
                f"warp instance {'torch.equal' if same else 'DIFFER'}, of the first design "
                f"{'torch.equal' if same_f else 'DIFFER'} to the plain version over "
                f"{'all' if prune else f'the first {cut}'} utterances; kernel N's words "
                f"(both designs) {'torch.equal' if same_n else 'DIFFER'} on all {B}; in scratch "
                f"{in_scratch}, "
                f"{f_in_scratch}")
            check(same and same_f and same_n and not in_scratch and not f_in_scratch,
                  f"kernels M / N differ from their plain versions ({dt}, prune {prune})")
            if prune:
                bnd = linear_bound(B, T, S, lt.word_len, Ps, word)
                m_res[dt] = (err, ms, plain_ms, bnd)
                m_first[dt] = (err_f, first_ms, plain_ms, bnd)
                check(ms < first_ms, f"kernel M's warp instance is not faster than its first "
                      f"design in turns ({dt}: {ms:.4f} against {first_ms:.4f} ms)")
                log(f"[32] kernel M {dt}: warp instance "
                    f"(sr_linear_scan_instance {lib.sr_linear_scan_instance(W, P, Ps, S, T, f64)}) "
                    f"{ms:.4f} ms ({ms / T * 1e3:.2f} us a frame of T {T}), first design "
                    f"{first_ms:.4f} ms ({first_ms / T * 1e3:.2f} us), {first_ms / ms:.2f}x; plain "
                    f"{plain_ms:.1f} ms (in turns plain, new, first, first, new, plain "
                    f"{[round(t, 4) for t in turns]}), bound {bnd[0]:.4f} ms ({bnd[1]}), "
                    f"{ms / bnd[0]:.1f}x (first design {first_ms / bnd[0]:.1f}x); 512 threads, "
                    f"{lib.sr_linear_scan_residency(W, P, Ps, S, f64, 0)} blocks an SM (first design "
                    f"{min(512, -(-(W + 1) // 32) * 32)} threads, "
                    f"{lib.sr_linear_scan_residency(W, P, Ps, S, f64, 1)} an SM, its shared memory "
                    f"{lib.sr_linear_scan_scratch(W, P, Ps, S, f64)} (0: fits)); {card}")
                if dt == torch.float32:
                    n_res, n_first = n_in_turns(dev, card, tl, walk_args(outs), lens_t, W, word)
    log(f"[32] kernel M registers: warp instance {ptxas_usage('linear_scan_warp_kernel')}; first "
        f"design {ptxas_usage('linear_scan_kernel')}")

    # kernel M with its state in device scratch (300 words of 30 positions)
    srng = np.random.default_rng(7)
    slex = lin.tied_lexicon([30] * 299 + [3], 3, 40, srng)
    slm, slm_start = lin.random_lm(srng, slex.num_words, 0, 10.0)
    slt = tl.LinearTables.build(tm.decoder_tables(slex), slm, slm_start, 0)
    sam = torch.as_tensor(srng.uniform(0.0, 6.0, (4, 40, 40)), dtype=torch.float32, device=dev)
    slens = torch.as_tensor([40, 31, 17, 40], dtype=torch.int32, device=dev)
    sargs = (sam, slens, *slt.args(dev, torch.float32, 40), 200.0)
    souts, s_in = tl.decode_scan_linear_cuda(*sargs)
    sref = tl.decode_scan_linear_reference(*sargs)
    check(s_in and all(torch.equal(o, r) for o, r in zip(souts, sref)),
          "kernel M in device scratch differs from its plain version")
    s_ms, s_plain, _ = in_turns(lambda: tl.decode_scan_linear_reference(*sargs),
                                lambda: tl.decode_scan_linear_cuda(*sargs), 1, 5)
    s_bnd = linear_bound(4, 40, 40, slt.word_len, 3, 4)
    log(f"[32] kernel M in device scratch (299 words x 30 positions, B 4, T 40): torch.equal; "
        f"{s_ms:.4f} ms ({s_ms / 40 * 1e3:.1f} us a frame), plain {s_plain:.1f} ms, bound "
        f"{s_bnd[0]:.6f} ms; {card}")

    # the main paths: an4_system.decode (the user's entry point) on the
    # int8 scores (the production scorer) with and without preselection and
    # on the float "mxu" scores, pruned at 200; the float64 linear decode
    counters = {"O": tq.am_scores_q, "M": tl.decode_scan_linear, "N": tl.traceback_linear}

    def run_path(fn):
        for f in counters.values():
            f.LAUNCHES = 0
        tl.decode_scan_linear.SCRATCH_LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: f.LAUNCHES for k, f in counters.items()}
        n["M in scratch"] = tl.decode_scan_linear.SCRATCH_LAUNCHES
        return out, n, wall, torch.cuda.max_memory_allocated() / 2 ** 30

    launches, hyps = {}, {}
    for name in ("linear-q8", "linear-q8-preselect", "linear"):
        r, n, wall, peak = run_path(lambda: an4_system.decode(
            model, corpus, corpus.orths, lex, tm, lm, lm_start, 200.0, True, False, name,
            device=dev))
        launches[name], hyps[name] = n, r["hyps"]
        log(f"[32] an4_system.decode {name} (pruned at 200): WER {r['wer']:.2f} % SER "
            f"{r['ser']:.2f} % S/I/D {r['errors']} over {r['n_words']} words; decode "
            f"{r['decode_s']:.4f} s, RTF {r['rtf']:.6f}; call {wall:.2f} s (packs built "
            f"inside); peak {peak:.2f} GiB; launches {n}; {card}")
        check(n["M"] == 1 and n["N"] == 1 and n["M in scratch"] == 0
              and n["O"] == (-(-N // chunk) if "q8" in name else 0),
              f"the {name} decode's launches: {n}")
    walls = []
    for _ in range(3):
        h64, n64, wall, peak64 = run_path(lambda: tl.decode_batch_linear_lvcsr(
            pack64, feats, lens, tables, lm, lm_start, 200.0, lex.silence_idx, prune=True,
            dtype=torch.float64))
        walls.append(wall)
    launches["f64"] = n64
    check(n64["M"] == 1 and n64["N"] == 1 and n64["M in scratch"] == 0,
          f"the float64 decode's launches: {n64}")
    pack32 = model.pack(dtype=torch.float32, device=dev)
    walls32 = []
    for _ in range(3):
        h32, n32, wall, peak32 = run_path(lambda: tl.decode_batch_linear_lvcsr(
            pack32, feats, lens, tables, lm, lm_start, 200.0, lex.silence_idx, prune=True))
        walls32.append(wall)
    check(h32 == hyps["linear"], "decode_batch_linear_lvcsr equals an4_system.decode's linear")
    log(f"[32] decode_batch_linear_lvcsr (\"mxu\" scores, kernels M and N), wall around the call "
        f"over {B} utterances: float32 {[round(w, 4) for w in walls32]} s (RTF "
        f"{[round(w / audio_s, 6) for w in walls32]}, peak {peak32:.2f} GiB), float64 "
        f"{[round(w, 4) for w in walls]} s (RTF {[round(w / audio_s, 6) for w in walls]}, peak "
        f"{peak64:.2f} GiB), transcripts float64 vs float32 differing "
        f"{sum(a != b for a, b in zip(h64, h32))}, q8 vs float32 "
        f"{sum(a != b for a, b in zip(hyps['linear-q8'], h32))}, q8 preselection vs q8 "
        f"{sum(a != b for a, b in zip(hyps['linear-q8-preselect'], hyps['linear-q8']))}; {card}")
    # the same decodes with M's and O's first designs forced: the same
    # transcripts (the main paths' launch counts above are not these runs')
    with mock.patch.object(tl, "decode_scan_linear_cuda",
                           functools.partial(tl.decode_scan_linear_cuda, first_design=True)), \
            mock.patch.object(tq, "am_scores_q_cuda",
                              functools.partial(tq.am_scores_q_cuda, first_design=True)):
        first_hyps = {name: an4_system.decode(model, corpus, corpus.orths, lex, tm, lm, lm_start,
                                              200.0, True, False, name, device=dev)["hyps"]
                      for name in ("linear-q8", "linear-q8-preselect", "linear")}
        first_hyps["f64"] = tl.decode_batch_linear_lvcsr(
            pack64, feats, lens, tables, lm, lm_start, 200.0, lex.silence_idx, prune=True,
            dtype=torch.float64)
    new_hyps = dict(hyps, f64=h64)
    differ = {k: sum(a != b for a, b in zip(new_hyps[k], first_hyps[k])) for k in first_hyps}
    log(f"[32] the decodes with the first designs of M and O forced: transcripts that differ from "
        f"the new designs' {differ} (q8, q8 with preselection, float32 \"mxu\", float64)")
    check(not any(differ.values()), f"the first designs' transcripts differ: {differ}")

    # -- 33. cross-checks ---------------------------------------------------------
    tdp = TdpModel(silence_state=0, loop=1.0, forward=0.0, skip=4.0)
    for seed in range(7):
        base, olm, olm_start, oam, ext, ext_lm, ext_start, oam_ext = lin.oracle_case(seed)
        To = oam.shape[1]
        ofeats, olens = np.zeros((1, To, 1), np.float32), np.asarray([To])
        want = decode_batch_bigram(None, ofeats, olens, DecoderTables.build(ext, tdp, 0.0),
                                   ext_lm, ext_start, 1e9, silence_idx=-1, prune=False,
                                   dtype=torch.float64, am=torch.as_tensor(oam_ext, device=dev))
        got = tl.decode_batch_linear_lvcsr(None, ofeats, olens, DecoderTables.build(base, tdp, 0.0),
                                           olm, olm_start, 1e9, 0, prune=False,
                                           dtype=torch.float64, am=torch.as_tensor(oam, device=dev))
        check(got[0] == [w for w in want[0] if w in (1, 2)],
              f"the silence-copy oracle, seed {seed}: {got[0]} against {want[0]}")
    log("[33] the silence-copy oracle (tests/test_linear_lvcsr.py's, 7 seeds, float64): kernel "
        "J's decode of the extended lexicon equals kernels M + N's linear decode")
    exact = {}
    for name in ("linear", "f32"):
        r = an4_system.decode(model, corpus, corpus.orths, lex, tm, lm, lm_start, 1e9, False,
                              False, name, device=dev)
        exact[name] = r
        log(f"[33] an4_system.decode {name} unpruned{' (WCTS, kernel K, transparent silence)' if name == 'f32' else ''}: "
            f"WER {r['wer']:.2f} % S/I/D {r['errors']}, decode {r['decode_s']:.4f} s, RTF "
            f"{r['rtf']:.6f}, mean active states {r['mean_active_states']:.1f}; {card}")
    differ = [i for i, (a, b) in enumerate(zip(exact["linear"]["hyps"], exact["f32"]["hyps"]))
              if a != b]
    log(f"[33] exact linear against exact WCTS: {len(differ)} of {B} transcripts differ "
        f"{differ[:10]}; pruned linear against exact linear: "
        f"{sum(a != b for a, b in zip(hyps['linear'], exact['linear']['hyps']))}")
    log(f"[31-33] phase seconds {time.perf_counter() - t_phase:.1f}")

    rep_m = "speechrecognition_tpu/search/linear_lvcsr.py:54"
    rep_o = "speechrecognition_tpu/models/quantized.py:257"
    rep_n = "speechrecognition_tpu/search/linear_lvcsr.py:313"
    entries = [
        entry("linear_scan", "linear_lvcsr_scan.cu", rep_m, launches["linear-q8"]["M"],
              *m_res[torch.float32]),
        entry("linear_scan[f64]", "linear_lvcsr_scan.cu", rep_m, launches["f64"]["M"],
              *m_res[torch.float64]),
        # the first design, forced beside the warp instance: no main path launches it
        entry("linear_scan[first design]", "linear_lvcsr_scan.cu", rep_m, 0,
              *m_first[torch.float32]),
        entry("linear_scan[first design, f64]", "linear_lvcsr_scan.cu", rep_m, 0,
              *m_first[torch.float64]),
        entry("linear_scan in scratch", "linear_lvcsr_scan.cu", rep_m,
              sum(n["M in scratch"] for n in launches.values()), 0.0, s_ms, s_plain, s_bnd),
        entry("linear_traceback", "linear_traceback.cu", rep_n, launches["linear-q8"]["N"],
              *n_res),
        # the first design, forced beside the warp design
        entry("linear_traceback[first design]", "linear_traceback.cu", rep_n, 0, *n_first),
        entry("quantized_scores", "quantized_scores.cu", rep_o, launches["linear-q8"]["O"],
              *o_res[""]),
        entry("quantized_scores[preselect]", "quantized_scores.cu", rep_o,
              launches["linear-q8-preselect"]["O"], *o_res["[preselect]"]),
        # the first design, forced beside the tensor-core design
        entry("quantized_scores[first design]", "quantized_scores.cu", rep_o, 0, *o_first[""]),
        entry("quantized_scores[first design, preselect]", "quantized_scores.cu", rep_o, 0,
              *o_first["[preselect]"]),
    ]
    for e in entries[-4:]:
        e["library_ms"] = int_mm_ms
    # past the first design's limits: no main path meets them
    entries += [entry(f"quantized_scores{tag}", "quantized_scores.cu", rep_o, 0, *r)
                for tag, r in wide_res.items()]
    return entries


#: phase 34: the char-RNN's training steps on README.md's characters, the
#: steps compared with the CPU, and the characters sampled
CHAR_RNN_STEPS = 1000
CHAR_RNN_CPU_STEPS = 3
CHAR_RNN_SAMPLE = 200


def char_rnn_phase(dev, card):
    """Phase 34: the char-RNN LM (lm/char_rnn.py) on the card at the
    reference's widths (hidden 100, windows of 25, lr 0.1) on README.md's
    characters. No hand kernel: a step is a loop of torch ops and autograd."""
    from speechrecognition_torch.lm import char_rnn as cr
    t_phase = time.perf_counter()
    text = (REPO / "README.md").read_text()
    lm = cr.CharRnnLm(text, hidden_size=100, seq_length=25, learning_rate=0.1, seed=0)
    check(lm.params["Wxh"].device.type == "cuda", "CharRnnLm's parameters are on the card")
    # train_step in float64 on the card against the CPU port, same parameters
    where = {"card": {k: v.double() for k, v in lm.params.items()}}
    where["cpu"] = {k: v.cpu() for k, v in where["card"].items()}
    state = {w: (p, {k: torch.zeros_like(v) for k, v in p.items()},
                 torch.zeros(100, dtype=torch.float64, device=p["bh"].device))
             for w, p in where.items()}
    err = 0.0
    for i in range(CHAR_RNN_CPU_STEPS):
        x, y = lm.data[25 * i: 25 * i + 25], lm.data[25 * i + 1: 25 * i + 26]
        out = {w: cr.train_step(*st[:2], x, y, st[2], 0.1) for w, st in state.items()}
        pairs = [(out["card"][0][k], out["cpu"][0][k]) for k in cr.NAMES]
        pairs += [(out["card"][1][k], out["cpu"][1][k]) for k in cr.NAMES]
        pairs += [(out["card"][2], out["cpu"][2]), (out["card"][3], out["cpu"][3])]
        err = max([err] + [((a.cpu() - b).abs() / (1.0 + b.abs())).max().item()
                           for a, b in pairs])
        state = {w: (o[0], o[1], o[3]) for w, o in out.items()}
    log(f"[34] char-RNN train_step in float64 (V {len(lm.vocab)}, H 100, T 25), "
        f"{CHAR_RNN_CPU_STEPS} steps: params, Adagrad state, loss and h within {err:.2e} of the "
        f"CPU port's (|card - cpu| / (1 + |cpu|))")
    check(err <= 1e-10, f"the char-RNN's float64 train_step on the card differs from the CPU "
          f"({err:.3e})")
    # CharRnnLm.train and sample_text on the card, float32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = lm.train(CHAR_RNN_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / CHAR_RNN_STEPS
    t0 = time.perf_counter()
    out = lm.sample_text(CHAR_RNN_SAMPLE, seed_char="T", rng_seed=1)
    char_ms = (time.perf_counter() - t0) * 1e3 / CHAR_RNN_SAMPLE
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    at = {n: round(float(np.mean(losses[n - 20:n])), 2) for n in (100, 300, 500, 800)}
    log(f"[34] CharRnnLm on README.md ({len(text)} characters, {len(lm.vocab)} symbols), "
        f"float32: {CHAR_RNN_STEPS} train steps, mean loss of the first 20 {first:.2f}, of the "
        f"last 20 {last:.2f} ({last / first:.3f}; of the 20 before steps 100, 300, 500, 800: {at}),"
        f" smoothed {lm.smooth_loss:.2f}; {step_ms:.3f} ms a train_step (host clock, a float() of "
        f"the loss a step); {CHAR_RNN_SAMPLE} characters sampled, {char_ms:.3f} ms a character: "
        f"{out[:60]!r}; phase {time.perf_counter() - t_phase:.1f} s; {card}")
    check(all(np.isfinite(losses)) and last < 0.5 * first,
          f"the char-RNN's loss did not fall under half ({first:.2f} -> {last:.2f})")
    check(len(out) == CHAR_RNN_SAMPLE and set(out) <= set(lm.vocab),
          "the char-RNN's samples leave the vocabulary")


#: phase 35's profiled pass, run in a fresh process: argv the repo, the
#: network config and the segment names; prints the device events as JSON
FLF_PROFILE_CHILD = """
import io, json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from speechrecognition_torch.lexicon import build_sietill_lexicon
from speechrecognition_torch.search.flf_network import FlfNetwork
from speechrecognition_torch.sprint.config import SprintConfig
lex = build_sietill_lexicon()
net = FlfNetwork.parse(SprintConfig.read(sys.argv[2]), list(lex.orth), silence=lex.silence_idx)
names = sys.argv[3].split(",")
net.run(names, out=io.StringIO())
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    net.run(names, out=io.StringIO())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
print(json.dumps({"seconds": secs, "events": [
    [e.key, e.count, us(e)] for e in prof.key_averages()
    if e.device_type == torch.autograd.DeviceType.CUDA]}))
"""

#: phase 35: arc scores of the card's recognizer lattices against the CPU
#: port's, relative: the f64 scores are sums of cuBLAS products on the card
#: and of the CPU's BLAS products there, nothing else differs
FLF_SCORE_RTOL = 1e-9
FLF_PASSES = 3


def flf_phase(dev, card):
    """Phase 35: the Flf network's recognizer node on the card (see the
    module docstring). Returns kernel J's launches on this path."""
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.search.flf_network import FlfNetwork
    from speechrecognition_torch.sprint.config import SprintConfig
    t_phase = time.perf_counter()
    ft = tables_module("torch_flf_tables")
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    lex = build_sietill_lexicon()
    names = ft.demo_segment_names()
    check(len(names) == 35, "the demo corpus has 35 segments")
    def write_config(tmp):
        return str(ft.recognizer_config(
            Path(tmp) / "net.config", golden["config"], links="best cn",
            extra="[network.cn]\ntype = CN-builder\nlinks = cndec\n"
                  "[network.cndec]\ntype = CN-decoder\n"))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = SprintConfig.read(write_config(tmp))
    nets = {d: FlfNetwork.parse(cfg, list(lex.orth), silence=lex.silence_idx,
                                **({} if d == "card" else {"device": "cpu"}))
            for d in ("card", "cpu")}
    check(nets["card"].device == "cuda", "the Flf network's default device is the card")

    def run(d):
        return nets[d].run(names, out=io.StringIO())

    run("card")                             # warm-up: builds the recognizer, loads the kernels
    torch.cuda.synchronize()
    ng.decode_scan_bigram.LAUNCHES = 0
    res = run("card")
    torch.cuda.synchronize()
    launches = ng.decode_scan_bigram.LAUNCHES
    check(launches == len(names), f"kernel J launched {launches} times on {len(names)} segments")
    check(len(nets["card"]._archives_misc) == 1, "one recognizer, cached on the network")
    hyps = {u["idx"]: u["hyp"] for u in golden["utts"]}
    wrong = [n for i, n in enumerate(names)
             if [w for w in res[n]["best"] if w != lex.silence_idx] != hyps[i]]
    check(not wrong, f"Flf best paths differ from the golden hyps at {wrong}")

    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    worst, arcs = 0.0, 0
    for n in names:
        a, b = res[n]["rec"], cpu[n]["rec"]
        check([(x.start, x.end, x.word) for x in a.arcs] ==
              [(x.start, x.end, x.word) for x in b.arcs] and a.num_frames == b.num_frames,
              f"the card's lattice of {n} differs in its arcs from the CPU port's")
        for x, y in zip(a.arcs, b.arcs):
            check(np.isfinite(x.score), f"a non-finite arc score in {n}")
            worst = max(worst, abs(x.score - y.score) / max(abs(y.score), 1e-300))
        arcs += len(a.arcs)
    check(worst <= FLF_SCORE_RTOL, f"the card's arc scores differ from the CPU port's by "
          f"{worst:.3e} relative")
    cn_differ = [n for n in names if res[n]["cndec"] != cpu[n]["cndec"]]

    from speechrecognition_torch.search.edit_distance import edit_distance
    ref_of = {u["idx"]: u["ref"] for u in golden["utts"]}
    refs = {n: ref_of[i] for i, n in enumerate(names)}
    err_best = sum(edit_distance(refs[n], [w for w in res[n]["best"] if w != lex.silence_idx])
                   .total_count for n in names)
    err_cn = sum(edit_distance(refs[n], [w for w in res[n]["cndec"] if w != lex.silence_idx])
                 .total_count for n in names)
    total = sum(len(r) for r in refs.values())
    check(err_cn <= err_best + max(2, int(0.02 * total)),
          f"CN consensus errors {err_cn} against the best paths' {err_best}")

    passes = []
    for _ in range(FLF_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run("card")
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3 / len(names))
    S, W, P = lex.num_states, lex.num_words, lex.max_positions
    check(S == 106, f"the demo system has 106 mixtures, not {S}")
    frames = sum(res[n]["rec"].num_frames for n in names)
    log(f"[35] Flf recognizer network (rec -> best, rec -> CN-builder -> CN-decoder) on the card, "
        f"35 demo segments ({frames} frames), f64 \"mxu\" scores, kernel J at B=1: 35/35 golden "
        f"best paths; lattices ({arcs} arcs) equal the CPU port's, scores within {worst:.3e} "
        f"relative; CN decodes that differ from the CPU port's: {len(cn_differ)} {cn_differ}; "
        f"word errors best path {err_best}, CN {err_cn} of {total}; kernel J launches "
        f"{launches}")
    # the profiled pass runs in a fresh process: late in this script the
    # profiler records fewer launches than were made (device_ms), for kernel J
    # here 32 of 35 in each of three padded windows (PERF.md §7)
    with tempfile.TemporaryDirectory() as tmp:
        child = subprocess.run([sys.executable, "-c", FLF_PROFILE_CHILD, str(REPO),
                                write_config(tmp), ",".join(names)], cwd=REPO,
                               capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"the profiled Flf run failed:\n{child.stderr[-2000:]}")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    j_us = [(n, us) for key, n, us in prof["events"] if "bigram_scan" in key]
    j_n, j_ms = sum(n for n, _ in j_us), sum(us for _, us in j_us) / 1e3
    check(j_n == len(names), f"the profiler saw kernel J {j_n} times on {len(names)} segments")
    bounds = [bigram_bound(1, res[n]["rec"].num_frames, S, W, P, 8) for n in names]
    bnd = (sum(b[0] for b in bounds), bounds[0][1])
    log(f"[35] Flf recognizer: {float(np.median(passes)):.4f} ms a segment (host clock, median "
        f"of {FLF_PASSES} passes after a warm-up: {', '.join(f'{v:.4f}' for v in passes)}); "
        f"kernel J's device time {j_ms / len(names):.4f} ms a segment ({j_ms:.4f} ms over the 35, "
        f"{j_n} launches in the profiled pass, a fresh process), "
        f"its bound {bnd[0] / len(names):.6f} ms a segment ({bnd[1]}); the CPU port's node "
        f"{cpu_s * 1e3 / len(names):.4f} ms a segment; phase {time.perf_counter() - t_phase:.1f} "
        f"s; {card}")
    busy_us = sum(us for _key, _n, us in prof["events"])
    log(f"[35] Flf recognizer profiled pass: device busy share "
        f"{busy_us / 1e6 / prof['seconds']:.4f} ({busy_us / 1e3:.1f} ms of device time in "
        f"{prof['seconds']:.4f} s)")
    for key, n, us in sorted(prof["events"], key=lambda e: -e[2])[:8]:
        log(f"[35]   {us / 1e3:10.3f} ms  {n:6d}x  {key[:90]}")
    return launches


#: phase 36's profiled runs, in a fresh process: argv the repo, a pickle of
#: (model, features, lengths, tables, threshold), PROFILE_PAD_S and
#: PROFILE_TRIES. The df32 alignment and the f32 Baum-Welch pass each run
#: once to warm up, then in windows padded with idle time until the profiler
#: holds as many launches of each kernel as its wrapper counted (at most
#: PROFILE_TRIES windows); prints each run's seconds, windows, launches
#: counted and seen, and device events as JSON
SPRINT_PROFILE_CHILD = """
import json, pickle, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from speechrecognition_torch.align import baumwelch as bw, viterbi as vit
from speechrecognition_torch.models import gmm
from speechrecognition_torch.ops import mahalanobis as maha
pad, tries = float(sys.argv[3]), int(sys.argv[4])
with open(sys.argv[2], "rb") as f:
    model, feats, lens, tables, pruning = pickle.load(f)
dev = torch.device("cuda", 0)
df = model.pack_df(device=dev)
f32 = model.pack(dtype=torch.float32, method="pallas", device=dev)
runs = {"align df32": (
            lambda: vit.align_batch_chunked(df, feats, lens, tables, pruning, dtype="df32"),
            {"am_scores_df_kernel": gmm.am_scores_df, "align_fwd_df_": vit.align_fwd_chunk_df,
             "align_backtrack_kernel": vit.align_backtrack}),
        "Baum-Welch f32 pallas": (
            lambda: bw.baum_welch_posteriors(f32, feats, lens, tables, dtype=torch.float32),
            {"mahalanobis_kernel": maha.mahalanobis_min_scores,
             "fb_wide_chain_kernel": bw.forward_backward})}
us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
out = {}
for tag, (fn, kernels) in runs.items():
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        for w in kernels.values():
            w.LAUNCHES = 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            time.sleep(pad)
        events = [[e.key, e.count, us(e)] for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(n for key, n, _ in events if k in key) for k in kernels}
        launched = {k: w.LAUNCHES for k, w in kernels.items()}
        if seen == launched:
            break
    out[tag] = {"seconds": secs, "tries": attempt, "seen": seen, "launched": launched,
                "events": events}
print(json.dumps(out))
"""

#: phase 36: the root tool's training recipe (3 splits; 2 aligns and 3
#: estimates a split and threshold 300 are train_model's own)
SPRINT_SPLITS = 3
#: phase 36: the Baum-Welch passes' and the Viterbi alignments' utterances
#: (the whole corpus in one batch, as the trainer's realignment takes it)
SPRINT_SEGMENTS = 130


class Recorder:
    """Calls a kernel wrapper and keeps its last ``keep`` calls' (args,
    kwargs, result) in ``calls``. Every other attribute is the wrapper's
    own: a wrapper counts its launches on its module-level name, which is
    this object while it is patched in, so the counts stay on the wrapper."""

    def __init__(self, fn, calls, keep):
        vars(self).update(fn=fn, calls=calls, keep=keep)

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls.append((a, k, out))
        del self.calls[:-self.keep]
        return out

    def __getattr__(self, attr):
        return getattr(self.fn, attr)

    def __setattr__(self, attr, value):
        setattr(self.fn, attr, value)


def recorded(stack, mod, name, keep):
    """Patch ``mod.name`` with a Recorder while ``stack`` is open; returns
    its list of calls."""
    calls = []
    stack.enter_context(mock.patch.object(mod, name, Recorder(getattr(mod, name), calls, keep)))
    return calls


def e_first(vit, *a, **k):
    """Kernel E's first design (the block instance, its row in shared
    memory), forced on a call's arguments: (the cost row, the jumps),
    uncounted."""
    out, jumps, _scratch = vit.align_fwd_chunk_cuda(*a, first_design=True, **k)
    return out, jumps


def f_first(vit, *a, **k):
    """Kernel F's first design (the block instance, its row in shared
    memory), forced on a call's arguments: (the cost row, the jumps),
    uncounted."""
    out, jumps, _scratch = vit.align_fwd_chunk_df_cuda(*a, first_design=True, **k)
    return out, jumps


def flat(out):
    """A kernel's outputs as a flat list of tensors (DF pairs split)."""
    items = out if isinstance(out, (tuple, list)) else (out,)
    res = []
    for x in items:
        res.extend([x.hi, x.lo] if hasattr(x, "hi") else [x])
    return res


def sprint_phase(dev, card):
    """Phase 36: the Sprint tier's alignment and training path at AN4 width
    (see the module docstring). Returns the kernels' JSON entries."""
    import contextlib
    import pickle
    import re
    import shutil
    from speechrecognition_torch.align import baumwelch as bw
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.ops import mahalanobis as maha
    from speechrecognition_torch.sprint import mm_io
    from speechrecognition_torch.sprint.state_graph import (AllophoneStateGraphBuilder,
                                                            aligner_tables_for_orths)
    from speechrecognition_torch.tools import an4_system as an4
    from speechrecognition_torch.train import em
    t_phase = time.perf_counter()
    st = tables_module("torch_sprint_tables")
    root = REPO / "build" / "sprint36"
    shutil.rmtree(root, ignore_errors=True)
    wall = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    setup = timed("write the seeded setup", lambda: st.write_setup(str(root / "setup"), seed=0))
    cfg, corpus_xml, asm, lex, tm, net, pruning, _lm_scale = timed(
        "build_system", lambda: an4.build_system(**setup.build_system_args()))
    corpus, _ws = timed("load_corpus (Flow)", lambda: an4.load_corpus(corpus_xml, lex, net))
    check((corpus.num_segments, corpus.total_frames, corpus.dim, asm.num_classes,
           lex.num_words) == (130, 35570, 45, 501, 131),
          f"the AN4 shape: {corpus.num_segments} segments, {corpus.total_frames} frames, dim "
          f"{corpus.dim}, {asm.num_classes} classes, {lex.num_words} entries")
    builder = AllophoneStateGraphBuilder(model=asm, transition=tm)
    tables = timed("state graphs", lambda: aligner_tables_for_orths(
        builder, [seg.orth for seg in corpus_xml.segments]))
    A = tables.states.shape[1]
    short = [s for s in range(corpus.num_segments) if tables.lengths[s] > corpus.lengths[s]]
    log(f"[36] seeded AN4-shape setup: {corpus.num_segments} segments, "
        f"{corpus.total_frames} frames (the longest {int(corpus.lengths.max())}), "
        f"{lex.num_words} search-lexicon entries, {asm.num_classes} tied classes, Flow "
        f"features {corpus.features.shape} (cache dim 16, window 9 right 4, LDA 45); "
        f"state-graph chains of {int(tables.lengths.min())} to {A} positions; chains longer "
        f"than their segment: {len(short)} {short}; the AN4 TDPs (silence skip "
        f"{tm.silence.skip}), acoustic pruning {pruning}")

    # -- the df32 trainer, the training main path (launch counts) --------------------
    counters = {"A": maha.mahalanobis_min_scores, "A unfused": maha.mahalanobis_scores,
                "C": gmm.am_scores_df, "E": vit.align_fwd_chunk, "F": vit.align_fwd_chunk_df,
                "G": vit.align_backtrack, "H": gmm.em_pass_sorted, "L": bw.forward_backward}

    def zero():
        for fn in counters.values():
            fn.LAUNCHES = 0

    def counts():
        return {k: fn.LAUNCHES for k, fn in counters.items()}

    lines = []
    zero()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            an4, "log", lambda *a: lines.append(" ".join(map(str, a)))))
        n_chunks = -(-int(corpus.lengths.max()) // vit.ALIGN_CHUNK)
        rec = {"C": recorded(stack, gmm, "am_scores_df", n_chunks),
               "F": recorded(stack, vit, "align_fwd_chunk_df", n_chunks),
               "G": recorded(stack, vit, "align_backtrack", 1),
               "H": recorded(stack, em, "em_pass_sorted", 1)}
        model, train_s = timed("train_model (df32)", lambda: an4.train_model(
            corpus, lex, asm, str(root), SPRINT_SPLITS, "df32"))
    train_counts = counts()
    split = {m.group(1): float(m.group(2)) for m in
             (re.match(r"(.+?)\s+took ([\d.]+) seconds", ln) for ln in lines) if m}
    scores = [float(ln.split(":")[1]) for ln in lines if ln.startswith("AM score")]
    check(train_counts["E"] == 0 and all(train_counts[k] > 0 for k in "CFGH"),
          f"the df32 trainer's kernels: {train_counts}")
    check(scores and all(np.isfinite(scores)), "the trainer's AM scores are finite")
    audio_s = corpus.total_frames * corpus.frame_duration
    log(f"[36] train_model df32 ({SPRINT_SPLITS} splits, 2 aligns, 3 estimates, threshold 300): "
        f"{train_s:.4f} s ({train_s / audio_s:.5f} s a second of audio over {audio_s:.1f} s), "
        f"{model.num_densities()} densities; AM score {scores[0]:.6g} -> {scores[-1]:.6g}; "
        f"phase split {split}; launches {train_counts} on {card}")

    # -- the kernels of the trainer against their plain versions (its last calls) ----
    res, errs = {}, {}

    def check_calls(name, calls, plain, tol=None, key=None):
        """Each recorded call's outputs against the plain version's on the same
        inputs: bit-equal, or (``tol``) within tol relative. Keeps the largest
        absolute difference in ``errs[key or name]``; returns the largest
        relative one."""
        worst, err = 0.0, 0.0
        for a, k, out in calls:
            ref = plain(*a, **k)
            got, want = flat(out), flat(ref)
            if tol is None:
                same, e = bit_equal(got, want)
                check(same, f"kernel {name} is not bit-equal to its plain version")
                err = max(err, e)
            else:
                for g, r in zip(got, want):
                    worst = max(worst, max_rel(g, r))
                err = max(err, max((g.double() - r.double()).abs().max().item()
                                   for g, r in zip(got, want)))
        errs[key or name] = max(errs.get(key or name, 0.0), err)
        return worst

    check_calls("C", rec["C"], gmm.am_scores_df_reference)
    check_calls("F", rec["F"], vit.align_fwd_chunk_df_reference)
    check_calls("G", rec["G"], vit.align_backtrack_reference)
    (a_h, k_h, out_h), = rec["H"]
    ref_h = gmm.em_pass_sorted_reference(*a_h, **k_h)
    check(torch.equal(out_h[1], ref_h[1]), "kernel H's counts differ from its plain version")
    h_rel = max(max_rel(out_h[i], ref_h[i]) for i in (0, 2, 3))
    check(h_rel <= 1e-12, f"kernel H's sums differ from its plain version by {h_rel:.3e}")
    errs["H"] = max((g - r).abs().max().item() for g, r in zip(out_h, ref_h))
    log(f"[36] the trainer's last realignment and E-step against the plain versions: C "
        f"{len(rec['C'])} calls bit-equal (hi, lo), F {len(rec['F'])} chunks bit-equal (carry, "
        f"jumps), G bit-equal (states, final positions); H counts bit-equal, sums within "
        f"{h_rel:.3e} relative (limit 1e-12)")

    a_c, k_c, _ = rec["C"][0]
    N_c = a_c[1].shape[0]
    c_ms, c_plain, c_all = in_turns(lambda: gmm.am_scores_df_reference(*a_c, **k_c),
                                    lambda: gmm.am_scores_df(*a_c, **k_c), 1, 10)
    S_c, D_c, dim = a_c[0].num_mixtures, a_c[0].density_cap, corpus.dim
    J_c = S_c * D_c
    c_bnd = bound(4 * N_c * dim + 8 * (2 * J_c * dim + 2 * J_c) + 8 * N_c * S_c,
                  fp32=N_c * J_c * dim * C_ELEMENT_OPS + N_c * J_c * C_DENSITY_OPS)
    res["C"] = (c_ms, c_plain, c_bnd)
    a_f, k_f, out_f = rec["F"][0]
    f_ms, f_plain, f_all = in_turns(lambda: vit.align_fwd_chunk_df_reference(*a_f, **k_f),
                                    lambda: vit.align_fwd_chunk_df(*a_f, **k_f), 1, 10)
    B_f, C_f, A_f = a_f[1].hi.shape
    res["F"] = (f_ms, f_plain, align_bound(B_f, C_f, A_f, 8, df=True))
    # kernel F's first design (the block instance, forced) beside the wide
    # instance: bit-equal on the trainer's first recorded chunk, in turns
    same_ff, errs["F first"] = bit_equal(flat(f_first(vit, *a_f, **k_f)), flat(out_f))
    check(same_ff, "kernel F's first design is not bit-equal to the wide instance")
    fw_ms, ff_ms, ff_all = in_turns(lambda: f_first(vit, *a_f, **k_f),
                                    lambda: vit.align_fwd_chunk_df(*a_f, **k_f), 10, 10)
    res["F first"] = (ff_ms, f_plain, res["F"][2])
    a_g, k_g, _ = rec["G"][0]
    g_ms, g_plain, g_all, g_call = kernel_in_turns(
        lambda: vit.align_backtrack_reference(*a_g, **k_g),
        lambda: vit.align_backtrack(*a_g, **k_g), 1, 10, "align_backtrack_kernel",
        bare=g_bare(*a_g, **k_g))
    Tp_g, B_g, A_g = a_g[2].shape
    res["G"] = (g_ms, g_plain,
                bound(B_g * (Tp_g + 2 * A_g * 4 + 4 * a_g[5] + 4 + 3 * 4)))
    h_ms, h_plain, h_all = in_turns(lambda: gmm.em_pass_sorted_reference(*a_h, **k_h),
                                    lambda: gmm.em_pass_sorted(*a_h, **k_h), 1, 10)
    NB_h, R_h = a_h[2].shape
    live_h = int(a_h[2].sum().item())
    S_h, D_h = a_h[0].num_mixtures, a_h[0].density_cap
    res["H"] = (h_ms, h_plain, bound(
        4 * NB_h * R_h * (dim + 1) + 4 * NB_h + 8 * (2 * S_h * D_h * dim + 2 * S_h * D_h)
        + 8 * (2 * S_h * D_h * dim + S_h * D_h + 1),
        fp32=live_h * D_h * (dim * C_ELEMENT_OPS + C_DENSITY_OPS),
        fp64=live_h * (dim * H_ROW_DIM_F64 + H_ROW_F64)))
    for name, shape in (("C", f"N={N_c} S={S_c} D={D_c} dim={dim}"),
                        ("F", f"B={B_f} C={C_f} A={A_f} "
                              f"({instance('sr_align_fwd_df_warps', A_f)})"),
                        ("G", f"B={B_g} Tp={Tp_g} A={A_g} ({vit_tile(A_g)} frames a tile)"),
                        ("H", f"NB={NB_h} x {R_h} rows, {live_h} live, S={S_h} D={D_h}")):
        ms, plain_ms, bnd = res[name]
        log(f"[36] kernel {name} at {shape}, the trainer's: kernel {ms:.4f} ms"
            f"{' (device time)' if name == 'G' else ''}, plain {plain_ms:.4f} ms; bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), {ms / bnd[0]:.1f}x it"
            + (f"; {ms / C_f * 1e3:.3f} us a frame" if name == "F" else "") + f" on {card}")
    log(f"[36] kernel F's first design (the block instance, its row in shared memory, forced) "
        f"against the wide instance on the trainer's chunk, in turns (first, wide, wide, first: "
        f"{', '.join(f'{v:.4f}' for v in ff_all)} ms): first design {ff_ms:.4f} ms "
        f"({ff_ms / C_f * 1e3:.3f} us a frame, {ff_ms / res['F'][2][0]:.1f}x the bound) -> wide "
        f"instance {fw_ms:.4f} ms ({fw_ms / C_f * 1e3:.3f} us a frame, "
        f"{fw_ms / res['F'][2][0]:.1f}x); bit-equal {same_ff}; wide instance "
        f"{ptxas_usage(f'align_fwd_df_wide_kernelILi{f_positions(A_f)}E')}, first design "
        f"{ptxas_usage('align_fwd_df_block_kernel')} on {card}")

    # -- mm_io's round trip ----------------------------------------------------------
    pms = str(root / "am.pms")
    timed("mm_io write", lambda: mm_io.write_sprint_mixture_set(pms, model))
    dim_r, mixtures, densities, means, covs = timed(
        "mm_io read", lambda: mm_io.read_sprint_mixture_set(pms))
    kept = [[(mi, vi) for mi, vi in model.mixtures[s] if np.isfinite(model.means[mi]).all()
             and np.isfinite(model.mean_weights_log[mi])] for s in range(model.num_mixtures)]
    same = (dim_r == model.dim and [len(m) for m in mixtures] == [len(k) for k in kept]
            and all(np.array_equal(means[densities[d][0]], model.means[mi])
                    and lw == model.mean_weights_log[mi]
                    for row, krow in zip(mixtures, kept) for (d, lw), (mi, _v) in zip(row, krow))
            and np.array_equal(covs[0], model.vars[0]))
    back = read_mixture_set(str(root / "am.mix"), corpus.dim)
    log(f"[36] mm_io: {len(densities)} densities of {len(mixtures)} mixtures written and read "
        f"back equal {same} ({model.num_densities() - len(densities)} of classes no frame "
        f"reached dropped); am.mix read back: {len(back.mixtures)} mixtures")
    check(same, "mm_io's round trip changed the trained model")

    # -- the alignments and the Baum-Welch passes (launch counts) ---------------------
    ids = list(range(SPRINT_SEGMENTS))
    feats, lens = corpus.padded_batch(ids)
    T = feats.shape[1]
    runs = {}
    for tag, dt, make in (("f32 pallas", torch.float32,
                           lambda: model.pack(dtype=torch.float32, method="pallas", device=dev)),
                          ("f64 mxu", torch.float64,
                           lambda: model.pack(dtype=torch.float64, device=dev)),
                          ("df32", "df32", lambda: model.pack_df(device=dev))):
        pack = make()
        zero()
        with contextlib.ExitStack() as stack:
            rec = {"A": recorded(stack, maha, "mahalanobis_min_scores", 2),
                   "E": recorded(stack, vit, "align_fwd_chunk", 1),
                   "F": recorded(stack, vit, "align_fwd_chunk_df", 1),
                   "C": recorded(stack, gmm, "am_scores_df", 1),
                   "G": recorded(stack, vit, "align_backtrack", 1)}
            states, costs = timed(f"align {tag}", lambda: vit.align_batch_chunked(
                pack, feats, lens, tables, pruning, dtype=dt))
        runs[tag] = run = {"states": states, "costs": costs, "counts": counts(), "rec": rec,
                           "pack": pack}
        dead = int((costs >= 0.5e30).sum())
        log(f"[36] align_batch_chunked {tag}, {len(ids)} utterances (T {T}, A {A}), threshold "
            f"{pruning}: {wall[f'align {tag}']:.4f} s; launches {counts()}; utterances whose "
            f"row died {dead}")
        for name, plain in (("E", vit.align_fwd_chunk_reference),
                            ("F", vit.align_fwd_chunk_df_reference),
                            ("C", gmm.am_scores_df_reference),
                            ("G", vit.align_backtrack_reference)):
            if rec[name]:
                check_calls(name, rec[name], plain, key=f"E {tag}" if name == "E" else None)
        if rec["A"]:
            run["A rel"] = check_calls("A", rec["A"], maha.mahalanobis_min_scores_reference,
                                       tol=A_REL_TOL)
            check(run["A rel"] <= A_REL_TOL,
                  f"kernel A fused differs from plain by {run['A rel']:.3e}")
    f32s, f64s, dfs = (runs[k]["states"] for k in ("f32 pallas", "f64 mxu", "df32"))
    c32, c64, cdf = (runs[k]["counts"] for k in ("f32 pallas", "f64 mxu", "df32"))
    check(c32["A"] > 0 and c32["E"] > 0 and c64["E"] > 0 and cdf["F"] > 0 and cdf["C"] > 0
          and all(r["counts"]["G"] > 0 for r in runs.values()), "an alignment skipped a kernel")
    check(not (runs["f32 pallas"]["costs"] >= 0.5e30).any()
          and not (runs["f64 mxu"]["costs"] >= 0.5e30).any(),
          "an f32 or f64 alignment lost an utterance")
    frames_live = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    differ = {k: int(((s != f64s) & frames_live).sum()) for k, s in (("f32", f32s), ("df32", dfs))}
    log(f"[36] alignment frames that differ: f32 against f64 {differ['f32']}, df32 against f64 "
        f"{differ['df32']} of {int(frames_live.sum())}"
        f" (df32 splits the infinite silence skip into (inf, NaN): ROADMAP Queue 3 #21); every "
        f"kernel of the three runs bit-equal to its plain version (A fused within "
        f"{runs['f32 pallas']['A rel']:.3e} relative, limit {A_REL_TOL:g}; within 3.8e-7: "
        f"{runs['f32 pallas']['A rel'] <= 3.8e-7})")

    bw_counts = {}
    for tag, dt, pack in (("f64 mxu", torch.float64, runs["f64 mxu"]["pack"]),
                          ("f32 pallas", torch.float32, runs["f32 pallas"]["pack"])):
        zero()
        with contextlib.ExitStack() as stack:
            rec = recorded(stack, bw, "forward_backward", 1)
            rec_a = recorded(stack, maha, "mahalanobis_min_scores", 2)
            gamma, log_z = timed(f"Baum-Welch {tag}", lambda: bw.baum_welch_posteriors(
                pack, feats, lens, tables, dtype=dt))
        bw_counts[tag] = c = counts()
        check(c["L"] > 0 and (c["A"] > 0) == (tag == "f32 pallas"),
              f"the Baum-Welch pass ({tag}) launched {c}")
        check(bool(torch.isfinite(gamma).all() and torch.isfinite(log_z).all()),
              f"Baum-Welch {tag}: not finite")
        check_calls("L", rec, bw.forward_backward_reference, key=f"L {tag}")
        if rec_a:
            a_rel = check_calls("A", rec_a, maha.mahalanobis_min_scores_reference, tol=A_REL_TOL)
            check(a_rel <= A_REL_TOL, f"kernel A fused differs from plain by {a_rel:.3e}")
            log(f"[36] Baum-Welch {tag}: kernel A fused's last {len(rec_a)} calls within "
                f"{a_rel:.3e} relative of the plain version (limit {A_REL_TOL:g})")
        live = torch.arange(T, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
        sum_err = (gamma.sum(dim=2)[live] - 1.0).abs().max().item()
        a_l, k_l, out_l = rec[0]
        l_ms, l_plain, l_all = in_turns(lambda: bw.forward_backward_reference(*a_l, **k_l),
                                        lambda: bw.forward_backward(*a_l, **k_l), 1, 5)
        word = 8 if dt == torch.float64 else 4
        ty = "d" if dt == torch.float64 else "f"
        l_bnd = fb_bound(len(ids), T, A, word, int(np.asarray(lens).sum()))
        res[f"L {tag}"] = (l_ms, l_plain, l_bnd)
        # kernel L's first design (the block instance, forced) beside the
        # wide chains: bit-equal on the recorded call, in turns
        same_lf, errs[f"L {tag} first"] = bit_equal(
            flat(bw.forward_backward_cuda(*a_l, **k_l, first_design=True)[:2]), flat(out_l))
        check(same_lf, f"kernel L's first design ({tag}) is not bit-equal to the wide chains")
        lw_ms, lf_ms, lf_all = in_turns(
            lambda: bw.forward_backward_cuda(*a_l, **k_l, first_design=True),
            lambda: bw.forward_backward(*a_l, **k_l), 5, 5)
        res[f"L {tag} first"] = (lf_ms, l_plain, l_bnd)
        log(f"[36] Baum-Welch {tag}, {len(ids)} utterances (T {T}, A {A}, "
            f"{instance('sr_forward_backward_instance', A)}): "
            f"{wall[f'Baum-Welch {tag}']:.4f} s; launches {c}; kernel L bit-equal to its plain "
            f"version (gamma, log_z), posteriors sum to 1 within {sum_err:.3e}; L {l_ms:.4f} ms, "
            f"plain {l_plain:.4f} ms (plain, kernel, kernel, plain: "
            f"{', '.join(f'{v:.4f}' for v in l_all)}); bound {l_bnd[0]:.4f} ms ({l_bnd[1]}), "
            f"{l_ms / l_bnd[0]:.1f}x it; {l_ms / int(np.asarray(lens).max()) * 1e3:.3f} us a "
            f"frame of the longest utterance on {card}")
        longest = int(np.asarray(lens).max())
        log(f"[36] kernel L {tag}: the first design (the block instance, its rows in shared "
            f"memory, forced) against the wide chains, in turns (first, chains, chains, first: "
            f"{', '.join(f'{v:.4f}' for v in lf_all)} ms): first design {lf_ms:.4f} ms "
            f"({lf_ms / longest * 1e3:.3f} us a frame, {lf_ms / l_bnd[0]:.1f}x the bound) -> "
            f"wide chains {lw_ms:.4f} ms ({lw_ms / longest * 1e3:.3f} us a frame, "
            f"{lw_ms / l_bnd[0]:.1f}x); bit-equal {same_lf}; wide chains "
            f"{ptxas_usage(f'fb_wide_chain_kernelI{ty}Li{_native.load().sr_forward_backward_instance(A)}E')}, "
            f"posterior pass {ptxas_usage(f'fb_posterior_kernelI{ty}Li{-(-A // 32)}E')} on {card}")
        del gamma, log_z, rec, rec_a
    # kernel F on the df32 alignment's NaN rows (Queue 3 #21), kernels E (both
    # types) and A fused, timed on their recorded calls
    a_n, k_n, out_n = runs["df32"]["rec"]["F"][0]
    n_ms, n_plain, _all = in_turns(lambda: vit.align_fwd_chunk_df_reference(*a_n, **k_n),
                                   lambda: vit.align_fwd_chunk_df(*a_n, **k_n), 1, 10)
    same_nf, _e = bit_equal(flat(f_first(vit, *a_n, **k_n)), flat(out_n))
    check(same_nf, "kernel F's first design is not bit-equal to the wide instance on NaN rows")
    nw_ms, nf_ms, nf_all = in_turns(lambda: f_first(vit, *a_n, **k_n),
                                    lambda: vit.align_fwd_chunk_df(*a_n, **k_n), 10, 10)
    C_n = a_n[1].hi.shape[1]
    log(f"[36] kernel F on the df32 alignment's last chunk (B={B_f}, C={C_n}, A={A_f}, "
        f"t0={a_n[6]}; every row holds NaN costs, folded as the plain version does): kernel "
        f"{n_ms:.4f} ms, plain {n_plain:.4f} ms; {n_ms / C_n * 1e3:.3f} us a frame against the "
        f"trainer's {res['F'][0] / C_f * 1e3:.3f}; the first design, forced, in turns (first, "
        f"wide, wide, first: {', '.join(f'{v:.4f}' for v in nf_all)} ms): {nf_ms:.4f} ms "
        f"({nf_ms / C_n * 1e3:.3f} us a frame) -> {nw_ms:.4f} ms ({nw_ms / C_n * 1e3:.3f} us a "
        f"frame), bit-equal {same_nf} on {card}")
    for tag, dt in (("f32 pallas", torch.float32), ("f64 mxu", torch.float64)):
        # kernel E's wide instance, its first design (the block instance,
        # forced) and the plain version, in turns on the recorded call
        a_e, k_e, _ = runs[tag]["rec"]["E"][0]
        ref_e = flat(vit.align_fwd_chunk_reference(*a_e, **k_e))
        same_ef, errs[f"E {tag} first"] = bit_equal(flat(e_first(vit, *a_e, **k_e)), ref_e)
        check(same_ef, f"kernel E's first design ({tag}) is not bit-equal to its plain version")
        e_ms, ef_ms, e_plain, e_all = designs_in_turns(
            lambda: vit.align_fwd_chunk_reference(*a_e, **k_e),
            lambda: vit.align_fwd_chunk(*a_e, **k_e), lambda: e_first(vit, *a_e, **k_e), 1, 10)
        B_e, C_e, A_e = a_e[1].shape
        e_bnd = align_bound(B_e, C_e, A_e, 4 if dt == torch.float32 else 8)
        res[f"E {tag}"] = (e_ms, e_plain, e_bnd)
        res[f"E {tag} first"] = (ef_ms, e_plain, e_bnd)
        ty = "f" if dt == torch.float32 else "d"
        k_wide = _native.load().sr_align_fwd_positions(A_e)
        log(f"[36] kernel E {dt} at B={B_e} C={C_e} A={A_e} "
            f"({instance('sr_align_fwd_warps', A_e)}), the recorded call in turns (plain, wide, "
            f"first, first, wide, plain: {', '.join(f'{v:.4f}' for v in e_all)} ms): wide "
            f"instance {e_ms:.4f} ms ({e_ms / C_e * 1e3:.3f} us a frame, {e_ms / e_bnd[0]:.1f}x "
            f"the bound), first design (the block instance, its row in shared memory, forced) "
            f"{ef_ms:.4f} ms ({ef_ms / C_e * 1e3:.3f} us a frame, {ef_ms / e_bnd[0]:.1f}x), plain "
            f"{e_plain:.4f} ms; bound {e_bnd[0]:.4f} ms ({e_bnd[1]}); both designs bit-equal to "
            f"the plain version (first design {same_ef}); wide instance "
            f"{ptxas_usage(f'align_fwd_wide_kernelI{ty}Li{k_wide}E')}, first design "
            f"{ptxas_usage(f'align_fwd_block_kernelI{ty}E')} on {card}")
    a_a, k_a, _ = runs["f32 pallas"]["rec"]["A"][0]      # a whole AM_CHUNK of frames
    m_ms, m_plain, _all = in_turns(lambda: maha.mahalanobis_min_scores_reference(*a_a, **k_a),
                                   lambda: maha.mahalanobis_min_scores(*a_a, **k_a), 1, 10)
    n_a, j_a, D_a = a_a[0].shape[0], a_a[1].shape[0], a_a[4]
    S_a = j_a // D_a
    m_bnd = bound(4 * (n_a * dim + 2 * j_a * dim + j_a + n_a * S_a),
                  fp32=n_a * j_a * (A_ELEMENT_OPS * dim + 1) + n_a * S_a * (D_a - 1))
    res["A"] = (m_ms, m_plain, m_bnd)
    log(f"[36] kernel A fused at N={n_a} S={S_a} D={D_a} dim={dim}: kernel {m_ms:.4f} ms, plain "
        f"{m_plain:.4f} ms; bound {m_bnd[0]:.4f} ms ({m_bnd[1]}), {m_ms / m_bnd[0]:.1f}x it on "
        f"{card}")

    device_s = sum(v for k, v in wall.items() if k.startswith(("train", "align", "Baum")))
    log(f"[36] wall seconds by step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in wall.items())
        + f"; host-only steps {sum(wall.values()) - device_s:.4f} s of {sum(wall.values()):.4f}")
    # the host share of the device steps: one profiled run each of the
    # trainer's realignment path (the df32 alignment) and the Baum-Welch pass,
    # in a fresh process (late in this script the profiler records fewer
    # launches than were made)
    inputs = root / "profile_inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((model, feats, lens, tables, pruning), f)
    child = subprocess.run([sys.executable, "-c", SPRINT_PROFILE_CHILD, str(REPO), str(inputs),
                            str(PROFILE_PAD_S), str(PROFILE_TRIES)], cwd=REPO,
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"the profiled Sprint runs failed:\n{child.stderr[-2000:]}")
    for tag, p in json.loads(child.stdout.strip().splitlines()[-1]).items():
        check(p["seen"] == p["launched"] and all(p["launched"].values()),
              f"{tag}: the profiler saw {p['seen']} of the launches {p['launched']} in each of "
              f"{p['tries']} windows")
        busy = sum(us for _key, _n, us in p["events"]) / 1e6
        log(f"[36] {tag} profiled (a fresh process, window {p['tries']}; every launch recorded: "
            f"{p['launched']}): {p['seconds']:.4f} s, device busy {busy:.4f} s, host share "
            f"{1 - busy / p['seconds']:.4f}")
        for key, n, us in sorted(p["events"], key=lambda e: -e[2])[:5]:
            log(f"[36]   {us / 1e3:10.3f} ms  {n:6d}x  {key[:90]}")
    log(f"[36] phase seconds {time.perf_counter() - t_phase:.1f}")

    launches = {"A": c32["A"] + bw_counts["f32 pallas"]["A"], "C": train_counts["C"] + cdf["C"],
                "E f32 pallas": c32["E"], "E f64 mxu": c64["E"], "F": train_counts["F"] + cdf["F"],
                "G": train_counts["G"] + c32["G"] + c64["G"] + cdf["G"], "H": train_counts["H"],
                "L f32 pallas": bw_counts["f32 pallas"]["L"], "L f64 mxu": bw_counts["f64 mxu"]["L"],
                # the first designs, forced beside the new ones: no main path launches them
                "E f32 pallas first": 0, "E f64 mxu first": 0, "F first": 0,
                "L f32 pallas first": 0, "L f64 mxu first": 0}
    log(f"[36] launches on the Sprint path: {launches}")
    rep = "speechrecognition_tpu/align/viterbi.py"
    return [entry(name, source, replaces, launches[key], errs[key], *res[key])
            for name, source, replaces, key in (
        ("mahalanobis_min_scores[sprint]", "mahalanobis.cu",
         "speechrecognition_tpu/ops/mahalanobis.py:90 + speechrecognition_tpu/models/gmm.py:538",
         "A"),
        ("am_scores_df[sprint]", "am_scores_df.cu", "speechrecognition_tpu/models/gmm.py:568", "C"),
        ("align_fwd[sprint]", "align_scan.cu", f"{rep}:315", "E f32 pallas"),
        ("align_fwd[f64, sprint]", "align_scan.cu", f"{rep}:315", "E f64 mxu"),
        ("align_fwd[sprint, first design]", "align_scan.cu", f"{rep}:315", "E f32 pallas first"),
        ("align_fwd[f64, sprint, first design]", "align_scan.cu", f"{rep}:315",
         "E f64 mxu first"),
        ("align_fwd_df[sprint]", "align_scan_df.cu", f"{rep}:368", "F"),
        ("align_fwd_df[sprint, first design]", "align_scan_df.cu", f"{rep}:368", "F first"),
        ("align_backtrack[sprint]", "align_backtrack.cu", f"{rep}:582", "G"),
        ("em_pass_df[sprint]", "em_pass_df.cu", "speechrecognition_tpu/models/gmm.py:997", "H"),
        ("forward_backward[sprint]", "forward_backward.cu",
         "speechrecognition_tpu/align/baumwelch.py:44", "L f32 pallas"),
        ("forward_backward[f64, sprint]", "forward_backward.cu",
         "speechrecognition_tpu/align/baumwelch.py:44", "L f64 mxu"),
        ("forward_backward[sprint, first design]", "forward_backward.cu",
         "speechrecognition_tpu/align/baumwelch.py:44", "L f32 pallas first"),
        ("forward_backward[f64, sprint, first design]", "forward_backward.cu",
         "speechrecognition_tpu/align/baumwelch.py:44", "L f64 mxu first"))]


#: kernel P per slot and frame: P1's three within-word adds, two compares,
#: the emission and entry adds (three), the entry compare, the cap, the key
#: and its minimum (12); P2's guard, subtract and prune (3); per local
#: context and word the end's guard, add and compare (3); per rank and word
#: the recombination's compare
P_SLOT_OPS = 12 + 3
P_WORD_OPS = 3
#: utterances of the two-rank run on one card (phase 37)
RANKS_BATCH = 128
#: ms a frame's two collectives are timed over (phase 37), calls
COLLECTIVE_REPS = 200


def p_bound(B, S, nl, N, W, R, word):
    """Kernel P's bound for one frame (its two launches): the carry read and
    written, the frame's emission row, the book read and written, the ranks'
    gathered candidates read, the frame's outputs and the send buffer
    written; its operations a slot, a context's word ends and a rank's
    recombination."""
    nbytes = (2 * B * nl * N * (word + 4) + B * S * word + 2 * B * W * word
              + R * B * W * (word + 8) + 2 * B * W * (word + 8))
    ops = B * (nl * N * P_SLOT_OPS + nl * W * P_WORD_OPS + R * W)
    return bound(nbytes, **({"fp32": ops} if word == 4 else {"fp64": ops}))


def p_compare(got, ref):
    """(equal, largest difference) of two ShardStates' written tensors."""
    err = 0.0
    for k in got.WRITTEN:
        a, b = getattr(got, k), getattr(ref, k)
        pairs = (zip(got.candidates(a), ref.candidates(b)) if k in ("send", "gathered")
                 else ((a, b),))
        for x, y in pairs:
            if x.is_floating_point():
                fin = (x < 1e29) & (y < 1e29)
                if bool(fin.any()):
                    err = max(err, (x[fin].double() - y[fin].double()).abs().max().item())
    return got.written_equal(ref), err


#: chunks of frames the sharded WCTS's graph route is timed with (phase 37)
P_CHUNKS = (4, 8, 16, 32)


def p_phase_type(dev, card, mesh, name, dt, pack, feats, feats_np, lens, lens_np, tree0, tdp,
                 lm, lm_start, T):
    """Phase 37's sharded WCTS in one type at world 1 over NCCL: the eager
    route with kernel P held against its plain version on its own launches,
    the main path (wcts_sharded: its frames replayed from CUDA graphs) equal
    to it and to kernel K's decode, both routes timed against K's warm
    scan, the chunk swept (float32), and a frame's two launches of the
    owner instance and the forced first design timed in turns with the
    plain version. Returns kernel P's two JSON entries."""
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.parallel import mesh as pm
    from speechrecognition_torch.parallel import wcts_step as ws
    from speechrecognition_torch.search import wcts as wc

    nb = feats.shape[0]
    N, W = tree0.num_nodes, tree0.num_words
    nl = W + 1
    word = 4 if dt == torch.float32 else 8
    transport = mesh.transports["model"]
    am = gmm.am_scores(pack, feats.reshape(-1, 25)).reshape(nb, T, -1).to(dt).contiguous()
    S = am.shape[2]
    kargs = wc.WctsTables.build(tree0, tdp, lm, lm_start).args(dev, dt, S)
    for _ in range(2):                  # the second call is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _c, kouts = wc.wcts_scan(am, lens, *kargs, 200.0)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t0
    kouts = [o.cpu().numpy() for o in kouts[:3]]

    # the eager route, kernel P held against its plain version on its own
    # launches at a few frames
    frames = {1, 2, 3, T // 2, T, T + 1}
    checks, mids = [], {}
    run_e, run_n = ws.shard_entries, ws.shard_ends

    def entries_checked(s, t, recombine, step=True, stream=None):
        if t not in frames:
            return run_e(s, t, recombine, step, stream)
        if t == T // 2:
            mids["state"] = s.clone()
        ref = s.clone()
        ws.shard_entries_reference(ref, t, recombine, step)
        run_e(s, t, recombine, step, stream)
        checks.append(("P1", t, *p_compare(s, ref)))

    def ends_checked(s, t, stream=None):
        if t not in frames:
            return run_n(s, t, stream)
        ref = s.clone()
        ws.shard_ends_reference(ref, t)
        run_n(s, t, stream)
        checks.append(("P2", t, *p_compare(s, ref)))

    def eager_route():
        st = pm.shard_state(am, lens_np, tree0, tdp, lm, lm_start, 200.0, 0, 1)
        pm.run_frames_eager(st, transport)
        return [o.cpu().numpy() for o in (st.out_book, st.out_bkp, st.out_pred)]

    def graph_route():
        return pm.wcts_sharded(mesh, None, feats_np, lens_np, tree0, tdp, lm, lm_start, 200.0,
                               dtype=dt, am=am)

    ws.LAUNCHES = 0
    with mock.patch.object(ws, "shard_entries", entries_checked), \
            mock.patch.object(ws, "shard_ends", ends_checked):
        eager = eager_route()
    eager_launches = ws.LAUNCHES
    check(eager_launches == 2 * T + 1,
          f"kernel P launched {eager_launches} times over {T} frames on the eager route")
    bad = [c for c in checks if not c[2]]
    check(not bad and len(checks) == 2 * len(frames) - 1,
          f"kernel P {name} differs from its plain version on the path's launches {bad}")
    err = max(c[3] for c in checks)
    check(all(np.array_equal(g, w) for g, w in zip(eager, kouts)),
          f"wcts_sharded's eager route {name} at world 1 (NCCL) differs from kernel K's decode")

    # the main path: wcts_sharded, its frames replayed from a CUDA graph
    ws.LAUNCHES = 0
    graph = graph_route()
    launches = ws.LAUNCHES
    check(launches == 2 * T + 1, f"kernel P launched {launches} times over {T} frames")
    check(all(np.array_equal(g, w) and np.array_equal(g, e)
              for g, w, e in zip(graph, kouts, eager)),
          f"wcts_sharded {name} at world 1 (NCCL) differs from kernel K's decode or the eager "
          f"route")

    # both routes timed in turns (graph, eager, eager, graph), warm
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    routes = [wall(r) for r in (graph_route, eager_route, eager_route, graph_route) * 2]
    graph_s = float(np.median([v for i, v in enumerate(routes) if i % 4 in (0, 3)]))
    eager_s = float(np.median([v for i, v in enumerate(routes) if i % 4 in (1, 2)]))

    # the frame loop alone on a fresh state (graph, eager, eager, graph),
    # and the outputs' copy to the host that wcts_sharded adds
    def frame_loop(run):
        st = pm.shard_state(am, lens_np, tree0, tdp, lm, lm_start, 200.0, 0, 1)
        s_loop = wall(lambda: run(st, transport))
        return s_loop, wall(lambda: [o.cpu().numpy() for o in (st.out_book, st.out_bkp,
                                                                 st.out_pred)])

    loops = [frame_loop(r) for r in (pm.run_frames, pm.run_frames_eager, pm.run_frames_eager,
                                      pm.run_frames) * 2]
    loop_graph = float(np.median([v[0] for i, v in enumerate(loops) if i % 4 in (0, 3)]))
    loop_eager = float(np.median([v[0] for i, v in enumerate(loops) if i % 4 in (1, 2)]))
    transport.calls, transport.seconds = 0, 0.0
    eager_route()
    host_coll = transport.seconds / T
    sweep = {}
    if name == "f32":
        for F in P_CHUNKS + P_CHUNKS[::-1]:        # in turns: 4, ..., 32, 32, ..., 4
            with mock.patch.object(pm, "FRAME_CHUNK", F):
                sweep.setdefault(F, []).append(frame_loop(pm.run_frames)[0])
    s2 = pm.shard_state(am, lens_np, tree0, tdp, lm, lm_start, 200.0, 0, 1)
    coll_ms = cuda_ms(lambda: (transport.all_reduce(s2.floor_key, "min"),
                               transport.all_gather(s2.gathered, s2.send)), COLLECTIVE_REPS)

    # a frame's two launches, owner instance and first design, against the
    # plain version in turns on the path's middle-frame state; the first
    # design held against the plain version there
    tm = T // 2
    mk, mf, mp = mids["state"], mids["state"].clone(), mids["state"].clone()
    ref = mids["state"].clone()
    first = mids["state"].clone()
    err_f = 0.0
    for fn_k, fn_r in ((lambda s: ws.shard_entries_cuda(s, tm, True, True, first_design=True),
                        lambda s: ws.shard_entries_reference(s, tm, True, True)),
                       (lambda s: ws.shard_ends_cuda(s, tm),
                        lambda s: ws.shard_ends_reference(s, tm))):
        fn_k(first)
        fn_r(ref)
        same_f, e = p_compare(first, ref)
        check(same_f, f"kernel P's first design {name} differs from its plain version at "
                      f"frame {tm}")
        err_f = max(err_f, e)
    lib = _native.load()
    check(ws.launcher(mk).instance == 1 and lib.sr_wcts_shard_instance(nl, N, W, word == 8) == 1,
          f"kernel P {name} at {nl} x {N} takes the owner instance")
    # the kernels' pairs replayed from a CUDA graph of 50 pairs (no host
    # work between launches), in turns with the plain version by events
    def plain_pair():
        ws.shard_entries_reference(mp, tm, True, True)
        ws.shard_ends_reference(mp, tm)

    def owner_pair():
        ws.shard_entries_cuda(mk, tm, True, True)
        ws.shard_ends_cuda(mk, tm)

    def first_pair():
        ws.shard_entries_cuda(mf, tm, True, True, first_design=True)
        ws.shard_ends_cuda(mf, tm)

    all_ = [cuda_ms(plain_pair, 2), graph_ms(owner_pair, 50), graph_ms(first_pair, 50),
            graph_ms(first_pair, 50), graph_ms(owner_pair, 50), cuda_ms(plain_pair, 2)]
    ms, first_ms, plain_ms = ((all_[1] + all_[4]) / 2, (all_[2] + all_[3]) / 2,
                              (all_[0] + all_[5]) / 2)
    ev_ms = cuda_ms(owner_pair, 50)
    # the host's share of a bound launch: 200 launches made back to back
    # (the device runs behind), by the host clock
    bound_l, stream = ws.launcher(mk), ws.current_stream(mk)
    host_us = []
    for launch in (lambda: bound_l.entries(tm, True, True, stream),
                   lambda: bound_l.ends(tm, stream)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            launch()
        host_us.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    p1_ev = cuda_ms(lambda: ws.shard_entries_cuda(mk, tm, True, True), 50)
    p2_ev = cuda_ms(lambda: ws.shard_ends_cuda(mk, tm), 50)
    # device times by the profiler, after every timing by events or the
    # host clock
    p1_ms = device_ms(lambda: ws.shard_entries_cuda(mk, tm, True, True), 50,
                      "shard_owner_kernel")
    p1f_ms = device_ms(lambda: ws.shard_entries_cuda(mf, tm, True, True, first_design=True), 50,
                       "shard_block_kernel")
    p2_ms = device_ms(lambda: ws.shard_ends_cuda(mk, tm), 50, "shard_ends_kernel")
    with torch.profiler.profile(activities=PROFILED) as prof:
        prof_s = wall(graph_route)
    log_profile(f"[37] wcts_sharded {name}, graph route (chunks of {pm.FRAME_CHUNK}):", prof,
                prof_s)
    bnd = p_bound(nb, S, nl, N, W, 1, word)
    res = [lib.sr_wcts_shard_residency(nl, N, W, word == 8, f) for f in (0, 1)]
    log(f"[37] kernel P {name} at world 1 (NCCL), B={nb} T={T} {nl} contexts x {N} nodes: "
        f"the eager route {eager_launches} launches, held against its plain version on "
        f"{len(checks)} of its launches (frames {sorted(frames)}): equal, max abs {err:.3e}; "
        f"the main path (graph route, chunks of {pm.FRAME_CHUNK}) {launches} launches; both "
        f"routes' books, bkps, preds equal kernel K's; the first design equal to the plain "
        f"version at frame {tm}")
    log(f"[37] kernel P {name}: a frame's two launches (replayed from a graph of 50 pairs, "
        f"in turns with the plain version by events: plain, owner, first, first, owner, plain: "
        f"{', '.join(f'{v:.4f}' for v in all_)}): owner instance {ms:.4f} ms, first design "
        f"{first_ms:.4f} ms, plain {plain_ms:.4f} ms; the owner pair by events around its "
        f"wrappers {ev_ms:.4f} ms; device time "
        f"P1 owner {p1_ms:.4f} ms, P1 first design {p1f_ms:.4f} ms, P2 {p2_ms:.4f} ms "
        f"(events around the wrapper: P1 {p1_ev:.4f}, P2 {p2_ev:.4f}; host time a bound "
        f"launch P1 {host_us[0]:.2f} us, P2 {host_us[1]:.2f} us); bound {bnd[0]:.4f} ms "
        f"({bnd[1]}), owner {ms / bnd[0]:.2f}x it, first design {first_ms / bnd[0]:.2f}x; "
        f"blocks an SM: owner {res[0]}, first design {res[1]}; registers: owner "
        f"{ptxas_usage('shard_owner_kernel')}; first design {ptxas_usage('shard_block_kernel')}"
        f"; P2 {ptxas_usage('shard_ends_kernel')} on {card}")
    log(f"[37] wcts_sharded {name} (in turns, graph, eager, eager, graph, twice: "
        f"{', '.join(f'{v:.4f}' for v in routes)} s): median graph route {graph_s:.4f} s "
        f"({graph_s / T * 1e3:.4f} ms a frame), eager route {eager_s:.4f} s "
        f"({eager_s / T * 1e3:.4f} ms a frame), against kernel K's scan {k_s:.4f} s; the "
        f"frame loop alone (graph, eager, eager, graph, twice: "
        f"{', '.join(f'{v[0]:.4f}' for v in loops)} s) median graph route "
        f"{loop_graph:.4f} s ({loop_graph / T * 1e3:.4f} ms a frame), eager route "
        f"{loop_eager:.4f} s ({loop_eager / T * 1e3:.4f} ms a frame); the outputs' copy to "
        f"the host {', '.join(f'{v[1]:.4f}' for v in loops)} s; "
        f"collectives a frame {coll_ms:.4f} ms by events (all-reduce MIN + all-gather), "
        f"{host_coll * 1e3:.4f} ms of host time on the eager route"
        + (f"; the graph route's frame loop by chunk, in turns: " + ", ".join(
            f"{F} frames {', '.join(f'{x:.4f}' for x in v)} s" for F, v in sweep.items())
           if sweep else "")
        + f" on {card}")
    suffix = "" if name == "f32" else "f64"
    return [entry(f"wcts_shard_step{f'[{suffix}]' if suffix else ''}", "wcts_shard_step.cu",
                  "speechrecognition_tpu/parallel/mesh.py:290", launches, err, ms, plain_ms, bnd),
            entry(f"wcts_shard_step[{suffix + ', ' if suffix else ''}first design]",
                  "wcts_shard_step.cu", "speechrecognition_tpu/parallel/mesh.py:290", 0, err_f,
                  first_ms, plain_ms, bnd)]


def parallel_phase(dev, card, lex, big, bench, tdp):
    """Phase 37: the parallel paths (see the module docstring). Returns
    kernel P's JSON entries."""
    import torch.distributed as dist
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import mahalanobis as maha
    from speechrecognition_torch.parallel import mesh as pm
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.search import tree_decoder as td
    from speechrecognition_torch.search import wcts as wc

    t_phase = time.perf_counter()
    st = tables_module("torch_search_tables")
    tpr = tables_module("torch_parallel_ranks")
    nb = FULL_BATCH
    T = dec.Recognizer(Configuration(SETTINGS), lex, tdp, None)._bucket(big.max_seq_length)
    feats_np, lens_np = big.padded_batch(list(range(nb)), pad_to=T)
    lens_np = np.asarray(lens_np, np.int32)
    feats = torch.as_tensor(feats_np, device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    lm, lm_start = st.demo_bigram_lm()
    tree0 = td.TreeTables.build(lex, tdp, 0.0)
    packs = {"f32": bench.pack(method="pallas", device=dev),
             "f64": bench.pack(dtype=torch.float64, device=dev)}
    dts = {"f32": torch.float32, "f64": torch.float64}
    entries = []
    mesh = pm.make_mesh(1, ("model",), device=dev, transport="nccl",
                        init_method=f"tcp://localhost:{tpr.free_port()}", rank=0, world_size=1)
    data = pm.make_mesh(1, ("data",), device=dev, transport="nccl")
    check(dist.get_backend() == "nccl" and mesh.world_size == 1, "phase 37 runs NCCL at world 1")
    try:
        for name in ("f32", "f64"):
            entries += p_phase_type(dev, card, mesh, name, dts[name], packs[name], feats,
                                    feats_np, lens, lens_np, tree0, tdp, lm, lm_start, T)
            torch.cuda.empty_cache()

        # the data-parallel paths at world 1 (NCCL) against the single card
        tables = dec.DecoderTables.build(lex, tdp, SETTINGS["word-penalty"])
        single = dec.decode_batch_tables(packs["f32"], feats, lens_np, tables, 200.0)
        got = pm.decode_sharded(data, packs["f32"], feats_np, lens_np, tables, 200.0)
        check(all(np.array_equal(g, w.cpu().numpy()) for g, w in zip(got, single)),
              "decode_sharded at world 1 differs from the single-card tables")
        cfg = Configuration(SETTINGS)
        counters = {"A": maha.mahalanobis_min_scores, "B": dec.decode_scan,
                    "C": gmm.am_scores_df, "D": dec.decode_scan_df}
        for kind, pack, dt in (("f32 pallas", packs["f32"], torch.float32),
                               ("df32", bench.pack_df(device=dev), "df32")):
            rec = dec.Recognizer(cfg, lex, tdp, pack, dtype=dt)
            one = rec.recognize_corpus(big, batch_size=nb)
            for fn in counters.values():
                fn.LAUNCHES = 0
            t0 = time.perf_counter()
            res = pm.recognize_corpus_sharded(data, pack, big, rec.tables, 200.0,
                                              lex.silence_idx, batch_size=nb, dtype=dt)
            sec = time.perf_counter() - t0
            n = {k: fn.LAUNCHES for k, fn in counters.items()}
            check(res["hyps"] == one["hyps"] and res["wer"] == one["wer"],
                  f"recognize_corpus_sharded {kind} at world 1 differs from the Recognizer")
            need = ("A", "B") if kind == "f32 pallas" else ("C", "D")
            check(all(n[k] > 0 for k in need), f"the sharded {kind} decode skipped a kernel: {n}")
            log(f"[37] recognize_corpus_sharded {kind} at world 1 (NCCL): {nb} transcripts "
                f"equal the Recognizer's (WER {res['wer']:.4f} %), {sec:.4f} s against "
                f"{one['time']:.4f} s decode; launches {n}")
        pack32 = bench.pack(dtype=torch.float32, device=dev)
        f, sts, m = tpr.accumulate_inputs(big, 32768, bench.num_mixtures)
        acc = pm.accumulate_sharded(data, pack32, f, sts, m, first_pass=False)
        one = gmm.accumulate_chunk(pack32, torch.as_tensor(f, device=dev),
                                   torch.as_tensor(sts, device=dev),
                                   torch.as_tensor(m, device=dev), False)
        check(np.array_equal(acc[0], one[0].cpu().numpy())
              and all(np.allclose(a, o.cpu().numpy(), rtol=1e-12, atol=1e-9)
                      for a, o in zip(acc[1:], one[1:])),
              "accumulate_sharded at world 1 differs from accumulate_chunk")
        log(f"[37] decode_sharded (f32 pallas) and accumulate_sharded ({len(m)} frames) at "
            f"world 1 (NCCL) equal the single card's")
    finally:
        dist.destroy_process_group()

    # two ranks on the one card over the host-staged gloo transport
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = tpr.collect(tpr.start(2, REPO / "build" / "parallel37", "wcts,recognize,decode,accumulate",
                                  device="cuda:0", transport="gloo", model="bench",
                                  utterances=RANKS_BATCH, pad_to=T, batch=RANKS_BATCH), 420)
    ranks_s = time.perf_counter() - t0
    _lex, corpus2, _tdp, _m, f2, l2, lm2, lm2_start = tpr.inputs("bench", RANKS_BATCH, T)
    feats2 = torch.as_tensor(f2, device=dev)
    wt2 = wc.WctsTables.build(td.TreeTables.build(lex, tdp, 0.0), tdp, lm2, lm2_start)
    for name in ("f32", "f64"):
        pack = tpr.wcts_pack(bench, name, dev)
        am = gmm.am_scores(pack, feats2.reshape(-1, 25)).reshape(RANKS_BATCH, T, -1)
        am = am.to(dts[name]).contiguous()
        _c, kouts = wc.wcts_scan(am, torch.as_tensor(l2, device=dev),
                                 *wt2.args(dev, dts[name], am.shape[2]), 200.0)
        for arrays, info in ranks:
            check(all(np.array_equal(arrays[f"wcts_{name}_{k}"], w.cpu().numpy())
                      for k, w in zip(("books", "bkps", "preds"), kouts[:3])),
                  f"rank {info['rank']}'s wcts_sharded {name} differs from kernel K's decode")
        info = ranks[0][1]
        per = info[f"wcts_{name}_collective_seconds"] / T
        log(f"[37] two ranks on one card (host-staged gloo), B={RANKS_BATCH} T={T}: "
            f"wcts_sharded {name} equals kernel K's decode on both ranks; "
            f"{info[f'wcts_{name}_seconds']:.4f} s ({info[f'wcts_{name}_seconds'] / T * 1e3:.3f} "
            f"ms a frame), collectives {per * 1e3:.4f} ms a frame of host time "
            f"({info[f'wcts_{name}_collectives']} calls), P launches "
            f"{info[f'wcts_{name}_launches']} on rank 0 on {card}")
    cfg = Configuration(SETTINGS)
    for kind, pack, dt, key in (("f32 pallas", bench.pack(method="pallas", device=dev),
                                 torch.float32, "f32"),
                                ("df32", bench.pack_df(device=dev), "df32", "df32")):
        one = dec.Recognizer(cfg, lex, tdp, pack, dtype=dt).recognize_corpus(
            corpus2, batch_size=RANKS_BATCH)
        for _arrays, info in ranks:
            check(info[f"recognize_{key}_hyps"] == [one["hyps"][i] for i in range(RANKS_BATCH)],
                  f"rank {info['rank']}'s recognize_corpus_sharded {kind} differs from the "
                  f"single card's transcripts")
    tables = dec.DecoderTables.build(lex, tdp, 80.0)
    single = dec.decode_batch_tables(bench.pack(dtype=torch.float32, device=dev), f2, l2,
                                     tables, 200.0)
    acc_one = gmm.accumulate_chunk(bench.pack(dtype=torch.float32, device=dev),
                                   *(torch.as_tensor(a, device=dev) for a in
                                     tpr.accumulate_inputs(corpus2, 2400, bench.num_mixtures)),
                                   False)
    for arrays, info in ranks:
        check(all(np.array_equal(arrays[f"decode_{k}"], w.cpu().numpy())
                  for k, w in zip(("scores", "words", "bkps"), single)),
              f"rank {info['rank']}'s decode_sharded differs from the single card's")
        check(np.array_equal(arrays["acc_w"], acc_one[0].cpu().numpy())
              and all(np.allclose(arrays[k], o.cpu().numpy(), rtol=1e-12, atol=1e-9)
                      for k, o in (("acc_xs", acc_one[1]), ("acc_x2s", acc_one[2]))),
              f"rank {info['rank']}'s accumulate_sharded differs from accumulate_chunk")
    log(f"[37] two ranks on one card: recognize_corpus_sharded (f32 pallas, df32), "
        f"decode_sharded and accumulate_sharded equal the single card's on both ranks; the run "
        f"{ranks_s:.1f} s with process start-up")
    log(f"[37] phase seconds {time.perf_counter() - t_phase:.1f}")
    return entries


def tools_phase(dev, card, lex, corpus, iter2, tdp):
    """Phase 38: the tools on the card (see the module docstring)."""
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.search import flf
    from speechrecognition_torch.search import lattice
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.tools import partition, sprint_tools

    t_phase = time.perf_counter()
    ft = tables_module("torch_flf_tables")
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    names = ft.demo_segment_names()
    vocab = list(lex.orth)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "vocab.txt").write_text("\n".join(vocab) + "\n")
        arch = flf.LatticeArchive(str(tmp / "segs"), vocab)
        for n in names:
            arch.write(n, lattice.WordLattice(num_frames=1, arcs=[lattice.Arc(0, 1, 0, 0.0)],
                                              silence=0))
        cfg = ft.recognizer_config(tmp / "net.config", golden["config"])
        args = [str(tmp / "segs"), str(tmp / "vocab.txt"), "network", str(cfg)]
        out = {}
        for tag, where in (("card", str(dev)), ("cpu", "cpu")):
            ng.decode_scan_bigram.LAUNCHES = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            check(sprint_tools.lattice_processor(args, out=buf, device=where) == 0,
                  f"lattice-processor network failed on {where}")
            out[tag] = (buf.getvalue().splitlines(), ng.decode_scan_bigram.LAUNCHES,
                        time.perf_counter() - t0)
    card_lines, j_launches, card_s = out["card"]
    cpu_lines = out["cpu"][0]
    check(len(card_lines) == len(cpu_lines) == len(names), "one best path a segment")
    worst = 0.0
    for a, b in zip(card_lines, cpu_lines):
        na, sa, wa = a.split("\t")
        nb_, sb, wb = b.split("\t")
        check((na, wa) == (nb_, wb), f"the card's best path of {na} differs from the CPU port's")
        worst = max(worst, abs(float(sa) - float(sb)))
    hyps = [[vocab.index(w) for w in ln.split("\t")[2].split()] for ln in card_lines]
    check(hyps == [u["hyp"] for u in golden["utts"]], "the network's best paths are not golden")
    check(j_launches == len(names), f"kernel J launched {j_launches} times on {len(names)}")
    log(f"[38] sprint_tools lattice-processor ... network on the card: {len(names)} best paths "
        f"equal the CPU port's (scores within {worst:.1e}) and the golden hyps; kernel J "
        f"{j_launches} launches; {card_s:.3f} s (CPU {out['cpu'][2]:.3f} s) on {card}")

    records = {}
    for tag, where in (("card", dev), ("cpu", "cpu")):
        pack = iter2.pack(dtype=torch.float64, device=where)

        def make(thr, pack=pack):
            return dec.Recognizer(Configuration({**SETTINGS, "am-threshold": thr}), lex, tdp,
                                  pack, dtype=torch.float64)

        records[tag] = partition.wer_vs_threshold(make, corpus, [25.0, 200.0], batch_size=35)
    same = [(r["wer"], r["ser"]) for r in records["card"]] == \
        [(r["wer"], r["ser"]) for r in records["cpu"]]
    check(same, f"wer_vs_threshold on the card differs from the CPU port's: {records}")
    check(abs(records["card"][1]["wer"] - golden["corpus"]["wer"]) < 1e-5,
          f"wer_vs_threshold at threshold 200 is not the golden WER: {records}")
    log(f"[38] wer_vs_threshold on the card (f64, 35 demo utterances): "
        + ", ".join(f"threshold {r['threshold']:g} WER {r['wer']:.6f} % ({r['time']:.4f} s)"
                    for r in records["card"]) + "; equal to the CPU port's")
    log(f"[38] phase seconds {time.perf_counter() - t_phase:.1f}")


def gmm_corpus_phase(dev, card, corpus, iter2):
    """Phase 39: aligned_density_scores_df and em_score_and_accumulate_corpus
    on the card against the CPU port (see the module docstring)."""
    from speechrecognition_torch.io import read_alignment
    from speechrecognition_torch.models import gmm

    t_phase = time.perf_counter()
    align, _w, _m = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    n = min(corpus.features.shape[0], align.shape[0])
    C = 4096
    K = -(-n // C)
    fp = np.zeros((K * C, corpus.dim), np.float32)
    fp[:n] = corpus.features[:n]
    sts = np.zeros(K * C, np.int32)
    sts[:n] = align[:n]
    mask = np.zeros(K * C, np.float32)
    mask[:n] = 1.0
    chunks = (fp.reshape(K, C, -1), sts.reshape(K, C), mask.reshape(K, C))
    res = {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        pdf = iter2.pack_df(device=where)
        sc = gmm.aligned_density_scores_df(pdf, torch.as_tensor(fp[:C], device=where),
                                           torch.as_tensor(sts[:C], device=where))
        res[tag] = (sc, {kind: gmm.em_score_and_accumulate_corpus(
            pack, *(torch.as_tensor(a, device=where) for a in chunks))
            for kind, pack in (("df32", pdf),
                               ("f32", iter2.pack(dtype=torch.float32, device=where)))})
    (sc_c, em_c), (sc_h, em_h) = res["card"], res["cpu"]
    check(torch.equal(sc_c.hi.cpu(), sc_h.hi) and torch.equal(sc_c.lo.cpu(), sc_h.lo),
          "aligned_density_scores_df on the card differs from the CPU port's")
    g, h = [t.cpu() for t in em_c["df32"]], em_h["df32"]
    check(torch.equal(g[1], h[1]) and all(torch.allclose(a, b, rtol=1e-12, atol=1e-9)
                                          for a, b in zip(g[2:], h[2:]))
          and abs(float(g[0]) - float(h[0])) <= 1e-12 * abs(float(h[0])),
          "em_score_and_accumulate_corpus df32 on the card differs from the CPU port's")
    g32, h32 = [t.cpu() for t in em_c["f32"]], em_h["f32"]
    w_diff = int((g32[1] != h32[1]).sum())
    check(abs(float(g32[0]) - float(h32[0])) <= 1e-6 * abs(float(h32[0]))
          and float(g32[1].sum()) == float(h32[1].sum()) == float(mask.sum()),
          "em_score_and_accumulate_corpus f32 on the card differs from the CPU port's")
    log(f"[39] aligned_density_scores_df ({C} frames) bit-equal to the CPU port's; "
        f"em_score_and_accumulate_corpus over {n} demo frames: df32 equal (score "
        f"{float(g[0]):.6f}), f32 score {float(g32[0]):.6f} against {float(h32[0]):.6f}, "
        f"{w_diff} of {g32[1].numel()} counts differ (float32 products); on {card}; phase "
        f"seconds {time.perf_counter() - t_phase:.1f}")


def nan_phase(dev, card):
    """Phase 40: one NaN score (tests/torch_nan_tables.py) through kernels B,
    D, E, I, J, K and M on the card, each instance its shapes select, every
    output and carry against the plain version's on the same card tensors
    (NaN equal to NaN). These launches are no main path's: the phase runs
    after every main path has been counted."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.ops import doublefloat as dfm
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.search import linear_lvcsr as tl
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.search import tree_decoder as td
    from speechrecognition_torch.search import wcts
    from speechrecognition_torch.tdp import TdpModel
    t_phase = time.perf_counter()
    nt = tables_module("torch_nan_tables")
    stt = tables_module("torch_search_tables")
    ltt = tables_module("torch_linear_tables")
    lib = _native.load()
    lens = torch.as_tensor(nt.NAN_LENS, dtype=torch.int32, device=dev)
    cases = []

    def same_all(name, got, ref):
        ok = len(got) == len(ref) and all(nt.same_bits(g, r) for g, r in zip(got, ref))
        nan = any(bool(torch.isnan(g).any()) for g in got if g.is_floating_point())
        cases.append((name, ok, nan))
        check(ok, f"[40] {name}: a kernel output differs from its plain version")

    def chunks(fn, am, args, **kw):
        carry, outs, t0 = None, [], 0
        for n in (15, 25):
            part = (dfm.DF(am.hi[:, t0:t0 + n].contiguous(), am.lo[:, t0:t0 + n].contiguous())
                    if isinstance(am, dfm.DF) else am[:, t0:t0 + n].contiguous())
            carry, out = fn(part, lens, *args, carry_in=carry, t0=t0, **kw)
            outs.append(out)
            t0 += n
        return carry, [torch.cat([o[k] for o in outs]) for k in range(len(outs[0]))]

    for W, P in ((12, 24), (33, 8), (44, 24)):
        tables, S = nt.nan_lexicon_tables(W, P, seed=W + P)
        tab = [torch.as_tensor(a, device=dev) for a in (
            tables.state_table, tables.last_pos, tables.word_len, tables.first_state)]
        for dt in (torch.float32, torch.float64):    # kernel B
            am = torch.as_tensor(nt.nan_scores(tables, S, 1, seed=W * P), dtype=dt, device=dev)
            args = (*tab, torch.as_tensor(tables.tdp_within, device=dev),
                    torch.as_tensor(tables.entry_pen, device=dev), 60.0)
            k = chunks(dec.decode_scan, am, args, prune=True)
            p = chunks(dec.decode_scan_reference, am, args, prune=True)
            same_all(f"B {dt} {W}x{P} ({instance('sr_decode_scan_instance', W, P)})",
                     [*k[0], *k[1]], [*p[0], *p[1]])
        for where, prune in (("last", False), ("inner", True)):    # kernel D
            am = dfm.from_f64(nt.nan_scores(tables, S, P - 1 if where == "last" else 1,
                                            seed=W * P), dev)
            args = (*tab, dfm.from_f64(tables.tdp_within, dev),
                    dfm.from_f64(tables.entry_pen, dev), 60.0)
            k = chunks(dec.decode_scan_df, am, args, prune=prune)
            p = chunks(dec.decode_scan_df_reference, am, args, prune=prune)
            same_all(f"D {W}x{P} NaN in the last word's {where} cell, prune {prune} "
                     f"({instance('sr_decode_scan_df_instance', W, P)})",
                     [*flat(k[0]), *k[1]], [*flat(p[0]), *p[1]])
    for W, P in ((12, 24), (33, 8)):    # kernel J, and its first design
        tables, S = nt.nan_lexicon_tables(W, P, seed=W * 5 + P)
        lm, lm_start = stt.random_lm(W, seed=W + P)
        for dt in (torch.float32, torch.float64):
            am = torch.as_tensor(nt.nan_scores(tables, S, 1, seed=W + P), dtype=dt, device=dev)
            args = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                    for a in (tables.state_table, tables.last_pos, tables.word_len)]
            args += [torch.as_tensor(a, dtype=dt, device=dev)
                     for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]
            ref = ng.decode_scan_bigram_reference(am, lens, *args, 200.0)
            inst = instance('sr_decode_scan_bigram_instance', W, P, int(dt == torch.float64))
            same_all(f"J {dt} {W}x{P} ({inst})", ng.decode_scan_bigram(am, lens, *args, 200.0),
                     ref)
            same_all(f"J {dt} {W}x{P} first design",
                     ng.decode_scan_bigram_cuda(am, lens, *args, 200.0, first_design=True)[0],
                     ref)
    rng = np.random.default_rng(40)
    for A in (70, 303, 1025):    # kernel E: warp, wide and scratch instances
        ams = rng.uniform(0.0, 40.0, size=(4, 40, A))
        ams[0, NAN_E_FRAME, A // 2] = np.nan
        tdp = rng.uniform(0.0, 20.0, size=(4, A, 3))
        valid = torch.arange(A, device=dev)[None, :] < torch.as_tensor(
            [A, A - 2, 3, A], device=dev)[:, None]
        for dt in (torch.float32, torch.float64):
            args = (torch.as_tensor(tdp, dtype=dt, device=dev), valid, lens, 60.0)
            outs = []
            for fn in (vit.align_fwd_chunk, vit.align_fwd_chunk_reference):
                prev, got = torch.full((4, A), 1e30, dtype=dt, device=dev), []
                for t0, n in ((0, NAN_E_FRAME + 1), (NAN_E_FRAME + 1, 40 - NAN_E_FRAME - 1)):
                    prev, j = fn(prev, torch.as_tensor(ams[:, t0:t0 + n], dtype=dt,
                                                       device=dev).contiguous(), *args, t0)
                    got += [prev, j]
                outs.append(got)
            same_all(f"E {dt} A={A} ({instance('sr_align_fwd_warps', A)})", *outs)
    for N in (212, 1025):    # kernel I, and its first design
        tree = stt.random_tree(N, seed=N)
        for dt in (torch.float32, torch.float64):
            am = stt.tree_scores(4, 40, seed=N + 7, dtype=dt, device=dev)
            am[0, nt.NAN_FRAME, int(tree.state[N // 2])] = float("nan")
            args = tree.device_args(dev, dt, am.shape[2])
            ref = td.tree_scan_reference(am, lens, *args, 45.0)
            same_all(f"I {dt} N={N} (instance {lib.sr_tree_scan_instance(N, int(dt == torch.float64))})",
                     td.tree_scan(am, lens, *args, 45.0), ref)
            same_all(f"I {dt} N={N} first design",
                     td.tree_scan_cuda(am, lens, *args, 45.0, first_design=True)[0], ref)
    lex = build_sietill_lexicon()    # kernel K: the owner instance and the block forced
    tdp_k = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    lm, lm_start = stt.random_lm(lex.num_words, seed=11)
    for dt in (torch.float32, torch.float64):
        for opts in ({}, {"transparent_silence": 0, "use_lookahead": True, "state_limit": 40,
                          "emit_ends": True, "emit_stats": True}):
            _t, wt = stt.wcts_inputs(lex, tdp_k, lm, lm_start,
                                     lookahead=opts.get("use_lookahead", False))
            args = wt.args(dev, dt, lex.num_states)
            am = stt.am_scores(4, 40, lex.num_states, seed=11, dtype=dt, device=dev)
            am[0, nt.NAN_FRAME, 40] = float("nan")
            ref = chunks(wcts.wcts_scan_reference, am, (*args, 200.0), **opts)
            for force in (0, 1):
                def kern(*a, **kw):
                    return wcts.wcts_scan_cuda(*a, force=force, **kw)[:2]
                got = chunks(kern, am, (*args, 200.0), **opts)
                same_all(f"K {dt} {sorted(opts) or 'pruned'} "
                         f"{'the block instance forced' if force else 'owner instance'}",
                         [*got[0], *got[1]], [*ref[0], *ref[1]])
    for dt in (torch.float32, torch.float64):    # kernel M, and its first design
        lex_l, tm, lm, lm_start, am, llens, thr = ltt.linear_case("lengths-1-2-3")
        lt = tl.LinearTables.build(tm.decoder_tables(lex_l), lm, lm_start, 0)
        am = np.array(am)
        b = int(np.argmax(llens))
        am[b, int(llens[b]) // 2, int(lt.state_table[1, 0])] = np.nan
        args = (torch.as_tensor(am, device=dev).to(dt).contiguous(),
                torch.as_tensor(llens, device=dev), *lt.args(dev, dt, am.shape[2]))
        ref = tl.decode_scan_linear_reference(*args, thr)
        same_all(f"M {dt}", tl.decode_scan_linear(*args, thr), ref)
        same_all(f"M {dt} first design",
                 tl.decode_scan_linear_cuda(*args, thr, first_design=True)[0], ref)
    torch.cuda.synchronize()
    log(f"[40] one NaN score, kernels against their plain versions (NaN equal to NaN), every "
        f"output bit-equal in {sum(ok for _n, ok, _x in cases)} of {len(cases)} cases; a NaN "
        f"reached the kernel's outputs in {sum(x for _n, _ok, x in cases)} on {card}: "
        + "; ".join(f"{n}{' (NaN out)' if x else ''}" for n, _ok, x in cases))
    log(f"[40] phase seconds {time.perf_counter() - t_phase:.1f}")


def repeat_corpus(corpus, n, corpus_cls):
    """The corpus's utterances repeated in order to ``n`` segments."""
    ids = [i % corpus.num_segments for i in range(n)]
    lengths = [corpus.seq_length(s) for s in ids]
    return corpus_cls(
        features=np.concatenate([corpus.feature_sequence(s) for s in ids]),
        feature_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        orths=[list(corpus.orths[s]) for s in ids], names=[corpus.names[s] for s in ids],
        frame_duration=corpus.frame_duration, dim=corpus.dim)


if __name__ == "__main__":
    main()
