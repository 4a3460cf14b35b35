"""The port's streaming recognizers (speechrecognition_torch/search/
online.py) against its offline decoders and the JAX package's online
recognizers.

``OnlineRecognizer`` (f32 "pallas", f64 and df32; feeds of 37 and 160
frames, partial() mid-stream) finishes with the transcripts of the offline
``decode_batch`` / ``decode_batch_df`` of the same frames, and of JAX's
OnlineRecognizer fed the same way; ``partial()`` before any feed gives empty
transcripts, and ``restart()`` resets. ``OnlineWctsRecognizer`` (chunk 64,
feeds of 45, lookahead, both silence modes) finishes with the offline
``decode_batch_wcts`` transcripts and JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.io import read_mixture_set as jread
from speechrecognition_tpu.lexicon import build_sietill_lexicon as jbuild_lexicon
from speechrecognition_tpu.models import gmm as jgmm
from speechrecognition_tpu.search import decoder as jdec
from speechrecognition_tpu.search import online as jonline
from speechrecognition_tpu.search import tree_decoder as jtree
from speechrecognition_tpu.search import wcts as jw
from speechrecognition_tpu.tdp import TdpModel as JTdp

from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import online as tonline
from speechrecognition_torch.search import tree_decoder as ttree
from speechrecognition_torch.search import wcts as tw
from torch_search_tables import FIXTURES, demo_bigram_lm, demo_setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def demo():
    lex, corpus, tdp, model = demo_setup()
    feats, lens = corpus.padded_batch(list(range(corpus.num_segments)))
    jl = jbuild_lexicon()
    jt = JTdp(silence_state=jl.silence_state, loop=3.0, forward=0.0, skip=30.0)
    jmodel = jgmm.MixtureModel.from_raw(jread(str(FIXTURES / "iter-2.mix"), 25),
                                        jgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    return lex, tdp, model, feats, np.asarray(lens), jl, jt, jmodel


def stream(rec, feats, lens, feed):
    for start in range(0, feats.shape[1], feed):
        rec.feed(feats[:, start:start + feed])
        if start == feed:
            rec.partial(lens)       # must not disturb the stream
    return rec.finish(lens)


KINDS = {"f32": (torch.float32, "pallas", jnp.float32),
         "f64": (torch.float64, "mxu", jnp.float64),
         "df32": ("df32", None, "df32")}


@pytest.mark.parametrize("feed", [37, 160])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_online_recognizer_equals_offline_and_jax(demo, kind, feed):
    lex, tdp, model, feats, lens, jl, jt, jmodel = demo
    n = 12 if kind == "df32" else 35
    feats, lens = feats[:n], lens[:n]
    dtype, method, jdtype = KINDS[kind]
    tables = tdec.DecoderTables.build(lex, tdp, 80.0)
    if kind == "df32":
        pack = model.pack_df(device="cpu")
        offline = tdec.decode_batch_df(pack, feats, lens, tables, 200.0, lex.silence_idx)
    else:
        pack = model.pack(dtype=dtype, device="cpu", method=method)
        offline = tdec.decode_batch(pack, feats, lens, tables, 200.0, lex.silence_idx,
                                    dtype=dtype)
    rec = tonline.OnlineRecognizer(pack, tables, 200.0, lex.silence_idx, dtype=dtype,
                                   num_streams=n)
    got = stream(rec, feats, lens, feed)
    assert got == offline
    stats = rec.latency_stats
    assert stats["commit"]["n"] == feats.shape[1] // tdec.DECODE_CHUNK
    assert stats["partial"]["n"] == 2
    if kind == "df32" or feed == 37:
        return      # JAX's online recognizer once per precision (its df32 scorer is slow)
    jtables = jdec.DecoderTables.build(jl, jt, 80.0)
    jpack = jmodel.pack(dtype=jdtype, method=method)
    jrec = jonline.OnlineRecognizer(jpack, jtables, 200.0, jl.silence_idx, dtype=jdtype,
                                    num_streams=n)
    assert stream(jrec, feats, lens, feed) == got


def test_partial_before_any_feed_and_restart(demo):
    lex, tdp, model, feats, lens, *_ = demo
    tables = tdec.DecoderTables.build(lex, tdp, 80.0)
    pack = model.pack(dtype=torch.float64, device="cpu")
    rec = tonline.OnlineRecognizer(pack, tables, 200.0, lex.silence_idx, dtype=torch.float64,
                                   num_streams=3)
    assert rec.partial() == [[], [], []] and rec.finish() == [[], [], []]
    rec.feed(feats[:3, :100])
    first = rec.finish(lens[:3])
    rec.restart()
    assert rec.partial() == [[], [], []]
    rec.feed(feats[:3, :100])
    assert rec.finish(lens[:3]) == first
    wt = tonline.OnlineWctsRecognizer(pack, ttree.TreeTables.build(lex, tdp, 0.0), tdp,
                                      *demo_bigram_lm(), 200.0, lex.silence_idx,
                                      dtype=torch.float64, num_streams=2)
    assert wt.partial() == [[], []]
    wt.feed(feats[:2, :70])
    first = wt.finish(lens[:2])
    wt.restart()
    assert wt.partial() == [[], []]
    wt.feed(feats[:2, :70])
    assert wt.finish(lens[:2]) == first


@pytest.mark.parametrize("transparent", [False, True])
def test_online_wcts_equals_offline_and_jax(demo, transparent):
    lex, tdp, model, feats, lens, jl, jt, jmodel = demo
    n = 12
    feats, lens = feats[:n], lens[:n]
    lm, lm_start = demo_bigram_lm()
    if transparent:
        lm = lm.copy()
        lm[:, lex.silence_idx] = 0.0
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    la = tw.LookaheadTables.build(tables)
    pack = model.pack(dtype=torch.float64, device="cpu")
    offline = tw.decode_batch_wcts(pack, feats, lens, tables, tdp, lm, lm_start, 200.0,
                                   lex.silence_idx, lookahead=la, dtype=torch.float64,
                                   transparent_silence=transparent)
    rec = tonline.OnlineWctsRecognizer(pack, tables, tdp, lm, lm_start, 200.0,
                                       lex.silence_idx, lookahead=la,
                                       transparent_silence=transparent, dtype=torch.float64,
                                       num_streams=n, chunk=64)
    got = stream(rec, feats, lens, 45)
    assert got == offline
    assert rec.latency_stats["commit"]["n"] == feats.shape[1] // 64
    jtables = jtree.TreeTables.build(jl, jt, 0.0)
    jrec = jonline.OnlineWctsRecognizer(
        jmodel.pack(dtype=jnp.float64), jtables, jt, lm, lm_start, 200.0, jl.silence_idx,
        lookahead=jw.LookaheadTables.build(jtables), transparent_silence=transparent,
        dtype=jnp.float64, num_streams=n, chunk=64)
    assert stream(jrec, feats, lens, 45) == got
