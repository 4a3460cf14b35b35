"""The port's parallel paths (speechrecognition_torch/parallel/mesh.py and
kernel P's plain version, parallel/wcts_step.py) against the JAX package's
on the same inputs.

The port's ranks are gloo processes on the CPU (tests/torch_parallel_ranks.py,
spawned on a free port); JAX runs ``shard_map`` on as many CPU devices
(tests/conftest.py gives it 8). On the 12 first demo utterances (279
frames, iter-2.mix, a seeded bigram LM): ``wcts_sharded`` at 2 and 4 ranks
(13 contexts padded to 14 and 16) is bit-equal to JAX's ``wcts_sharded`` on
``make_mesh(n, ("model",))`` and to the port's single-device scan, in
float32 and float64, on every rank; on tie scores (small integers, LM
entries in steps of 5) likewise; with a NaN score it equals the
single-device scans (XLA:CPU's cross-device ``pmin`` drops a NaN floor,
ROADMAP Queue 3), and at one rank the frame step equals JAX's one-device
``wcts_sharded`` with the NaN. Kernel P's plain version over 1-5 virtual
ranks, utterances ending at frames 1, 2 and T, equals JAX's one-device
``wcts_sharded`` and keeps a dead utterance's raw carry and carry_floor; the
frame loop's schedule covers every frame once, in order, and its chunked
route (the CUDA graph's, its chunk played by the plain versions) equals the
eager route. ``decode_sharded`` and
``recognize_corpus_sharded`` (f32 "pallas", df32) give JAX's and the port
Recognizer's transcripts; ``accumulate_sharded`` meets
tests/test_parallel.py's tolerances; ``make_mesh``'s factorisation and
``shard_batch``'s slices equal JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.io import read_mixture_set as jread_mixture_set
from speechrecognition_tpu.lexicon import build_sietill_lexicon as jbuild_lexicon
from speechrecognition_tpu.models import gmm as jgmm
from speechrecognition_tpu.parallel import mesh as jmesh
from speechrecognition_tpu.search import decoder as jdec
from speechrecognition_tpu.search import tree_decoder as jtree
from speechrecognition_tpu.search import wcts as jw
from speechrecognition_tpu.tdp import TdpModel as JTdp

import torch_parallel_ranks as tpr
from speechrecognition_torch.models import gmm
from speechrecognition_torch.parallel import mesh as pm
from speechrecognition_torch.parallel import wcts_step
from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import wcts as tw
from speechrecognition_torch.search.tree_decoder import TreeTables
from torch_search_tables import FIXTURES

torch.set_num_threads(1)
U = 12                      # utterances of the rank runs (279 frames each)
BATCH = 4                   # recognize_corpus_sharded's batch
DT = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}
CASES = "wcts,wcts-ties,wcts-nan,decode,recognize,accumulate,mesh2d"


@pytest.fixture(scope="module")
def setup():
    lex, corpus, tdp, model, feats, lens, lm, lm_start = tpr.inputs("iter2", U)
    jlex = jbuild_lexicon()
    jtdp = JTdp(silence_state=jlex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    jmodel = jgmm.MixtureModel.from_raw(jread_mixture_set(str(FIXTURES / "iter-2.mix"), 25),
                                        jgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    return dict(lex=lex, corpus=corpus, tdp=tdp, model=model, feats=feats, lens=lens, lm=lm,
                lm_start=lm_start, jlex=jlex, jtdp=jtdp, jmodel=jmodel,
                tree=TreeTables.build(lex, tdp, 0.0),
                jtree=jtree.TreeTables.build(jlex, jtdp, 0.0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank results at world 2 (every case) and 4 (the WCTS and mesh cases)."""
    two = tpr.start(2, tmp_path_factory.mktemp("r2"), CASES, utterances=U, batch=BATCH)
    four = tpr.start(4, tmp_path_factory.mktemp("r4"), "wcts,wcts-ties,wcts-nan,mesh2d",
                     utterances=U)
    return {2: tpr.collect(two, timeout=240), 4: tpr.collect(four, timeout=240)}


def single_wcts(s, am, lens, lm, lm_start, dtype):
    """The port's single-device scan (plain kernel K) → (books, bkps, preds)."""
    wt = tw.WctsTables.build(s["tree"], s["tdp"], lm, lm_start)
    _c, outs = tw.wcts_scan(am.to(dtype), torch.as_tensor(lens),
                            *wt.args("cpu", dtype, am.shape[2]), tpr.THRESHOLD)
    return tuple(o.numpy() for o in outs[:3])


def model_am(s, name):
    pack = tpr.wcts_pack(s["model"], name, "cpu")
    B, T, dim = s["feats"].shape
    return gmm.am_scores(pack, torch.as_tensor(s["feats"].reshape(B * T, dim))).reshape(B, T, -1)


def jax_wcts(s, n, jdt, feats, lens, lm, lm_start, monkeypatch=None, am=None):
    if am is not None:
        flat = jnp.asarray(am.reshape(-1, am.shape[-1]))
        monkeypatch.setattr(jgmm, "am_scores", lambda pack, x: flat)
    pack = s["jmodel"].pack(dtype=jdt)
    mesh = jmesh.make_mesh(n, ("model",))
    return jmesh.wcts_sharded(mesh, pack, feats, lens, s["jtree"], s["jtdp"], lm, lm_start,
                              am_threshold=tpr.THRESHOLD, dtype=jdt, axis="model")


def same(a, b):
    return np.array_equal(a, b, equal_nan=np.issubdtype(np.asarray(a).dtype, np.floating))


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("world", [2, 4])
def test_wcts_sharded_equals_jax_and_single(setup, ranks, world, name, monkeypatch):
    """The port's scores of iter-2.mix go to both packages (the two GMM
    products differ in the last bits; tests/test_torch_gmm.py holds them)."""
    s = setup
    tdt, jdt = DT[name]
    am = model_am(s, name).to(tdt)
    want_j = jax_wcts(s, world, jdt, s["feats"], s["lens"], s["lm"], s["lm_start"], monkeypatch,
                      am.to(torch.float64).numpy())
    want_t = single_wcts(s, am, s["lens"], s["lm"], s["lm_start"], tdt)
    T = s["feats"].shape[1]
    for arrays, info in ranks[world]:
        got = [arrays[f"wcts_{name}_{k}"] for k in ("books", "bkps", "preds")]
        for g, j, t in zip(got, want_j, want_t):
            assert g.dtype == np.asarray(j).dtype
            assert np.array_equal(g, np.asarray(j)) and np.array_equal(g, t)
        assert info[f"wcts_{name}_launches"] == 0          # plain versions on the CPU
        assert info[f"wcts_{name}_collectives"] == 2 * T


@pytest.mark.parametrize("name", ["f32", "f64"])
@pytest.mark.parametrize("world", [2, 4])
def test_wcts_sharded_ties(setup, ranks, world, name, monkeypatch):
    """Tie scores: rank order is ascending context order, first index wins."""
    s = setup
    tdt, jdt = DT[name]
    am, lens, lm, lm_start = tpr.tie_inputs(s["lex"], nan=False)
    feats = np.zeros((*am.shape[:2], 25), np.float32)
    want_t = single_wcts(s, torch.as_tensor(am), lens, lm, lm_start, tdt)
    want_j = (jax_wcts(s, world, jdt, feats, lens, lm, lm_start, monkeypatch, am)
              if world == 2 else want_t)
    for arrays, _info in ranks[world]:
        for k, j, t in zip(("books", "bkps", "preds"), want_j, want_t):
            g = arrays[f"wcts-ties_{name}_{k}"]
            assert np.array_equal(g, np.asarray(j)) and np.array_equal(g, t), k
    books = want_t[0]
    ties = int((np.sort(books, axis=2)[:, :, 1:] == np.sort(books, axis=2)[:, :, :-1]).sum())
    assert ties > 0


@pytest.mark.parametrize("world", [2, 4])
def test_wcts_sharded_nan_equals_single_scans(setup, ranks, world):
    """A NaN score: the floor keeps the NaN as the single-device scans do."""
    s = setup
    am, lens, lm, lm_start = tpr.tie_inputs(s["lex"], nan=True)
    for name in ("f32", "f64"):
        tdt, jdt = DT[name]
        want_t = single_wcts(s, torch.as_tensor(am), lens, lm, lm_start, tdt)
        assert np.isnan(want_t[0]).any()
        if world == 2:
            jlm = jw.extend_lm(lm, lm_start)
            es, ep = jw.build_entry_tables(s["jtree"], s["jtdp"])
            jt = s["jtree"]
            _c, outs = jw._wcts_scan(
                jnp.asarray(am).astype(jdt), jnp.asarray(lens), jnp.asarray(jt.state),
                jnp.asarray(jt.parent), jnp.asarray(jt.grand), jnp.asarray(jt.tdp),
                jnp.asarray(jt.loop_allowed), jnp.asarray(es), jnp.asarray(ep),
                jnp.asarray(jt.end_node), jnp.asarray(jlm), jnp.zeros((jlm.shape[0], jt.num_nodes)),
                jnp.asarray(tpr.THRESHOLD, jdt), prune=True, use_lookahead=False)
            for j, t in zip(outs[:3], want_t):
                assert same(np.asarray(j), t)
        for arrays, _info in ranks[world]:
            for k, t in zip(("books", "bkps", "preds"), want_t):
                assert same(arrays[f"wcts-nan_{name}_{k}"], t), (name, k)


@pytest.mark.parametrize("nan", [False, True], ids=["ties", "nan"])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_frame_step_equals_jax_one_device(setup, name, nan, monkeypatch):
    """The plain frame step, frame by frame, at one rank (the local
    transport) against JAX's wcts_sharded on a one-device mesh."""
    s = setup
    tdt, jdt = DT[name]
    am, lens, lm, lm_start = tpr.tie_inputs(s["lex"], nan=nan)
    feats = np.zeros((*am.shape[:2], 25), np.float32)
    want = jax_wcts(s, 1, jdt, feats, lens, lm, lm_start, monkeypatch, am)
    mesh = pm.make_mesh(1, ("model",), device="cpu", transport="local")
    got = pm.wcts_sharded(mesh, None, feats, lens, s["tree"], s["tdp"], lm, lm_start,
                          tpr.THRESHOLD, dtype=tdt, am=torch.as_tensor(am))
    for g, j in zip(got, want):
        for t in range(g.shape[0]):
            assert same(g[t], np.asarray(j)[t]), t
    assert np.isnan(got[0]).any() == nan


def test_order_keys_order_values_with_nan_first():
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.float64):
        v = torch.as_tensor(np.concatenate([rng.normal(0, 1e3, 200), [0.0, -0.0, np.inf,
                                                                       -np.inf, 1e30]]), dtype=dt)
        k = wcts_step.order_key(v)
        order = torch.argsort(k, stable=True)
        assert torch.equal(torch.sort(v).values, v[order])
        back = wcts_step.key_value(k)
        assert torch.equal(back.view(k.dtype), v.view(k.dtype))
        nan = wcts_step.order_key(torch.tensor([float("nan"), -float("nan")], dtype=dt))
        assert (nan < k.min()).all()
        assert torch.isnan(wcts_step.key_value(nan)).all()


@pytest.mark.parametrize("world", [2, 4])
def test_mesh2d_and_axis_groups(ranks, world):
    for arrays, info in ranks[world]:
        jm = jmesh.make_mesh(world, ("data", "model"))
        assert info["mesh2d_shape"] == {"data": jm.devices.shape[0],
                                        "model": jm.devices.shape[1]}
        grid = np.arange(world).reshape(jm.devices.shape)
        d, m = info["mesh2d_coords"]["data"], info["mesh2d_coords"]["model"]
        assert grid[d, m] == info["rank"]
        assert info["mesh2d_data_ranks"] == grid[:, m].tolist()
        assert info["mesh2d_model_ranks"] == grid[d, :].tolist()


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_factorisation_equals_jax(n):
    for axes in (("data",), ("data", "model")):
        want = jmesh.make_mesh(n, axes).devices.shape
        assert pm.mesh_dims(n, axes) == tuple(want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_batch_equals_jax(n):
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    jm = jmesh.make_mesh(n, ("data",))
    shards = jmesh.shard_batch(jm, x).addressable_shards
    by_device = {sh.device: np.asarray(sh.data) for sh in shards}
    for r, dev in enumerate(jm.devices.reshape(-1)):
        mesh = pm.Mesh(("data",), {"data": n}, r, n, torch.device("cpu"), "local", {"data": r},
                       {"data": pm.Transport("local")})
        assert np.array_equal(pm.shard_batch(mesh, x).numpy(), by_device[dev])
    with pytest.raises(ValueError):
        pm.shard_batch(pm.Mesh(("data",), {"data": 3}, 0, 3, torch.device("cpu"), "local",
                               {"data": 0}, {"data": pm.Transport("local")}), x)


def test_decode_sharded_equals_jax_and_single(setup, ranks):
    s = setup
    feats, lens = s["feats"], s["lens"]
    jtables = jdec.DecoderTables.build(s["jlex"], s["jtdp"], word_penalty=80.0)
    scores, words, bkps = jmesh.decode_sharded(jmesh.make_mesh(2, ("data",)),
                                               s["jmodel"].pack(dtype=jnp.float32), feats, lens,
                                               jtables, am_threshold=tpr.THRESHOLD)
    tables = tdec.DecoderTables.build(s["lex"], s["tdp"], 80.0)
    single = tdec.decode_batch_tables(s["model"].pack(dtype=torch.float32, device="cpu"),
                                      feats, lens, tables, tpr.THRESHOLD)
    sil = s["lex"].silence_idx
    want = tdec._traceback_host(np.asarray(words), np.asarray(bkps), lens, sil)
    for arrays, _info in ranks[2]:
        assert np.array_equal(arrays["decode_words"], single[1].numpy())
        assert np.array_equal(arrays["decode_bkps"], single[2].numpy())
        assert np.array_equal(arrays["decode_scores"], single[0].numpy())
        got = tdec._traceback_host(arrays["decode_words"], arrays["decode_bkps"], lens, sil)
        assert got == want


@pytest.mark.parametrize("name", ["f32", "df32"])
def test_recognize_corpus_sharded_equals_recognizer(setup, ranks, demo_recognition, name):
    s = setup
    from speechrecognition_torch.config import Configuration
    from torch_search_tables import DEMO_SETTINGS
    pack = (s["model"].pack(method="pallas", device="cpu") if name == "f32"
            else s["model"].pack_df(device="cpu"))
    rec = tdec.Recognizer(Configuration(DEMO_SETTINGS), s["lex"], s["tdp"], pack,
                          dtype=torch.float32 if name == "f32" else "df32")
    single = rec.recognize_corpus(s["corpus"], batch_size=BATCH)
    golden = [u["hyp"] for u in demo_recognition["utts"][:U]]
    if name == "f32":
        # JAX's sharded decode on two CPU devices, f32
        jrec = jdec.Recognizer(_jconfig(DEMO_SETTINGS), s["jlex"], s["jtdp"],
                               s["jmodel"].pack(dtype=jnp.float32), dtype=jnp.float32)
        jres = jmesh.recognize_corpus_sharded(jmesh.make_mesh(2, ("data",)),
                                              s["jmodel"].pack(dtype=jnp.float32),
                                              _jcorpus(s["corpus"]), jrec.tables, tpr.THRESHOLD,
                                              s["jlex"].silence_idx, batch_size=BATCH)
        assert [jres["hyps"][i] for i in range(U)] == golden
    for _arrays, info in ranks[2]:
        hyps = info[f"recognize_{name}_hyps"]
        assert hyps == [single["hyps"][i] for i in range(U)] == golden
        assert info[f"recognize_{name}"]["wer"] == single["wer"]
        assert info[f"recognize_{name}"]["ser"] == single["ser"]


def _jconfig(settings):
    from speechrecognition_tpu.config import Configuration
    return Configuration(settings)


def _jcorpus(c):
    from speechrecognition_tpu.corpus import Corpus
    return Corpus(features=c.features, feature_offsets=c.feature_offsets, orths=c.orths,
                  names=c.names, frame_duration=c.frame_duration, dim=c.dim)


def test_accumulate_sharded_equals_single(setup, ranks):
    s = setup
    f, st, m = tpr.accumulate_inputs(s["corpus"], 2400, s["model"].num_mixtures)
    jw1, jxs1, jx2s1 = jgmm.accumulate_chunk(s["jmodel"].pack(dtype=jnp.float32),
                                             jnp.asarray(f), jnp.asarray(st), jnp.asarray(m),
                                             False)
    tw1, txs1, tx2s1 = gmm.accumulate_chunk(s["model"].pack(dtype=torch.float32, device="cpu"),
                                            torch.as_tensor(f), torch.as_tensor(st),
                                            torch.as_tensor(m), False)
    for arrays, _info in ranks[2]:
        for got, j, t in ((arrays["acc_w"], jw1, tw1), (arrays["acc_xs"], jxs1, txs1),
                          (arrays["acc_x2s"], jx2s1, tx2s1)):
            tol = dict(rtol=0, atol=0) if got.ndim == 2 else dict(rtol=1e-12, atol=1e-9)
            np.testing.assert_allclose(got, np.asarray(j), **tol)
            np.testing.assert_allclose(got, t.numpy(), **tol)


# -- the new frame-step contract and the frame loop --------------------------------


def _step_virtual(states, T, after_frame):
    """Every frame of ``states`` (virtual ranks on the CPU) through the plain
    versions, the exchange made in-process; ``after_frame(t)`` after each."""
    for t in range(1, T + 1):
        for st in states:
            wcts_step.shard_entries_reference(st, t, t > 1, True)
        k = torch.stack([st.floor_key for st in states]).amin(dim=0)
        for st in states:
            st.floor_key.copy_(k)
            wcts_step.shard_ends_reference(st, t)
        g = torch.stack([st.send for st in states])
        for st in states:
            st.gathered.copy_(g)
        after_frame(t)
    for st in states:
        wcts_step.shard_entries_reference(st, T + 1, True, False)


@pytest.fixture(scope="module")
def dead_inputs(setup):
    """The tie inputs (with and without the NaN) whose utterances end at
    frames 1, 2, T and T − 23, and JAX's one-device wcts_sharded on them in
    both types."""
    am, want = {}, {}
    for nan in (False, True):
        am[nan], _lens, lm, lm_start = tpr.tie_inputs(setup["lex"], nan=nan)
        T = am[nan].shape[1]
        lens = np.asarray([1, 2, T, T - 23], np.int32)
        feats = np.zeros((*am[nan].shape[:2], 25), np.float32)
        for name, (_tdt, jdt) in DT.items():
            with pytest.MonkeyPatch.context() as mp:
                want[nan, name] = tuple(np.asarray(o) for o in jax_wcts(
                    setup, 1, jdt, feats, lens, lm, lm_start, mp, am[nan]))
    return am, lens, lm, lm_start, want


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nan", [False, True], ids=["ties", "nan"])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_dead_utterances_keep_their_carry(setup, dead_inputs, name, nan, ranks):
    """The plain frame step over 1-5 virtual ranks, utterances ending at
    frames 1, 2 and T: books, bkps and preds equal JAX's wcts_sharded on one
    device (NaN equal to NaN), and a dead utterance's raw carry and
    carry_floor stay as its last frame left them."""
    s = setup
    am, lens, lm, lm_start, want = dead_inputs
    tdt = DT[name][0]
    states = tpr.virtual_ranks(torch.as_tensor(am[nan]).to(tdt), lens, s["lex"], s["tdp"], lm,
                               lm_start, ranks)
    T = am[nan].shape[1]
    kept = {}

    def after_frame(t):
        for b in np.flatnonzero(lens == t):
            kept[int(b)] = [(st.hyp[b].clone(), st.bkp[b].clone(), st.carry_floor[b].clone())
                            for st in states]

    _step_virtual(states, T, after_frame)
    assert sorted(kept) == list(range(len(lens)))
    for b, snaps in kept.items():
        for st, (h, bk, fl) in zip(states, snaps):
            assert same(st.hyp[b].numpy(), h.numpy()) and torch.equal(st.bkp[b], bk)
            assert torch.equal(st.carry_floor[b], fl), (b, st.ctx0)
    for st in states:
        for g, j in zip((st.out_book, st.out_bkp, st.out_pred), want[nan, name]):
            for t in range(T):
                assert same(g[t].numpy(), j[t]), (t, st.ctx0)
    assert np.isnan(states[0].out_book.numpy()).any() == nan


@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("offset", [-1, 0, 1], ids=["below", "at", "above"])
@pytest.mark.parametrize("multiple", [1, 3])
def test_frame_schedule_covers_every_frame_once_in_order(chunk, multiple, offset):
    """T − 1 below, at and above a multiple of the chunk: frame 1 alone,
    whole chunks from frame 2, the rest one at a time, each frame once and
    in order."""
    T = multiple * chunk + 1 + offset
    segments = pm.frame_schedule(T, chunk)
    frames = [t for t0, n, _g in segments for t in range(t0, t0 + n)]
    assert frames == list(range(1, T + 1))
    assert segments[0] == (1, 1, False)
    graphed = [(t0, n) for t0, n, g in segments if g]
    assert all(n == chunk for _t0, n in graphed)
    assert len(graphed) == (T - 1) // chunk
    assert all(n == 1 for _t0, n, g in segments if not g)
    assert [t0 for t0, _n, g in pm.frame_schedule(T, 0)] == list(range(1, T + 1))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunked_route_equals_eager_route(setup, monkeypatch, chunk):
    """The graph route's loop on the CPU, its captured chunk played by the
    plain versions: captured once, replayed at each chunk's first frame in
    order, the same outputs, carry and launches as the eager route."""
    s = setup
    am, lens, lm, lm_start = tpr.tie_inputs(s["lex"], nan=True)
    T = am.shape[1]
    played = []

    class PlainChunk:
        made = 0

        def __init__(self, st, frames, transport):
            PlainChunk.made += 1
            self.st, self.frames, self.transport = st, frames, transport

        def replay(self, t0):
            played.append((t0, self.frames))
            for t in range(t0, t0 + self.frames):
                wcts_step.shard_entries_reference(self.st, t, True, True)
                self.transport.all_reduce(self.st.floor_key, "min")
                wcts_step.shard_ends_reference(self.st, t)
                self.transport.all_gather(self.st.gathered, self.st.send)

    monkeypatch.setattr(wcts_step, "FrameChunk", PlainChunk)
    mesh = pm.make_mesh(1, ("model",), device="cpu", transport="local")
    transport = mesh.transports["model"]
    eager, graph = (pm.shard_state(torch.as_tensor(am), lens, s["tree"], s["tdp"], lm, lm_start,
                                   tpr.THRESHOLD, 0, 1) for _ in range(2))
    pm.run_frames_eager(eager, transport)
    pm._run_frames(graph, transport, chunk)
    assert PlainChunk.made == (1 if T > chunk else 0)
    assert played == [(2 + k * chunk, chunk) for k in range((T - 1) // chunk)]
    assert graph.written_equal(eager)


def test_end_lists_cover_every_word_at_its_node():
    end_node = np.asarray([3, 5, 3, 0, 5, 5, 7])
    first, nxt = wcts_step.end_lists(end_node, 9)
    seen = {}
    for n in range(9):
        w = first[n]
        while w >= 0:
            seen[int(w)] = n
            w = nxt[w]
    assert seen == {w: int(e) for w, e in enumerate(end_node)}
    assert first[1] == -1 and first[3] == 0 and first[5] == 1
