"""Flow dataflow networks: XML parsing + execution.

Counterpart of the reference's Flow engine
(rwth-asr-0.5/src/Flow/: Network.cc, NetworkParser.cc, Node.hh,
Link.hh; filters from Signal/ and Flow/).  The reference pulls typed
packets frame-by-frame through a node graph; here a network is parsed
once into a static DAG and executed as whole-utterance array transforms
(one batched tensor op per node) — the dataflow graph becomes a function
composition over whole arrays.

Supported syntax (NetworkParser.cc grammar subset used by the shipped
setups): <network> with <in>/<out>/<param>, <node name filter ...>,
<link from="a[:port]" to="b[:port]"/>, `$(var)` substitution, and
subnetwork filters (filter="lda.flow") resolved relative to the parent
file and inlined with hierarchical names (Flow/NetworkParser's network
expansion).

Node parameters that the reference takes from the configuration tree
(e.g. ``*.lda.file``) are passed via the ``config`` dict keyed by node
path; per-segment runtime parameters (``$(id)``) via ``run(params=...)``.

Port: a copy of speechrecognition_tpu/sprint/flow.py (host code).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .flow_cache import FeatureCache
from .lda import read_matrix_xml

Value = np.ndarray


def _subst(text: str, env: Dict[str, str]) -> str:
    out = text
    for _ in range(8):
        prev = out
        for k, v in env.items():
            out = out.replace(f"$({k})", str(v))
        if out == prev:
            break
    return out


@dataclass
class FlowNode:
    name: str
    filter: str
    attrs: Dict[str, str] = field(default_factory=dict)


@dataclass
class FlowNetwork:
    """Flattened (subnetworks inlined) dataflow DAG."""

    path: str
    nodes: Dict[str, FlowNode]
    links: List[Tuple[str, str, str, str]]   # (from_node, from_port, to, to_port)
    inputs: List[str]
    outputs: List[str]
    params: List[str]

    # -- parsing ---------------------------------------------------------------

    @staticmethod
    def parse(path: str, config: Optional[Dict[str, str]] = None,
              ) -> "FlowNetwork":
        """config: node-path-keyed parameters from the configuration tree
        (e.g. {"lda.file": ".../lda-1.matrix",
               "base-feature-extraction-cache.path": ".../cache"})."""
        config = dict(config or {})
        nodes: Dict[str, FlowNode] = {}
        links: List[Tuple[str, str, str, str]] = []
        ins: List[str] = []
        outs: List[str] = []
        params: List[str] = []
        FlowNetwork._parse_into(path, "", {}, config, nodes, links, ins, outs,
                                params, top=True)
        return FlowNetwork(path=path, nodes=nodes, links=links, inputs=ins,
                           outputs=outs, params=params)

    @staticmethod
    def _parse_into(path: str, prefix: str, outer_env: Dict[str, str],
                    config: Dict[str, str], nodes, links, ins, outs, params,
                    top: bool) -> Tuple[List[str], List[str], str]:
        tree = ET.parse(path)
        root = tree.getroot()
        net_name = root.get("name", "network")
        my_ins = [e.get("name") for e in root.findall("in")]
        my_outs = [e.get("name") for e in root.findall("out")]
        my_params = [e.get("name") for e in root.findall("param")]
        if top:
            ins.extend(my_ins)
            outs.extend(my_outs)
            params.extend(my_params)

        base = os.path.dirname(path)
        sub_io: Dict[str, Tuple[List[str], List[str], str]] = {}
        for e in root.findall("node"):
            raw_name = e.get("name")
            filt = e.get("filter")
            name = prefix + raw_name
            attrs = {k: _subst(v, outer_env)
                     for k, v in e.attrib.items() if k not in ("name", "filter")}
            # configuration-tree parameters for this node path
            for key, val in config.items():
                node_path, _, attr = key.rpartition(".")
                if node_path == name or (not node_path and attr in attrs):
                    if node_path == name:
                        attrs[attr] = str(val)
            if filt.endswith(".flow"):
                # subnetwork params resolve from the node's attributes and
                # the configuration tree scoped to this node path
                env = dict(attrs)
                for key, val in config.items():
                    node_path, _, attr = key.rpartition(".")
                    if node_path == name:
                        env[attr] = str(val)
                sub_path = os.path.join(base, filt)
                s_ins, s_outs, s_name = FlowNetwork._parse_into(
                    sub_path, name + "/", env, config, nodes, links,
                    ins, outs, params, top=False)
                sub_io[raw_name] = (s_ins, s_outs, s_name)
            else:
                nodes[name] = FlowNode(name=name, filter=filt, attrs=attrs)

        def resolve(ref: str, side: str) -> Tuple[str, str]:
            """'node[:port]' within this network → flattened (node, port)."""
            node, _, port = ref.partition(":")
            if node in (net_name, "network"):
                return ("__net__" + prefix, port or ("in" if side == "from"
                                                     else "out"))
            full = prefix + node
            if node in sub_io:
                # link to/from a subnetwork boundary
                return ("__net__" + full + "/", port or
                        ("out" if side == "from" else "in"))
            return (full, port or "")

        for e in root.findall("link"):
            f_node, f_port = resolve(e.get("from"), "from")
            t_node, t_port = resolve(e.get("to"), "to")
            links.append((f_node, f_port, t_node, t_port))
        return my_ins, my_outs, net_name

    # -- execution ---------------------------------------------------------------

    def run(self, registry: Optional[Dict[str, Callable]] = None,
            params: Optional[Dict[str, str]] = None,
            inputs: Optional[Dict[str, Value]] = None,
            context: Optional[dict] = None) -> Dict[str, Value]:
        """Execute the DAG; returns {output_port: value}."""
        registry = {**BUILTIN_FILTERS, **(registry or {})}
        params = dict(params or {})
        context = dict(context or {})
        # value store keyed by (producer node, port)
        values: Dict[Tuple[str, str], Value] = {}
        for port, v in (inputs or {}).items():
            values[("__net__", port)] = v

        # boundary forwarding: a link into __net__<prefix> port p feeds
        # every link out of __net__<prefix> port p
        remaining = list(self.links)
        node_inputs: Dict[str, Dict[str, Tuple[str, str]]] = {}
        fwd: Dict[Tuple[str, str], Tuple[str, str]] = {}
        for f_node, f_port, t_node, t_port in remaining:
            if t_node.startswith("__net__"):
                fwd[(t_node, t_port)] = (f_node, f_port)
            else:
                node_inputs.setdefault(t_node, {})[t_port or "in"] = (
                    f_node, f_port)

        def source_of(ref: Tuple[str, str]) -> Tuple[str, str]:
            seen = set()
            while ref[0].startswith("__net__"):
                if ref in values:
                    return ref
                if ref in seen:
                    raise ValueError(f"flow link cycle at {ref}")
                seen.add(ref)
                key = (ref[0], ref[1])
                if key in fwd:
                    ref = fwd[key]
                elif (ref[0], "") in fwd:
                    ref = fwd[(ref[0], "")]
                else:
                    # top-level input port
                    return ("__net__", ref[1])
            return ref

        def evaluate(node_name: str) -> None:
            if any(k[0] == node_name for k in values):
                return
            node = self.nodes[node_name]
            ins: Dict[str, Value] = {}
            for port, src in node_inputs.get(node_name, {}).items():
                s = source_of(src)
                if s not in values:
                    if s[0].startswith("__net__") or s[0] == "__net__":
                        raise ValueError(
                            f"missing network input for {node_name}:{port}")
                    evaluate(s[0])
                    s2 = (s[0], s[1])
                    if s2 not in values and (s[0], "") in values:
                        s2 = (s[0], "")
                    s = s2
                ins[port] = values[s]
            attrs = {k: _subst(v, params) for k, v in node.attrs.items()}
            if node.filter not in registry:
                raise ValueError(f"unknown flow filter: {node.filter}")
            out = registry[node.filter](ins, attrs, context)
            if isinstance(out, dict):
                for p, v in out.items():
                    values[(node_name, p)] = v
                values[(node_name, "")] = next(iter(out.values()))
            else:
                values[(node_name, "")] = out
                values[(node_name, "out")] = out

        results: Dict[str, Value] = {}
        for out_port in self.outputs:
            src = source_of(("__net__", out_port))
            if src not in values:
                evaluate(src[0])
                if src not in values and (src[0], "") in values:
                    src = (src[0], "")
            results[out_port] = values[src]
        return results


# -- builtin filters (Signal/ + Flow/ node library subset) ---------------------


def _single(ins: Dict[str, Value]) -> Value:
    if "in" in ins:
        return ins["in"]
    return next(iter(ins.values()))


def f_generic_cache(ins, attrs, ctx):
    """Flow/Cache.cc reading side: features for segment $(id)."""
    cache = ctx.get("cache")
    if cache is None:
        cache = FeatureCache(attrs["path"])
        ctx["cache"] = cache
    feats, _t = cache.read_features(attrs["id"])
    return feats


def f_sequence_concatenation(ins, attrs, ctx):
    """signal-vector-f32-sequence-concatenation: sliding window of
    max-size frames with `right` future frames (Signal/ window node)."""
    x = _single(ins)
    max_size = int(attrs.get("max-size", 1))
    right = int(attrs.get("right", 0))
    left = max_size - 1 - right
    T, D = x.shape
    idx = np.clip(np.arange(T)[:, None]
                  + np.arange(-left, right + 1)[None, :], 0, T - 1)
    return x[idx].reshape(T, max_size * D)


def f_matrix_multiplication(ins, attrs, ctx):
    """signal-matrix-multiplication-f32 (Signal/MatrixMultiplication)."""
    x = _single(ins)
    key = ("matrix", attrs["file"])
    if key not in ctx:
        ctx[key] = read_matrix_xml(attrs["file"]).astype(np.float32)
    return x @ ctx[key].T


def f_normalization(ins, attrs, ctx):
    """signal-normalization: per-utterance mean/variance normalization
    (Signal/Normalization.cc, type=mean-and-variance)."""
    x = _single(ins)
    kind = attrs.get("type", "mean-and-variance")
    mean = x.mean(axis=0, keepdims=True)
    if kind == "mean":
        return x - mean
    std = x.std(axis=0, keepdims=True)
    return (x - mean) / np.where(std > 0, std, 1.0)


def f_preemphasis(ins, attrs, ctx):
    """signal-preemphasis (Signal/Preemphasis.cc): x[t] − α·x[t−1]."""
    x = _single(ins).astype(np.float64)
    alpha = float(attrs.get("alpha", 1.0))
    out = x.copy()
    out[1:] -= alpha * x[:-1]
    out[0] *= 1.0 - alpha
    return out


def f_delay(ins, attrs, ctx):
    """generic-delay / identity passthrough."""
    return _single(ins)


# -- DSP node catalog: the Signal/ filters behind audio→MFCC networks ---------
# Each node delegates to features/frontend.py so a sietill-equivalent .flow
# network reproduces the .mm2 feature files bit-exactly (test_flow.py).


def _attr_samples(attrs, key, sample_rate, default):
    """Window lengths appear as seconds (Sprint `.025`) or samples (sietill
    `200`); values < 1 are seconds."""
    v = float(attrs.get(key, default))
    return int(round(v * sample_rate)) if v < 1.0 else int(round(v))


def f_audio_input(ins, attrs, ctx):
    """Audio file source (Audio/Wav.cc node family). The file comes from
    the `file` attribute (usually `$(input-file)`); .sph/.wav headers are
    handled by io.read_audio_file (IO.cpp:13-44 semantics)."""
    from ..io import read_audio_file

    return read_audio_file(attrs["file"])


def f_sietill_preemphasis(ins, attrs, ctx):
    """sietill pre-emphasis: saturated int16 difference x[i]−x[i−1]
    (SignalAnalysis.cpp:120-131). Distinct from Sprint's float
    signal-preemphasis (alpha scaling, no saturation)."""
    from ..features.frontend import pre_emphasis

    return pre_emphasis(np.asarray(_single(ins)))


def f_window(ins, attrs, ctx):
    """signal-window (Signal/Window.cc + WindowFunction.cc): frame the
    signal every `shift` and apply the window function. Output [T, length].
    sietill zero-pads the tail so every shift starts a frame
    (SignalAnalysis.cpp:87-99) — `flush-all=true` (the default here)."""
    from ..features.frontend import SignalAnalysisConfig, _frame_signal, hamming_window

    x = np.asarray(_single(ins)).astype(np.float64).reshape(-1)
    rate = int(float(attrs.get("sample-rate", ctx.get("sample-rate", 8000))))
    length = _attr_samples(attrs, "length", rate, 200)
    shift = _attr_samples(attrs, "shift", rate, 80)
    cfg = SignalAnalysisConfig(sample_rate=rate,
                               window_shift_ms=shift * 1000 // rate,
                               window_size_ms=length * 1000 // rate)
    frames = _frame_signal(x, cfg)
    kind = attrs.get("type", "hamming")
    if kind == "hamming":
        return frames * hamming_window(length)[None, :]
    if kind == "rectangular":
        return frames
    raise ValueError(f"unsupported window type: {kind}")


def f_real_fft(ins, attrs, ctx):
    """signal-real-fast-fourier-transform: zero-pad frames to `length`,
    FFT with 1/√N normalization (SignalAnalysis.cpp:146-222), output the
    alternating re/im vector Sprint nodes exchange
    (Signal/FastFourierTransform.cc)."""
    frames = np.asarray(_single(ins), np.float64)
    N = int(attrs.get("length", attrs.get("maximum-input-size", 1024)))
    T, w = frames.shape
    padded = np.zeros((T, N))
    padded[:, :w] = frames
    spec = np.fft.rfft(padded, axis=1) / np.sqrt(N)
    out = np.empty((T, 2 * spec.shape[1]))
    out[:, 0::2] = spec.real
    out[:, 1::2] = spec.imag
    return out


def f_amplitude(ins, attrs, ctx):
    """signal-vector-alternating-complex-f32-amplitude: |z| via hypot
    (SignalAnalysis.cpp:226-233)."""
    x = np.asarray(_single(ins), np.float64)
    return np.hypot(x[:, 0::2], x[:, 1::2])


def f_filterbank(ins, attrs, ctx):
    """signal-filterbank (Signal/Filterbank.cc, warping-function=mel):
    triangular mel filters; sietill geometry with centers at i·d
    (SignalAnalysis.cpp:237-303). `floor` adds the reference's 1e-10
    before the log stage (SignalAnalysis.cpp:244-247)."""
    from ..features.frontend import SignalAnalysisConfig, mel_filterbank_matrix

    spec = np.asarray(_single(ins), np.float64)
    n_bins = spec.shape[1]
    rate = int(float(attrs.get("sample-rate", ctx.get("sample-rate", 8000))))
    n_filters = int(attrs.get("filters", attrs.get("n-filters", 15)))
    cfg = SignalAnalysisConfig(sample_rate=rate, n_mel_filters=n_filters,
                               dft_length=2 * (n_bins - 1))
    fb = mel_filterbank_matrix(cfg)
    floor = float(attrs.get("floor", 0.0))
    return floor + spec @ fb


def f_ln(ins, attrs, ctx):
    """generic-vector-f32-ln: natural log elementwise."""
    return np.log(np.asarray(_single(ins), np.float64))


def f_cosine_transform(ins, attrs, ctx):
    """signal-cosine-transform (Signal/CosineTransform.cc): unscaled
    DCT-II keeping `nr-outputs` coefficients (SignalAnalysis.cpp:307-316)."""
    from ..features.frontend import SignalAnalysisConfig, dct_matrix

    x = np.asarray(_single(ins), np.float64)
    n_out = int(attrs.get("nr-outputs", 12))
    cfg = SignalAnalysisConfig(n_mel_filters=x.shape[1],
                               n_features_in_file=n_out)
    return x @ dct_matrix(cfg)


def f_regression(ins, attrs, ctx):
    """signal-regression (Signal/Regression.cc:25-66): least-squares
    derivative over a sliding window of `max-size` frames.

      order 1:  out[t] = Σᵢ dt·f[t+i] / Σ dt²,  dt = i − (n−1)/2
      order 2:  out[t] = Σᵢ f[t+i]·(2·(tm − dt²·n)/(tm² − n·Σdt⁴))

    Window frames beyond the sequence edge repeat the boundary frame
    (the sliding-window node's frame prediction)."""
    x = np.asarray(_single(ins), np.float64)
    T, D = x.shape
    n = int(attrs.get("max-size", 5))
    right = int(attrs.get("right", (n - 1) // 2))
    left = n - 1 - right
    order = int(attrs.get("order", 1))
    idx = np.clip(np.arange(T)[:, None] + np.arange(-left, right + 1)[None, :],
                  0, T - 1)
    win = x[idx]                                    # [T, n, D]
    dt = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    tm = float((dt * dt).sum())
    if order == 1:
        return np.einsum("tnd,n->td", win, dt) / tm
    if order == 2:
        ns = tm * tm - n * float((dt ** 4).sum())
        coef = (tm - dt * dt * n) * 2.0 / ns
        return np.einsum("tnd,n->td", win, coef)
    raise ValueError("signal-regression supports order 1 and 2 only")


def f_sietill_deltas(ins, attrs, ctx):
    """sietill Δ/ΔΔ-energy expansion: [T, 12] → [T, 25]
    (SignalAnalysis.cpp:320-336 clamped-step differences)."""
    from ..features.frontend import SignalAnalysisConfig, add_deltas

    step = int(attrs.get("deriv-step", 3))
    cfg = SignalAnalysisConfig(deriv_step=step)
    return add_deltas(np.asarray(_single(ins), np.float32), cfg)


def f_energy_max_norm(ins, attrs, ctx):
    """sietill per-utterance energy-max normalization
    (SignalAnalysis.cpp:340-349)."""
    from ..features.frontend import energy_max_normalization

    return energy_max_normalization(np.asarray(_single(ins), np.float32))


def f_mean_variance_file_norm(ins, attrs, ctx):
    """Corpus mean/σ normalization from a stored statistics file
    (SignalAnalysis.cpp:353-399; sietill Normalization-eugen.bin format)."""
    from ..features.frontend import apply_normalization
    from ..io import read_normalization

    x = np.asarray(_single(ins), np.float32)
    mean, std = read_normalization(attrs["file"], x.shape[1])
    return apply_normalization(x, mean, std)


def f_convert(ins, attrs, ctx):
    """generic-convert-* family: dtype casts between node families."""
    to = attrs.get("to", "f32")
    dt = {"f32": np.float32, "f64": np.float64, "s16": np.int16}[to]
    return np.asarray(_single(ins)).astype(dt)


def f_cache_write(ins, attrs, ctx):
    """Flow/Cache.cc writing side: dump the input to a raw float file
    (.mm2 layout, IO.cpp:82-92) keyed by $(id) under `path`."""
    from ..io import write_feature_file

    x = np.asarray(_single(ins), np.float32)
    path = attrs["path"]
    if "id" in attrs:
        path = os.path.join(path, attrs["id"] + ".mm2")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_feature_file(path, x)
    return x


BUILTIN_FILTERS: Dict[str, Callable] = {
    "generic-cache": f_generic_cache,
    "signal-vector-f32-sequence-concatenation": f_sequence_concatenation,
    "signal-matrix-multiplication-f32": f_matrix_multiplication,
    "signal-normalization": f_normalization,
    "signal-preemphasis": f_preemphasis,
    "generic-identity": f_delay,
    # DSP catalog (audio → MFCC)
    "audio-input-file": f_audio_input,
    "audio-input-file-wav": f_audio_input,
    "sietill-preemphasis": f_sietill_preemphasis,
    "signal-window": f_window,
    "signal-real-fast-fourier-transform": f_real_fft,
    "signal-vector-alternating-complex-f32-amplitude": f_amplitude,
    "signal-filterbank": f_filterbank,
    "generic-vector-f32-ln": f_ln,
    "signal-cosine-transform": f_cosine_transform,
    "signal-regression": f_regression,
    "sietill-deltas": f_sietill_deltas,
    "sietill-energy-max-normalization": f_energy_max_norm,
    "signal-mean-variance-normalization-file": f_mean_variance_file_norm,
    "generic-convert": f_convert,
    "generic-convert-vector-s16-to-vector-f32": f_convert,
    "generic-convert-vector-f64-to-vector-f32": f_convert,
    "generic-cache-write": f_cache_write,
}
