"""Builder and loader for the hand-written CUDA kernels in ``csrc/``.

At first use, every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and the
objects are linked into one shared library with a plain C interface under
``build/kernels/`` at the repository root, which is loaded with ``ctypes``.
The library's file name carries a hash of the sources (headers included) and
flags, so an edited source is rebuilt and a stale library is never loaded.
Only the sources in this package are compiled; nothing is fetched or taken
from another package.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` right after the launch; :func:`check` turns a
non-zero code into an exception (a refused launch never runs, and a later
synchronise would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: -Xptxas -v only reports each kernel's registers, shared memory and spills
#: (kept in build_log); it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
#: C signatures of the entry points: (argument types, result type). The
#: kernel entry points return an int cudaError_t.
SIGNATURES = {
    # x, mu, a, c, out, N, J, dim, device, stream
    "sr_mahalanobis_scores": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    # x, mu, a, c, out, N, S, D, dim, device, stream
    "sr_mahalanobis_min": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    # am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen,
    # exit_pen (or NULL), hyp_in, bkp_in, book_in, hyp_out, bkp_out,
    # book_out, score, word, bkp, scratch (or NULL), B, T, S, W, P, t0,
    # am_threshold, prune, device, stream
    "sr_decode_scan": ((_P,) * 18 + (_I, _I, _I, _I, _I, _I, _F, _I, _I, _P), _I),
    # the same, in float64 (score arrays and am_threshold)
    "sr_decode_scan_f64": ((_P,) * 18 + (_I, _I, _I, _I, _I, _I, _D, _I, _I, _P), _I),
    # W, P → kernel B's instance (1-4: positions a lane of the warp
    # instance; 0: block instance, its lattice in shared memory; -1: in
    # device scratch)
    "sr_decode_scan_instance": ((_I, _I), _I),
    # W, P, f64 → blocks per SM of kernel B's launch (-1: error)
    "sr_decode_scan_residency": ((_I, _I, _I), _I),
    # x, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo, logw_hi, logw_lo,
    # out_hi, out_lo, N, S, D, dim, device, stream
    "sr_am_scores_df": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _P), _I),
    # am_hi, am_lo, feat_len, state_table, last_pos, word_len, first_state,
    # tdp_hi, tdp_lo, ent_hi, ent_lo, hyp_hi_in, hyp_lo_in, bkp_in,
    # book_hi_in, book_lo_in, hyp_hi_out, hyp_lo_out, bkp_out, book_hi_out,
    # book_lo_out, score, word, bkp, scratch (or NULL), B, T, S, W, P, t0,
    # am_threshold, prune, device, stream
    "sr_decode_scan_df": ((_P,) * 25 + (_I, _I, _I, _I, _I, _I, _F, _I, _I,
                                        _P), _I),
    # W, P → kernel D's instance (1-4: positions a lane of the warp
    # instance; 0: block instance, its lattice in shared memory; -1: in
    # device scratch)
    "sr_decode_scan_df_instance": ((_I, _I), _I),
    # W, P → threads a block of kernel D's launch for that lattice
    "sr_decode_scan_df_threads": ((_I, _I), _I),
    # W, P → floats of device scratch an utterance of kernel D's block
    # instance takes where its instance is -1
    "sr_decode_scan_df_scratch": ((_I, _I), _I),
    # W, P → blocks per SM of kernel D's launch for that lattice (-1: error)
    "sr_decode_scan_df_residency": ((_I, _I), _I),
    # prev, ams, tdp, pos_valid, feat_len, out, jumps, scratch (or NULL), B,
    # C, A, t0, thr, tie_pruned, use_pruning, first_design (0: the instance
    # A chooses; 1: the block instance for 128 < A <= 1024), device, stream
    "sr_align_fwd": ((_P,) * 8 + (_I, _I, _I, _I, _F, _I, _I, _I, _I, _P), _I),
    # the same, in float64 (score arrays and thr)
    "sr_align_fwd_f64": ((_P,) * 8 + (_I, _I, _I, _I, _D, _I, _I, _I, _I, _P), _I),
    # A → warps per utterance of kernel E's warp instance (1-4) or wide
    # instance (3-8; -1: the block instance, its row in device scratch)
    "sr_align_fwd_warps": ((_I,), _I),
    # A → positions a lane of that instance (1, 2-4; 0: the block instance)
    "sr_align_fwd_positions": ((_I,), _I),
    # prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo, pos_valid, feat_len,
    # out_hi, out_lo, jumps, scratch (or NULL), B, C, A, t0, thr_hi, thr_lo,
    # tie_pruned, use_pruning, first_design, device, stream
    "sr_align_fwd_df": ((_P,) * 12 + (_I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P), _I),
    # A → warps per utterance of kernel F's warp instance (1-4) or wide
    # instance (3-8; -1: the block instance, its row in device scratch)
    "sr_align_fwd_df_warps": ((_I,), _I),
    # A → positions a lane of that instance (1, 2-4; 0: the block instance)
    "sr_align_fwd_df_positions": ((_I,), _I),
    # A → (hi, lo) pairs of device scratch an utterance of kernel F's block
    # instance takes past A = 1024 (the row by frame parity, the NaN fold)
    "sr_align_fwd_df_scratch": ((_I,), _I),
    # final_hi, aut_len, jumps, feat_len, states_tbl, states, final_pos, B, A,
    # Tp, T, tie_pruned, device, stream
    "sr_align_backtrack": ((_P,) * 7 + (_I, _I, _I, _I, _I, _I, _P), _I),
    # A → frames a tile of kernel G's launch (0: rows walked from device
    # memory)
    "sr_align_backtrack_tile": ((_I,), _I),
    # frames, mask, block_state, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo,
    # logw_hi, logw_lo, scratch, total, w, xs, x2s, NB, R, S, D, dim,
    # first_pass, device, stream
    "sr_em_pass_df": ((_P,) * 16 + (_I,) * 7 + (_P,), _I),
    # NB, R, D, dim → doubles of scratch sr_em_pass_df needs (-1: too many)
    "sr_em_pass_df_scratch": ((_I, _I, _I, _I), _I),
    # f64, am, feat_len, state, parent, grand, depth, tdp, loop_allowed,
    # end_word, exit_penalty, score, word, bkp, scratch (or NULL), B, T, S, N,
    # am_threshold, prune, first_design (0: the instance the shape chooses;
    # 1: the block instance), device, stream
    "sr_tree_scan": ((_I,) + (_P,) * 14 + (_I,) * 4 + (_D, _I, _I, _I, _P), _I),
    # N, f64 → bytes of device scratch an utterance of kernel I needs (0: the
    # tree in shared memory; -1: too large)
    "sr_tree_scan_scratch": ((_I, _I), _I),
    # N, f64 → kernel I's instance (1-4: nodes a lane of the owner instance;
    # 0: block instance, its lattice in shared memory; -1: in device scratch)
    "sr_tree_scan_instance": ((_I, _I), _I),
    # N, f64, first_design → blocks per SM of kernel I's launch (-1: error)
    "sr_tree_scan_residency": ((_I, _I, _I), _I),
    # f64, am, feat_len, state_table, last_pos, word_len, tdp_within,
    # entry_tdp, lm, lm_start, book, bkp, pred, offset, scratch (or NULL), B,
    # T, S, W, P, am_threshold, prune, first_design (0: the instance the
    # shape chooses; 1: the block instance), device, stream
    "sr_decode_scan_bigram": ((_I,) + (_P,) * 14 + (_I,) * 5 + (_D, _I, _I, _I, _P), _I),
    # W, P, f64 → kernel J's scratch bytes an utterance (0: shared memory)
    "sr_decode_scan_bigram_scratch": ((_I, _I, _I), _I),
    # W, P, f64 → kernel J's instance (1-4: positions a lane of the warp
    # instance; 0: block instance, its lattice in shared memory; -1: in
    # device scratch)
    "sr_decode_scan_bigram_instance": ((_I, _I, _I), _I),
    # W, P, f64, first_design → blocks per SM of kernel J's launch (-1: error)
    "sr_decode_scan_bigram_residency": ((_I, _I, _I, _I), _I),
    # f64, am, feat_len, state, parent, grand, tdp, loop_allowed,
    # entry_state, entry_pen, end_node, lm_ext, la; the carry in (hyp, bkp,
    # book, silp, silb) and out; book, bkp, pred, offset; cand, ebkp (or
    # NULL); active states, trees, word ends (or NULL); via_sil, silb_prev,
    # silp, silb (or NULL); scratch (or NULL); B, T, S, C, N, W, t0,
    # am_threshold, prune, use_lookahead, state_limit, bins, silence (-1:
    # none), force (0: the instance the shape chooses; 1: the block
    # instance; 8, 16: the owner instance with that many contexts a thread),
    # device, stream
    "sr_wcts_scan": ((_I,) + (_P,) * 36 + (_I,) * 7 + (_D,) + (_I,) * 7 + (_P,), _I),
    # C, N, W, S, bins, f64 → kernel K's scratch bytes an utterance (0: none,
    # the state stays in shared memory)
    "sr_wcts_scan_scratch": ((_I,) * 6, _I),
    # C, N, W, S, bins, f64 → kernel K's instance (8, 16: contexts a thread
    # of the owner instance; 0: block instance, its state in shared memory;
    # -1: in device scratch)
    "sr_wcts_scan_instance": ((_I,) * 6, _I),
    # C, N, W, S, bins, f64, use_lookahead, force → blocks per SM of kernel
    # K's launch (-1: error, or a forced instance that does not take it)
    "sr_wcts_scan_residency": ((_I,) * 8, _I),
    # f64, lams, ltdp, pos_valid, feat_len, aut_len, gamma, log_z, scratch (or
    # NULL), beta (the backward chain's rows, or NULL), B, T, A, first_design
    # (0: the instance the shape chooses; 1: the first design for A <=
    # 1024), device, stream
    "sr_forward_backward": ((_I,) + (_P,) * 9 + (_I, _I, _I, _I, _I, _P), _I),
    # f64, chain (0 forward, 1 backward), lams, ltdp, pos_valid, feat_len,
    # aut_len, gamma, log_z, beta, B, T, A, device, stream: one chain of
    # kernel L's two chains (A <= 1024) alone, for timing the chains apart
    "sr_forward_backward_chain": ((_I, _I) + (_P,) * 8 + (_I, _I, _I, _I, _P), _I),
    # A → kernel L's instance (1-4: positions a lane of the two chains; -1:
    # the block instance, its rows in device scratch)
    "sr_forward_backward_instance": ((_I,), _I),
    # A → warps a chain of kernel L's two chains (1, 2-8; 0: the block
    # instance past A = 1024)
    "sr_forward_backward_warps": ((_I,), _I),
    # A, f64, first_design → blocks per SM of kernel L's launch (-1: error)
    "sr_forward_backward_residency": ((_I, _I, _I), _I),
    # f64, am, feat_len, state_table, last_pos, word_len, tdp_within,
    # entry_pen, sil_states, sil_tdp, sil_entry_pen, lm_ext, book, bkp, pred,
    # via, origin, silend, silorg, offset, scratch (or NULL), B, T, S, W, P,
    # Ps, sil_exit, am_threshold, prune, first_design (0: the instance the
    # shape chooses; 1: the first design, a thread a word), device, stream
    "sr_linear_scan": ((_I,) + (_P,) * 20 + (_I,) * 6 + (_D, _D, _I, _I, _I, _P), _I),
    # W, P, Ps, S, f64 → kernel M's first design's scratch bytes an
    # utterance (0: shared memory; -1: too large)
    "sr_linear_scan_scratch": ((_I,) * 5, _I),
    # W, P, Ps, S, T, f64 → kernel M's instance (1: the warp instance; the
    # first design with its state in shared memory, 0, or in scratch, -1)
    "sr_linear_scan_instance": ((_I,) * 6, _I),
    # W, P, Ps, S, f64, first_design → blocks per SM of kernel M's launch
    # (-1: error)
    "sr_linear_scan_residency": ((_I,) * 6, _I),
    # f64, book, bkp, pred, origin, silend, silorg, feat_len, words, B, T, W,
    # max_words, first_design (0: the warp design; 1: the first design, a
    # thread an utterance), device, stream
    "sr_linear_traceback": ((_I,) + (_P,) * 8 + (_I,) * 6 + (_P,), _I),
    # first_design (0: the tensor-core design; 1: the first design), x, isv,
    # qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of (the last
    # three NULL without preselection), out, scratch (or NULL), N, S, D, dim,
    # row_bytes, C, n_selected, scale2x, backoff, device, stream
    "sr_quantized_scores": ((_I,) + (_P,) * 10 + (_I,) * 7 + (_F, _F, _I, _P), _I),
    # row_bytes → frames a block of kernel O's tensor-core design (0: a width
    # it does not take)
    "sr_quantized_scores_tile": ((_I,), _I),
    # row_bytes, C → kernel O's scratch bytes a block (0: none; -1: too large)
    "sr_quantized_scores_scratch": ((_I, _I), _I),
    # row_bytes, C, D, first_design → blocks per SM of kernel O's launch (-1:
    # error)
    "sr_quantized_scores_residency": ((_I,) * 4, _I),
    # f64, am, feat_len, state, parent, grand, tdp, loop_allowed, entry_state,
    # entry_pen, end_first, end_next, hyp, bkp, carry_floor, book, gathered,
    # rank_bytes, ranks, out_book, out_bkp, out_pred, ends, ends_bkp,
    # floor_key, nhyp, nbkp (or NULL), B, T, S, n_local, N, W, ctx0, thr,
    # prune, frame (or NULL), t, recombine, step, first_design (0: the
    # instance the shape chooses; 1: the block instance), device, stream:
    # kernel P's first launch
    "sr_wcts_shard_entries": ((_I,) + (_P,) * 16 + (ctypes.c_longlong, _I) + (_P,) * 8
                              + (_I,) * 7 + (_D, _I, _P) + (_I,) * 5 + (_P,), _I),
    # f64, feat_len, lm_local, floor_key, carry_floor, ends, ends_bkp, send,
    # B, n_local, W, ctx0, thr, prune, frame (or NULL), t, device, stream:
    # kernel P's second launch
    "sr_wcts_shard_ends": ((_I,) + (_P,) * 7 + (_I,) * 4 + (_D, _I, _P, _I, _I, _P), _I),
    # n_local, N, W, f64 → kernel P's first launch's instance (1: the owner
    # instance; 0: the block instance, its scratch rows in device memory)
    "sr_wcts_shard_instance": ((_I,) * 4, _I),
    # n_local, N, W, f64, first_design → blocks per SM of kernel P's first
    # launch (-1: error)
    "sr_wcts_shard_residency": ((_I,) * 5, _I),
    "sr_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None
#: seconds the last call to load() spent compiling (0.0 when cached), and
#: what nvcc printed then
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsr_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; return their (returncode, output) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _build(out: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    logs = []
    try:
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                            for s, o in zip(sources, objs)])
        for s, (rc, text) in zip(sources, results):
            logs.append(text)
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {s.name} ({rc}):\n{text}")
        (rc, text), = _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                 *map(str, objs)]])
        logs.append(text)
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{text}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            out = library_path()
            build_seconds = 0.0
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().sr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


# -- helpers of the wrappers that launch the search tier's kernels ------------


def typed_args(what: str, device, dtype, **tensors) -> Dict:
    """name → (tensor, shape): each checked for its device and shape, as a
    contiguous tensor of ``dtype`` (no copy when it already is one)."""
    out = {}
    for name, (t, shape) in tensors.items():
        if t.device != device or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be a {tuple(shape)} tensor on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        out[name] = t.to(dtype).contiguous()
    return out


def scratch(B: int, per_utterance: int, device):
    """Device scratch for B utterances whose state does not fit in shared
    memory (``per_utterance``: the C entry's bytes an utterance; 0: none
    needed, < 0: too large)."""
    import torch
    if per_utterance < 0:
        raise ValueError("an utterance's lattice is too large for this kernel")
    return (torch.empty(B * per_utterance, dtype=torch.uint8, device=device)
            if per_utterance else None)


def ptr(t: Optional[object]):
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()
