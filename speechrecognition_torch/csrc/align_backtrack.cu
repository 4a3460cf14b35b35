// Kernel G: final position, backward walk and position -> state gather of the
// forced alignment.
//
// Replaces three functions of speechrecognition_tpu/align/viterbi.py, which
// XLA runs as three programs per batch (the walk as one lax.scan per chunk):
//   * _final_pos_dev: with pruning the highest position whose final cost is
//     finite (hi < BIG/2 as float32; position 0 when none is), else the
//     automaton's last position aut_len - 1;
//   * _align_bwd_chunk, over every chunk at once: walking global frames
//     t = Tp-1 .. 0, the frame emits the current position; then the position
//     stays at t == 0, steps back by jumps[t][cur] while t <= feat_len - 1,
//     and resets to the final position past the utterance's end;
//   * _states_from_positions: each emitted position's state (int32 here; the
//     reference narrowed it to int16 for a host transfer).
// A position below 0 counts from the row's end once, as the reference's
// take_along_axis does, and is clamped to the row beyond that (only a path
// through an unreachable forced final position gets there; the reference's
// gather fills there instead, so its walk is undefined from that frame on).
// Inputs: final_hi [B, A] float32, aut_len [B], jumps [Tp, B, A] int8,
// feat_len [B], states_tbl [B, A]; outputs states [B, T] (frames t < T),
// final_pos [B].
//
// What bounds it: the walk is a chain of Tp dependent steps (each jump's
// address is the position the previous jump gave), so no design goes below
// Tp times one load's latency; the bytes it must move (one jump byte a
// frame, the rows it gathers from and the states it writes) take a few
// hundredths of that. The first design walked each chain out of device
// memory, one global-memory latency a step (0.25 us).
//
// Design: one warp per utterance, up to UTTS utterances a block. The warp
// stages its utterance's jump rows into shared memory a tile of F frames at a time,
// walking backwards, with 16-byte cp.async copies (a row starts at any byte,
// so each row is copied as the aligned 16-byte chunks that hold it, and the
// walk reads it at its offset within the first chunk); two tiles are in
// flight, so the next tile arrives while lane 0 walks the current one. A
// step is then a shared-memory load and a few integer operations (on an
// H100 40 ns, against 15 ns for one dependent shared-memory load). Only the
// rows the walk reads are copied (1 <= t <= feat_len - 1). Lane 0 writes the
// positions of a tile to shared memory, and the whole warp then gathers
// their states (the state-table row stays in L1 after the first tile) and
// writes them coalesced. The final position is a warp-wide redux.sync
// maximum over the final-cost row, found while the first tile is in
// flight. Shared memory per utterance is bounded by the tile: F is cut
// from 128 frames so that a tile of rows stays near TILE_BYTES, but not
// below 32 frames while a block's shared memory holds two such tiles (a
// block then holds fewer utterances), and down to one row beyond; a row
// longer than a block's shared memory can hold twice (A > 116,000) is
// walked from device memory, as the first design did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int UTTS = 4;               // utterances (warps) a block, at most
constexpr int TILE = 128;             // frames a tile, at most
constexpr int TILE_BYTES = 12288;     // the bytes one tile of rows is cut to
constexpr int MIN_FRAMES = 32;        // frames a tile keeps for long rows (its walk outlasts a copy)
constexpr int CHUNK = 16;             // bytes one cp.async moves
constexpr int MAX_SMEM = 232448;      // dynamic shared memory a block can use

// the launch for A positions: frames a tile, bytes a staged row spans (its
// aligned chunks), utterances a block, and each warp's bytes of shared
// memory (two tiles and the tile's positions, or the positions alone when
// the rows are walked from device memory)
struct Layout {
  int frames, row_bytes, utts, warp_bytes;
  bool staged;
};

Layout layout_for(int A) {
  Layout L;
  L.row_bytes = CHUNK * ((A + 2 * CHUNK - 2) / CHUNK);  // up to 15 bytes before the row
  L.frames = TILE_BYTES / L.row_bytes;
  if (L.frames < MIN_FRAMES)  // long rows: fewer utterances a block, not fewer frames a tile
    L.frames = min(MIN_FRAMES, (MAX_SMEM - 4 * MIN_FRAMES - CHUNK) / (2 * L.row_bytes));
  L.frames = L.frames < 1 ? 1 : L.frames > TILE ? TILE : L.frames;
  L.warp_bytes = 2 * L.frames * L.row_bytes + 4 * L.frames;
  L.warp_bytes = (L.warp_bytes + CHUNK - 1) / CHUNK * CHUNK;
  L.staged = L.warp_bytes <= MAX_SMEM;
  if (!L.staged) {
    L.frames = TILE;
    L.warp_bytes = 4 * TILE;
  }
  L.utts = UTTS;
  while (L.utts > 1 && L.utts * L.warp_bytes > MAX_SMEM) --L.utts;
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a position's column: below 0 it counts from the row's end once, then it
// is clamped to the row
__device__ __forceinline__ int wrap(int cur, int A) {
  const int idx = cur < 0 ? cur + A : cur;
  return min(max(idx, 0), A - 1);
}

// lane 0's walk over the frames hi .. lo of a tile from position cur: each
// frame emits its column into pos[t - lo]; frames past the utterance's last
// row reset the position to fp, frames 1 <= t <= last_row step back by their
// jump (row(t) is frame t's jump row), frame 0 keeps it. The stepping
// frames run in a loop whose only branch is its own, so a step is the wrap,
// the clamp, the address, the load and the subtract. Returns the position
// entering frame lo - 1.
template <typename Row>
__device__ __forceinline__ int walk(int cur, int hi, int lo, int last_row, int A, int fp,
                                    int* pos, Row row) {
  int t = hi;
  for (; t >= lo && t > last_row; --t) {
    pos[t - lo] = wrap(cur, A);
    cur = fp;
  }
  const int bot = max(lo, 1);
#pragma unroll 4
  for (; t >= bot; --t) {
    const int idx = wrap(cur, A);
    pos[t - lo] = idx;
    cur -= row(t)[idx];
  }
  if (t == 0 && lo == 0) pos[0] = wrap(cur, A);
  return cur;
}

__global__ void __launch_bounds__(UTTS * 32) align_backtrack_kernel(
    const float* __restrict__ final_hi, const int* __restrict__ aut_len,
    const signed char* __restrict__ jumps, const int* __restrict__ feat_len,
    const int* __restrict__ states_tbl, int* __restrict__ states, int* __restrict__ final_pos,
    int B, int A, int Tp, int T, int tie_pruned, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // no block-wide barrier follows
  unsigned char* tiles = smem + (size_t)warp * L.warp_bytes;
  int* pos = reinterpret_cast<int*>(tiles + (L.staged ? 2 * L.frames * L.row_bytes : 0));

  const int len = feat_len[b];
  const int* tbl = states_tbl + (size_t)b * A;
  const size_t stride = (size_t)B * A;  // bytes between an utterance's rows
  const size_t base = (size_t)b * A;    // its row of frame 0
  const int F = L.frames;
  const int last_row = min(len - 1, Tp - 1);  // rows past it are never read
  const int ntiles = (Tp + F - 1) / F;

  // tile k holds frames lo .. hi, hi = Tp - 1 - k*F; its rows the walk
  // reads, as whole aligned chunks, row t at (t - lo) * row_bytes
  auto stage = [&](int k) {
    const int hi = Tp - 1 - k * F, lo = max(hi - F + 1, 0);
    const int r0 = max(lo, 1), r1 = min(hi, last_row);
    unsigned char* buf = tiles + (k & 1) * F * L.row_bytes;
    const int chunks = L.row_bytes / CHUNK;
    const int n = r1 >= r0 ? (r1 - r0 + 1) * chunks : 0;
    for (int j = lane; j < n; j += 32) {
      const int r = r0 + j / chunks, c = j % chunks;
      const size_t start = (size_t)r * stride + base;
      const size_t at = (start & ~(size_t)(CHUNK - 1)) + (size_t)c * CHUNK;
      if (at < start + A) cp_async16(buf + (r - lo) * L.row_bytes + c * CHUNK, jumps + at);
    }
    cp_async_commit();
  };

  if (L.staged) stage(0);  // in flight while the final position is found

  // the final position: the highest finite one, a warp maximum
  int fp;
  if (tie_pruned) {
    const float* fin = final_hi + (size_t)b * A;
    int hi = -1;
    for (int a = lane; a < A; a += 32)
      if (fin[a] < 5e29f) hi = a;  // float32(BIG * 0.5)
    fp = max(__reduce_max_sync(FULL, hi), 0);
  } else {
    fp = aut_len[b] - 1;
  }
  if (lane == 0) final_pos[b] = fp;

  int cur = fp;  // lane 0's position
  for (int k = 0; k < ntiles; ++k) {
    const int hi = Tp - 1 - k * F, lo = max(hi - F + 1, 0);
    if (L.staged) {
      if (k + 1 < ntiles) {
        stage(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();  // every lane's copies of tile k are visible
    }
    if (lane == 0) {
      // two loops, so that the staged walk's loads are shared-memory loads
      if (L.staged) {
        const unsigned char* buf = tiles + (k & 1) * F * L.row_bytes;
        cur = walk(cur, hi, lo, last_row, A, fp, pos, [&](int t) {
          return reinterpret_cast<const signed char*>(
              buf + (t - lo) * L.row_bytes + (((size_t)t * stride + base) & (CHUNK - 1)));
        });
      } else {
        cur = walk(cur, hi, lo, last_row, A, fp, pos,
                   [&](int t) { return jumps + (size_t)t * stride + base; });
      }
    }
    __syncwarp();  // the tile's positions are visible
    const int top = min(hi, T - 1);
#pragma unroll 4
    for (int t = lo + lane; t <= top; t += 32) states[(size_t)b * T + t] = tbl[pos[t - lo]];
    __syncwarp();  // the positions and tile k's rows are free again
  }
}

}  // namespace

// frames a tile of kernel G's launch for A positions, or 0 where the rows
// are walked from device memory
extern "C" int sr_align_backtrack_tile(int A) {
  const Layout L = layout_for(A);
  return L.staged ? L.frames : 0;
}

// jumps must start on a 16-byte boundary (the copies read whole aligned
// chunks; the wrapper passes a fresh tensor where it does not)
extern "C" int sr_align_backtrack(const float* final_hi, const int* aut_len,
                                  const signed char* jumps, const int* feat_len,
                                  const int* states_tbl, int* states, int* final_pos, int B,
                                  int A, int Tp, int T, int tie_pruned, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(jumps) % CHUNK != 0) return (int)cudaErrorMisalignedAddress;
  const Layout L = layout_for(A);
  const size_t smem = (size_t)L.utts * L.warp_bytes;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(align_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  align_backtrack_kernel<<<(B + L.utts - 1) / L.utts, L.utts * 32, smem, (cudaStream_t)stream>>>(
      final_hi, aut_len, jumps, feat_len, states_tbl, states, final_pos, B, A, Tp, T, tie_pruned,
      L);
  return (int)cudaGetLastError();
}
