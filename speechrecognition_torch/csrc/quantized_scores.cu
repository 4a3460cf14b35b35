// Kernel O: the int8 quantized max-approximation scorer, with or without
// density preselection.
//
// Replaces speechrecognition_tpu/models/quantized.py::am_scores_q with the
// functions it fuses (quantize_features, quantized_distances, _select_mask;
// XLA fuses them around one s8 x s8 -> s32 product on the TPU's MXU). Same
// inputs and output: features x f32 [N, dim], isv f32 [dim] (scale ·
// invsqrt(var)), the quantized means, qmeans_sq and consts int32; with
// preselection the quantized centers, qcenters_sq, cluster_of and
// n_selected; it writes the scores f32 [N, S] (J = S * D).
//
// Per frame it follows the reference exactly, in integers:
//   * qx = clip(rint(x * isv), -128, 127): one rounded float multiply,
//     round half to even (jnp.round), clip; a NaN product quantizes to 0,
//     as XLA's saturating float-to-int conversion gives (fmaxf alone would
//     give -128);
//   * d[j] = xx - 2 * cross[j] + qmeans_sq[j]; total = d + consts, in
//     int32 arithmetic that wraps as the reference's does (the sums are
//     taken modulo 2^32, so their order does not matter);
//   * with preselection: cd[c] the same distance to each center; kth the
//     n_selected-th smallest cd counting duplicates (jax.lax.top_k); a
//     density whose cluster has cd > kth takes INACTIVE_INT;
//   * best = the integer minimum over a mixture's D densities; the score
//     __int2float_rn(best) / scale2x as one rounded float division; with
//     preselection best >= INACTIVE_INT reads the backoff score.
//
// Two designs; the C entry launches the tensor-core design unless it is
// asked for the first one (first_design), which takes dim <= 128 and at most
// 256 clusters and stays for timing in turns.
//
// The tensor-core design. The means are padded to D8 = D rounded up
// to 8 densities a mixture and to row_bytes bytes a row (64, 128 or a
// multiple of 256: any dim), so a mixture is D8 / 8 column tiles of the
// product and the zero bytes add nothing. A block of 256 threads (8 warps)
// takes a tile of FT = 16 * MT frames (MT = 4 for row_bytes 64 and 128, 2
// past: 64 or 32 frames), quantizes it into shared memory and sums
// xx; every warp holds the whole tile's A fragments in registers (MT m16
// tiles by KS k32 steps) and loops over its own mixtures, 16 at a time (a
// mixture's column tiles are consecutive, each tile's B fragments and
// column tables loaded two tiles ahead, one with preselection or past 128
// bytes a row):
//   * the product: mma.sync.m16n8k32.s8.s8.s32 of the frames (A, row-major)
//     and eight densities' 32-byte slices (B: the [J, K] rows are B's
//     column-major layout), one B fragment of two words a lane feeding MT
//     products; exact int32 sums. Inside each 32-byte slice a lane's two
//     A words and two B words are taken as words (2tq, 2tq + 1) instead of
//     the PTX layout's (tq, tq + 4): the same permutation of k on both
//     operands, so one 8-byte load a fragment pair and the same sums;
//   * the epilogue in registers: xx + (qmeans_sq + consts) - 2 * cross,
//     INACTIVE_INT outside the frame's selected clusters, INT_MAX for the
//     padding densities (d >= D), the minimum over the mixture's tiles in
//     a lane, then over the quad (two __shfl_xor_sync);
//   * the scores: one rounded division a score (lane tq of a quad takes the
//     m16 tiles m = tq mod 4) into a warp's staging tile [FT][16] in shared
//     memory, then written 16 mixtures a row segment.
// With preselection the block first takes its m16 tiles four at a time: a
// warp a tile's cluster distances through the same product into a [16][C]
// buffer; then each of the 8 warps 8 of the buffered frames: the k-th
// smallest of each frame by a binary search on the value (a warp's count of
// cd <= mid by __reduce_add_sync; the 8 searches side by side), and the
// selection as bits over the tile's frames a cluster (C x FT/32 words).
// Buffers and bits live in shared memory up to SEL_SMEM bytes (C up to 352;
// the buffers share their room with the staging tiles), past it in device
// scratch that the wrapper allocates (sr_quantized_scores_scratch): any C
// works, more slowly.
//
// What bounds it: the scores written, N * S * 4 bytes (65.7 MB a
// 32,768-frame launch at AN4's 501 states: 0.0196 ms at 3.35 TB/s); the
// products (2 * N * J8 * row_bytes s8 operations, about 0.03 ms at the
// tensor cores' 1,979 TOP/s) lie near it. What holds it above them is the
// issue of the epilogue, three integer operations an element (six with
// preselection) over N * J8 elements, and of the quad folds and divisions,
// by 16 warps an SM (two blocks: 128 to 150 registers a thread).
//
// The first design: a block of 128 threads a tile of FT = 32 frames,
// an instance a frame width of DIM4 = 4, 12 or 32 words (dim <= 16, 48 or
// 128). The tile is quantized into shared memory (4 int8 a word); with
// preselection each warp takes frames in turn, a lane 8 clusters (C <= 256):
// the distances in registers, kth by the same binary search, the selection
// as 8 ballots into a 256-bit mask a frame. Then a thread a mixture
// (looping over S): for each density its DIM4 words in registers, for each
// frame of the tile DIM4 __dp4a against the frame's words (a broadcast from
// shared memory), the minimum in FT registers; one coalesced row of scores
// a frame at the end. Bound by the issue of the __dp4a products.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int FT = 32;             // frames a tile (first design)
constexpr int MAX_C = 256;         // clusters: 8 a lane (first design)
constexpr int C_PER_LANE = MAX_C / 32;
constexpr int INACTIVE = 1 << 30;  // INACTIVE_INT
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int quantize(float x, float isv) {
  float q = rintf(__fmul_rn(x, isv));
  if (isnan(q)) return 0;
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int)q;
}

template <int DIM4, bool PRESELECT>
__global__ void __launch_bounds__(THREADS) quantized_scores_kernel(
    const float* __restrict__ x, const float* __restrict__ isv, const int* __restrict__ qmeans,
    const int* __restrict__ qmeans_sq, const int* __restrict__ consts,
    const int* __restrict__ qcenters, const int* __restrict__ qcenters_sq,
    const int* __restrict__ cluster_of, float* __restrict__ out, int N, int S, int D, int dim,
    int C, int n_selected, float scale2x, float backoff) {
  __shared__ int s_x[FT][DIM4];
  __shared__ int s_xx[FT];
  __shared__ unsigned s_sel[FT][C_PER_LANE];
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, N - f0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. the tile's quantized frames, 4 bytes a word (zeros past dim and nf)
  for (int e = threadIdx.x; e < FT * DIM4; e += THREADS) {
    const int f = e / DIM4, k = e - f * DIM4;
    unsigned packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * k + q;
      const int v = f < nf && i < dim ? quantize(x[(size_t)(f0 + f) * dim + i], isv[i]) : 0;
      packed |= (unsigned)(v & 0xff) << (8 * q);
    }
    s_x[f][k] = (int)packed;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < FT; f += THREADS) {
    int xx = 0;
#pragma unroll
    for (int k = 0; k < DIM4; ++k) xx = __dp4a(s_x[f][k], s_x[f][k], xx);
    s_xx[f] = xx;
  }
  __syncthreads();

  // 2. the selected clusters of each frame: a warp a frame, a lane 8 clusters
  if (PRESELECT) {
    for (int f = warp; f < FT; f += THREADS / 32) {
      int cd[C_PER_LANE];
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < C_PER_LANE; ++j) {
        const int c = lane + 32 * j;
        cd[j] = INT_MAX;
        if (c < C) {
          int cross = 0;
#pragma unroll
          for (int k = 0; k < DIM4; ++k) cross = __dp4a(s_x[f][k], __ldg(qcenters + c * DIM4 + k), cross);
          cd[j] = s_xx[f] - 2 * cross + qcenters_sq[c];
          lo = min(lo, cd[j]);
          hi = max(hi, cd[j]);
        }
      }
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      // the least value with at least n_selected distances at or below it
      while (lo < hi) {
        const int mid = (int)(((long long)lo + (long long)hi) >> 1);
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < C_PER_LANE; ++j) cnt += lane + 32 * j < C && cd[j] <= mid;
        cnt = __reduce_add_sync(FULL, cnt);
        if (cnt >= n_selected)
          hi = mid;
        else
          lo = mid + 1;
      }
#pragma unroll
      for (int j = 0; j < C_PER_LANE; ++j) {
        const unsigned bits = __ballot_sync(FULL, lane + 32 * j < C && cd[j] <= lo);
        if (lane == 0) s_sel[f][j] = bits;
      }
    }
    __syncthreads();
  }

  // 3. a thread a mixture: the integer minimum over its densities for every
  // frame of the tile, then one division a score
  for (int s = threadIdx.x; s < S; s += THREADS) {
    int best[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) best[f] = INT_MAX;
    for (int d = 0; d < D; ++d) {
      const int j = s * D + d;
      int qm[DIM4];
#pragma unroll
      for (int k = 0; k < DIM4; ++k) qm[k] = __ldg(qmeans + (size_t)j * DIM4 + k);
      const int base = qmeans_sq[j];
      const int cst = consts[j];
      const int cl = PRESELECT ? cluster_of[j] : 0;
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        int cross = 0;
#pragma unroll
        for (int k = 0; k < DIM4; ++k) cross = __dp4a(s_x[f][k], qm[k], cross);
        int total = s_xx[f] - 2 * cross + base + cst;
        if (PRESELECT && !((s_sel[f][cl >> 5] >> (cl & 31)) & 1u)) total = INACTIVE;
        best[f] = min(best[f], total);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f < nf) {
        float v = __fdiv_rn(__int2float_rn(best[f]), scale2x);
        if (PRESELECT && best[f] >= INACTIVE) v = backoff;
        out[(size_t)(f0 + f) * S + s] = v;
      }
    }
  }
}

template <int DIM4>
cudaError_t launch_dim(bool preselect, const float* x, const float* isv, const int* qmeans,
                       const int* qmeans_sq, const int* consts, const int* qcenters,
                       const int* qcenters_sq, const int* cluster_of, float* out, int N, int S,
                       int D, int dim, int C, int n_selected, float scale2x, float backoff,
                       cudaStream_t stream) {
  const int blocks = (N + FT - 1) / FT;
  if (preselect)
    quantized_scores_kernel<DIM4, true><<<blocks, THREADS, 0, stream>>>(
        x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, D,
        dim, C, n_selected, scale2x, backoff);
  else
    quantized_scores_kernel<DIM4, false><<<blocks, THREADS, 0, stream>>>(
        x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, D,
        dim, C, n_selected, scale2x, backoff);
  return cudaGetLastError();
}


// -- the tensor-core design ---------------------------------------------------------

constexpr int WARPS = 8;             // warps a block of the tensor-core design
constexpr int MMA_THREADS = WARPS * 32;
constexpr int PRE_WARPS = 4;         // distance buffers of the selection (m16 tiles a round)
constexpr int MS = 16;               // mixtures a warp's staging tile
constexpr int STAGE_LD = MS + 1;     // its row stride (no bank conflicts)
// the preselection's buffer and bits stay in shared memory up to this size
constexpr size_t SEL_SMEM = 96 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// where a block's state lives: the quantized tile (row_bytes + 16 bytes a
// frame), xx, the staging tiles and, with preselection, the selection bits
// [C][FT / 32] and the warps' [16][cstride] distance buffers (in shared
// memory, the buffers sharing the staging tiles' room, or in scratch)
struct OLayout {
  size_t qx, xx, stage, sel, cd, smem, scratch_per_block;
  int cstride, qs;
  bool sel_in_smem;
};

__host__ __device__ inline int mt_of(int row_bytes) {
  return row_bytes <= 128 ? 4 : 2;
}

inline OLayout o_layout(int row_bytes, int C, bool preselect) {
  const int ft = 16 * mt_of(row_bytes);
  OLayout L{};
  L.qs = row_bytes / 4 + 4;
  size_t o = 0;
  L.qx = o;
  o += align16((size_t)ft * L.qs * 4);
  L.xx = o;
  o += align16((size_t)ft * 4);
  const size_t stage = (size_t)WARPS * ft * STAGE_LD * 4;
  L.cstride = preselect ? (C + 31) / 32 * 32 + 4 : 0;
  const size_t sel = preselect ? align16((size_t)C * (ft / 32) * 4) : 0;
  const size_t cd = preselect ? (size_t)PRE_WARPS * 16 * L.cstride * 4 : 0;
  L.sel_in_smem = sel + cd <= SEL_SMEM;
  if (preselect && L.sel_in_smem) {
    L.sel = o;
    o += sel;
    L.cd = L.stage = o;
    o += align16(stage > cd ? stage : cd);
    L.scratch_per_block = 0;
  } else {
    L.stage = o;
    o += align16(stage);
    L.sel = 0;
    L.cd = sel;
    L.scratch_per_block = preselect ? align16(sel + cd) : 0;
  }
  L.smem = o;
  return L;
}

// d += a · b on the tensor cores: a 16 x 32 s8 tile (row-major) by a 32 x 8
// s8 tile (column-major), int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const int2& a_lo, const int2& a_hi,
                                       const int2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x), "r"(b.y));
}

// the A fragments of m16 tile m, k32 steps [kc * KS, kc * KS + KS): per step
// the words (2tq, 2tq + 1) of rows g and g + 8
template <int KS>
__device__ __forceinline__ void load_a(int2 (&lo)[KS], int2 (&hi)[KS], const int* s_qx, int qs,
                                       int m, int kc, int g, int tq) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int w = (kc * KS + ks) * 8 + 2 * tq;
    lo[ks] = *reinterpret_cast<const int2*>(s_qx + (m * 16 + g) * qs + w);
    hi[ks] = *reinterpret_cast<const int2*>(s_qx + (m * 16 + 8 + g) * qs + w);
  }
}

// the B fragment of the eight rows [r0, r0 + 8) of a [*, rw] word table at
// k32 step k: the words (2tq, 2tq + 1) of row r0 + g
__device__ __forceinline__ int2 load_b(const int* table, int rw, int r0, int k, int g, int tq) {
  return __ldg(reinterpret_cast<const int2*>(table + (size_t)(r0 + g) * rw + k * 8 + 2 * tq));
}

// xx + base - 2 * cross modulo 2^32, as the reference's int32 sums wrap
__device__ __forceinline__ int total_of(int xx, unsigned base, int cross) {
  return (int)((unsigned)xx + base - 2u * (unsigned)cross);
}

template <int KS, int MT, bool PRESELECT, bool MASKD>
__global__ void __launch_bounds__(MMA_THREADS) quantized_mma_kernel(
    const float* __restrict__ x, const float* __restrict__ isv, const int* __restrict__ qmeans,
    const int* __restrict__ qmeans_sq, const int* __restrict__ consts,
    const int* __restrict__ qcenters, const int* __restrict__ qcenters_sq,
    const int* __restrict__ cluster_of, float* __restrict__ out, unsigned char* scratch,
    OLayout L, int N, int S, int D, int dim, int row_bytes, int C, int n_selected,
    float scale2x, float backoff) {
  constexpr int FTM = 16 * MT;      // frames a tile
  constexpr int SELW = FTM / 32;    // selection words a cluster
  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = row_bytes / 4;     // words a row
  const int nkc = row_bytes / (32 * KS);
  const int qs = L.qs;
  const int D8 = (D + 7) / 8 * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int f0 = blockIdx.x * FTM;
  const int nf = min(FTM, N - f0);
  int* s_qx = reinterpret_cast<int*>(smem + L.qx);
  int* s_xx = reinterpret_cast<int*>(smem + L.xx);
  float* s_stage = reinterpret_cast<float*>(smem + L.stage) + warp * FTM * STAGE_LD;
  unsigned char* selbase =
      L.sel_in_smem ? smem : scratch + (size_t)blockIdx.x * L.scratch_per_block;
  unsigned* s_sel = reinterpret_cast<unsigned*>(selbase + L.sel);

  // 1. the tile's quantized frames, 4 bytes a word (zeros past dim and nf)
  for (int e = threadIdx.x; e < FTM * rw; e += MMA_THREADS) {
    const int f = e / rw, k = e - f * rw;
    unsigned packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * k + q;
      const int v = f < nf && i < dim ? quantize(x[(size_t)(f0 + f) * dim + i], isv[i]) : 0;
      packed |= (unsigned)(v & 0xff) << (8 * q);
    }
    s_qx[f * qs + k] = (int)packed;
  }
  if (PRESELECT)
    for (int e = threadIdx.x; e < C * SELW; e += MMA_THREADS) s_sel[e] = 0u;
  __syncthreads();
  for (int f = threadIdx.x; f < FTM; f += MMA_THREADS) {
    int xx = 0;
    for (int k = 0; k < rw; ++k) xx = __dp4a(s_qx[f * qs + k], s_qx[f * qs + k], xx);
    s_xx[f] = xx;
  }
  __syncthreads();

  // 2. the selected clusters, PRE_WARPS m16 tiles a round: a warp a tile's
  // cluster distances into its [16][cstride] buffer; then every warp takes
  // 16 * PRE_WARPS / WARPS of the buffered frames: the k-th smallest of a
  // frame by the binary search, then the frames' bits a cluster
  if (PRESELECT) {
    const int ctiles = (C + 7) / 8;
    constexpr int ROWS = 16 * PRE_WARPS / WARPS;   // frames a warp searches a round
    for (int m0 = 0; m0 < MT; m0 += PRE_WARPS) {
      const int m = m0 + warp;
      if (warp < PRE_WARPS && m < MT) {
        int* s_cd = reinterpret_cast<int*>(selbase + L.cd) + warp * 16 * L.cstride;
        const int xlo = s_xx[m * 16 + g], xhi = s_xx[m * 16 + 8 + g];
        int2 alo[KS], ahi[KS];
        if (nkc == 1) load_a<KS>(alo, ahi, s_qx, qs, m, 0, g, tq);
        for (int ct = 0; ct < ctiles; ++ct) {
          int acc[4] = {0, 0, 0, 0};
          for (int kc = 0; kc < nkc; ++kc) {
            if (nkc > 1) load_a<KS>(alo, ahi, s_qx, qs, m, kc, g, tq);
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              mma_s8(acc, alo[ks], ahi[ks], load_b(qcenters, rw, ct * 8, kc * KS + ks, g, tq));
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = ct * 8 + 2 * tq + i;
            if (c < C) {
              const unsigned csq = (unsigned)__ldg(qcenters_sq + c);
              s_cd[g * L.cstride + c] = total_of(xlo, csq, acc[i]);
              s_cd[(g + 8) * L.cstride + c] = total_of(xhi, csq, acc[2 + i]);
            }
          }
        }
      }
      __syncthreads();  // the round's distances are buffered
      // this warp's frames: buffer warp / (WARPS / PRE_WARPS), rows r0 + [0, ROWS)
      const int buf = warp / (WARPS / PRE_WARPS), r0 = (warp % (WARPS / PRE_WARPS)) * ROWS;
      const int mb = m0 + buf;
      if (mb < MT) {
        const int* s_cd = reinterpret_cast<const int*>(selbase + L.cd) + buf * 16 * L.cstride;
        // the ROWS searches side by side: the least value with at least
        // n_selected distances at or below it, each row
        int lo[ROWS], hi[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int* row = s_cd + (r0 + r) * L.cstride;
          lo[r] = INT_MAX;
          hi[r] = INT_MIN;
          for (int c = lane; c < C; c += 32) {
            lo[r] = min(lo[r], row[c]);
            hi[r] = max(hi[r], row[c]);
          }
          lo[r] = __reduce_min_sync(FULL, lo[r]);
          hi[r] = __reduce_max_sync(FULL, hi[r]);
        }
        for (;;) {
          bool open = false;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) open |= lo[r] < hi[r];
          if (!open) break;
          int mid[ROWS], cnt[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            mid[r] = (int)(((long long)lo[r] + (long long)hi[r]) >> 1);
            cnt[r] = 0;
          }
          for (int c = lane; c < C; c += 32) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) cnt[r] += s_cd[(r0 + r) * L.cstride + c] <= mid[r];
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (lo[r] < hi[r]) {
              if (__reduce_add_sync(FULL, cnt[r]) >= n_selected)
                hi[r] = mid[r];
              else
                lo[r] = mid[r] + 1;
            }
          }
        }
        for (int c = lane; c < C; c += 32) {
          unsigned bits = 0;
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            bits |= (unsigned)(s_cd[(r0 + r) * L.cstride + c] <= lo[r]) << r;
          atomicOr(s_sel + c * SELW + (mb >> 1), bits << ((mb & 1) * 16 + r0));
        }
      }
      __syncthreads();  // the buffers are free again (and, last, the bits complete)
    }
  }

  // 3. a warp 16 mixtures at a time: the products, the epilogue, the quad's
  // minimum, the scores into the staging tile, then its rows
  int2 alo[MT][KS], ahi[MT][KS];
  int xr[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (nkc == 1) load_a<KS>(alo[m], ahi[m], s_qx, qs, m, 0, g, tq);
    xr[m][0] = s_xx[m * 16 + g];
    xr[m][1] = s_xx[m * 16 + 8 + g];
  }
  const int ntiles = D8 / 8;
  // a chunk's column tiles are consecutive: tile u's densities are
  // s0 * D8 + 8u + [0, 8). Each tile's B fragments (one k32 chunk a row:
  // nkc == 1) and column tables are loaded AHEAD tiles ahead: two for rows
  // of up to 128 bytes without preselection, one where wider fragments or
  // the selection words fill the registers
  constexpr int AHEAD = KS <= 4 && !PRESELECT ? 2 : 1;
  struct TileIn {
    int2 b[KS];
    unsigned base[2];
    int cl[2];
  };
  auto fetch = [&](int j0, TileIn& x) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) x.b[ks] = load_b(qmeans, rw, j0, ks, g, tq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 2 * tq + i;
      x.base[i] = (unsigned)__ldg(qmeans_sq + j) + (unsigned)__ldg(consts + j);
      x.cl[i] = PRESELECT ? __ldg(cluster_of + j) : 0;
    }
  };
  for (int s0 = warp * MS; s0 < S; s0 += WARPS * MS) {
    const int ns = min(MS, S - s0);
    const int nu = ns * ntiles;
    TileIn t1, t2;
    fetch(s0 * D8, t1);
    if (AHEAD == 2 && nu > 1) fetch(s0 * D8 + 8, t2);
    int rmin[MT][2];
    for (int u = 0; u < nu; ++u) {
      const int sc = u / ntiles, nt = u - sc * ntiles;
      const int j0 = s0 * D8 + 8 * u;
      if (nt == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m) rmin[m][0] = rmin[m][1] = INT_MAX;
      }
      const TileIn cur = t1;
      if (AHEAD == 2) {
        t1 = t2;
        if (u + 2 < nu) fetch(j0 + 16, t2);
      } else if (u + 1 < nu) {
        fetch(j0 + 8, t1);
      }
      int acc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
      if (nkc == 1) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_s8(acc[m], alo[m][ks], ahi[m][ks], cur.b[ks]);
      } else {
        for (int kc = 0; kc < nkc; ++kc) {
#pragma unroll
          for (int m = 0; m < MT; ++m) load_a<KS>(alo[m], ahi[m], s_qx, qs, m, kc, g, tq);
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int2 bb = load_b(qmeans, rw, j0, kc * KS + ks, g, tq);
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_s8(acc[m], alo[m][ks], ahi[m][ks], bb);
          }
        }
      }
      // this lane's two columns (densities j0 + 2tq, + 1)
      bool valid[2];
      unsigned sw[2][SELW];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        valid[i] = !MASKD || nt * 8 + 2 * tq + i < D;
        if (PRESELECT) {
#pragma unroll
          for (int w = 0; w < SELW; ++w) sw[i][w] = s_sel[cur.cl[i] * SELW + w] >> g;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            int t = total_of(xr[m][h], cur.base[i], acc[m][2 * h + i]);
            if (PRESELECT && !((sw[i][m >> 1] >> ((m & 1) * 16 + 8 * h)) & 1u)) t = INACTIVE;
            if (MASKD && !valid[i]) t = INT_MAX;
            rmin[m][h] = min(rmin[m][h], t);
          }
      if (nt < ntiles - 1) continue;
      // the mixture's last tile: the quad's minimum; lane tq scores the m16
      // tiles m = tq (mod 4)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v = rmin[m][h];
          v = min(v, __shfl_xor_sync(FULL, v, 1));
          rmin[m][h] = min(v, __shfl_xor_sync(FULL, v, 2));
        }
#pragma unroll
      for (int k = 0; k < (MT + 3) / 4; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v = rmin[4 * k][h];
#pragma unroll
          for (int q = 1; q < 4; ++q)
            if (4 * k + q < MT && tq == q) v = rmin[4 * k + q][h];
          const int m = 4 * k + tq;
          if (m < MT) {
            float score = __fdiv_rn(__int2float_rn(v), scale2x);
            if (PRESELECT && v >= INACTIVE) score = backoff;
            s_stage[(m * 16 + 8 * h + g) * STAGE_LD + sc] = score;
          }
        }
    }
    __syncwarp();
    for (int e = lane; e < FTM * MS; e += 32) {
      const int r = e / MS, c = e - r * MS;
      if (r < nf && c < ns) out[(size_t)(f0 + r) * S + s0 + c] = s_stage[r * STAGE_LD + c];
    }
    __syncwarp();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KS, int MT, bool PRESELECT, bool MASKD>
cudaError_t launch_mma(const OLayout& L, const float* x, const float* isv, const int* qmeans,
                       const int* qmeans_sq, const int* consts, const int* qcenters,
                       const int* qcenters_sq, const int* cluster_of, float* out,
                       unsigned char* scratch, int N, int S, int D, int dim, int row_bytes, int C,
                       int n_selected, float scale2x, float backoff, cudaStream_t stream) {
  auto kernel = quantized_mma_kernel<KS, MT, PRESELECT, MASKD>;
  cudaError_t err = allow_smem(kernel, L.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(N + 16 * MT - 1) / (16 * MT), MMA_THREADS, L.smem, stream>>>(
      x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, scratch, L, N,
      S, D, dim, row_bytes, C, n_selected, scale2x, backoff);
  return cudaGetLastError();
}

template <int KS, int MT, bool PRESELECT, bool MASKD>
int residency_mma(const OLayout& L) {
  auto kernel = quantized_mma_kernel<KS, MT, PRESELECT, MASKD>;
  int n = 0;
  cudaError_t err = allow_smem(kernel, L.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, MMA_THREADS, L.smem);
  return err == cudaSuccess ? n : -1;
}

// the tensor-core instance of a row width, with and without preselection and
// a D that is not a multiple of 8: (k32 steps a chunk, m16 tiles a block)
#define SR_O_DISPATCH(FN, RB, PRE, MASK, ...)                                         \
  ((RB) == 64    ? ((PRE) ? ((MASK) ? FN<2, 4, true, true>(__VA_ARGS__)              \
                                    : FN<2, 4, true, false>(__VA_ARGS__))            \
                          : ((MASK) ? FN<2, 4, false, true>(__VA_ARGS__)             \
                                    : FN<2, 4, false, false>(__VA_ARGS__)))          \
   : (RB) == 128 ? ((PRE) ? ((MASK) ? FN<4, 4, true, true>(__VA_ARGS__)              \
                                    : FN<4, 4, true, false>(__VA_ARGS__))            \
                          : ((MASK) ? FN<4, 4, false, true>(__VA_ARGS__)             \
                                    : FN<4, 4, false, false>(__VA_ARGS__)))          \
                 : ((PRE) ? ((MASK) ? FN<8, 2, true, true>(__VA_ARGS__)              \
                                    : FN<8, 2, true, false>(__VA_ARGS__))            \
                          : ((MASK) ? FN<8, 2, false, true>(__VA_ARGS__)             \
                                    : FN<8, 2, false, false>(__VA_ARGS__))))

// a row width the tensor-core design takes: 64, 128 or a multiple of 256
// bytes, at least dim
inline bool row_bytes_ok(int row_bytes, int dim) {
  return row_bytes >= dim && (row_bytes == 64 || row_bytes == 128 ||
                              (row_bytes > 0 && row_bytes % 256 == 0));
}

}  // namespace

// frames a block of the tensor-core design takes at that row width (0: a
// width it does not take)
extern "C" int sr_quantized_scores_tile(int row_bytes) {
  return row_bytes_ok(row_bytes, 1) ? 16 * mt_of(row_bytes) : 0;
}

// bytes of device scratch a block of the tensor-core design needs with C
// clusters (0: none, the selection stays in shared memory; -1: too large)
extern "C" int sr_quantized_scores_scratch(int row_bytes, int C) {
  if (C <= 0 || !row_bytes_ok(row_bytes, 1)) return 0;
  const size_t n = o_layout(row_bytes, C, true).scratch_per_block;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// first_design 0: the tensor-core design. x f32 [N, dim]; qmeans [S * D8,
// row_bytes] int8 (D8: D rounded up to 8; the padding densities' rows zero,
// their qmeans_sq, consts and cluster_of 0), qcenters [C8, row_bytes] (C8: C
// rounded up to 8, zero rows) and qcenters_sq [C8], read as int32 words;
// scratch of sr_quantized_scores_scratch bytes a block where that is not 0
// (ceil(N / sr_quantized_scores_tile) blocks).
// first_design 1: the first design. qmeans [J, row_bytes / 4] int32 words
// and qcenters [C, row_bytes / 4] (row_bytes 16, 48 or 128, C <= 256),
// qmeans_sq, consts and cluster_of [J]; no scratch.
// Without preselection qcenters, qcenters_sq and cluster_of are NULL (C == 0);
// out f32 [N, S]. The scores of a mixture with no selected density are
// backoff.
extern "C" int sr_quantized_scores(int first_design, const float* x, const float* isv,
                                   const int* qmeans, const int* qmeans_sq, const int* consts,
                                   const int* qcenters, const int* qcenters_sq,
                                   const int* cluster_of, float* out, void* scratch, int N,
                                   int S, int D, int dim, int row_bytes, int C, int n_selected,
                                   float scale2x, float backoff, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || S == 0) return (int)cudaSuccess;
  const bool preselect = C > 0;
  if (D < 1 || dim < 1 || C < 0 ||
      (preselect && (n_selected < 1 || n_selected > C || qcenters == nullptr ||
                     qcenters_sq == nullptr || cluster_of == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (first_design) {
    const int dim4 = row_bytes / 4;
    if (dim4 * 4 != row_bytes || dim4 * 4 < dim || C > MAX_C ||
        (dim4 != 4 && dim4 != 12 && dim4 != 32))
      return (int)cudaErrorInvalidValue;
#define SR_O_ARGS                                                                            \
  preselect, x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, \
      D, dim, C, n_selected, scale2x, backoff, st
    switch (dim4) {
      case 4: err = launch_dim<4>(SR_O_ARGS); break;
      case 12: err = launch_dim<12>(SR_O_ARGS); break;
      default: err = launch_dim<32>(SR_O_ARGS); break;
    }
#undef SR_O_ARGS
    return (int)err;
  }
  if (!row_bytes_ok(row_bytes, dim)) return (int)cudaErrorInvalidValue;
  const OLayout L = o_layout(row_bytes, C, preselect);
  if (L.smem > MAX_SMEM || (L.scratch_per_block && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  err = SR_O_DISPATCH(launch_mma, row_bytes, preselect, D % 8 != 0, L, x, isv, qmeans,
                      qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out,
                      static_cast<unsigned char*>(scratch), N, S, D, dim, row_bytes, C,
                      n_selected, scale2x, backoff, st);
  return (int)err;
}

// blocks one SM holds of kernel O's launch (first_design 0: the tensor-core
// design at that row width, clusters and D; 1: the first design), or -1
extern "C" int sr_quantized_scores_residency(int row_bytes, int C, int D, int first_design) {
  const bool preselect = C > 0;
  if (first_design) {
    int n = 0;
    cudaError_t err;
    const int dim4 = row_bytes / 4;
#define SR_O_OCC(W)                                                                     \
  (preselect ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                           \
                   &n, quantized_scores_kernel<W, true>, THREADS, 0)                    \
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                           \
                   &n, quantized_scores_kernel<W, false>, THREADS, 0))
    err = dim4 == 4 ? SR_O_OCC(4) : dim4 == 12 ? SR_O_OCC(12) : SR_O_OCC(32);
#undef SR_O_OCC
    return err == cudaSuccess ? n : -1;
  }
  if (!row_bytes_ok(row_bytes, 1) || D < 1) return -1;
  const OLayout L = o_layout(row_bytes, C, preselect);
  if (L.smem > MAX_SMEM) return -1;
  return SR_O_DISPATCH(residency_mma, row_bytes, preselect, D % 8 != 0, L);
}
