// Kernel A: diagonal-Mahalanobis GMM density scores, and their per-mixture
// minimum.
//
//   score[n, j] = sum_i (x[n, i] - mu[j, i])^2 * a[j, i]  +  c[j]
//
// with a = 1/(2 sigma^2) and c = norm - log w (inactive density slots carry
// a = 0 and c = 5e17). Replaces the Pallas kernel of
// speechrecognition_tpu/ops/mahalanobis.py (_kernel, _call_kernel and the
// mahalanobis_scores wrapper). Two entry points share one kernel, whose
// routine term() keeps the Pallas body's expression and order (acc = 0; for
// i ascending: acc = acc + d*d*a[i], d = x[i] - mu[i]; then + c):
//
//   * sr_mahalanobis_scores: every score, out [N, J], the Pallas call's
//     function (the sum-mode mixture scores and density_scores read it);
//   * sr_mahalanobis_min: for each frame n and mixture s the minimum over the
//     slots j = s*D + d, d < D, capped at MIN_SCORE_INIT = 1e10, out [N, S].
//     This is the Pallas call followed by the max-approximation's density
//     minimum (speechrecognition_tpu/models/gmm.py::mixture_scores_from_density,
//     scores_sd.min(axis=-1) and the cap), and the [N, J] scores never reach
//     device memory.
//
// Inputs are row-major float32: x [N, dim], mu and a [J, dim], c [J]; any dim
// up to 128 (the Pallas wrapper's lane limit). The kernel masks the ragged
// edges itself.
//
// The arithmetic: each term is d = x - mu, then d*d, then one FMA of that
// product with a onto acc, written with round-to-nearest intrinsics. That is
// the contraction nvcc makes of the plain expression; writing it out makes
// every instance (dim == 25 or generic, fused or not) round alike, so the
// fused entry is bit-equal to the minimum of the unfused one. Against the
// plain PyTorch version, which rounds the product and the add separately,
// the scores agree to ~1e-7 relative.
//
// What bounds it: the FP32 pipe. A (frame, slot) pair costs 3 FP32
// instructions per dimension (sub, mul, FMA), then the add of c and, fused,
// one minimum; at N = 32768 frames, J = 1696 slots and dim = 25 that is
// 4.2e9 instructions, about 0.128 ms at 132 SMs x 128 lanes x 1.98 GHz. The
// unfused entry also stores the 222 MB of [N, J] scores (0.066 ms at 3.35
// TB/s). The first design of this kernel (a 4 x 4 micro-tile per thread)
// loaded 12 scalars from shared memory for 48 FP32 instructions, and those
// non-broadcast loads took a large share of the issue slots. This design
// reaches about half the issue limit (PERF.md has the measured times).
//
// Design: lanes run along frames and every lane of a warp reads the same
// table element, so a table load is a broadcast. A block has TY = 2 groups
// of TX = 128 threads (4 warps each); each group owns one run of slots (a
// mixture's D slots, fused; GROUP = 16 consecutive slots, unfused) and stages
// its rows of mu and a in shared memory, at most STAGE = 16 rows at a time
// (a mixture of more densities takes several rounds), rows padded to a
// multiple of 4 floats. The block's frames are one contiguous run of x, staged in shared
// memory with coalesced loads and an odd row stride (no bank conflicts).
// For dim == 25, the SieTill dim, each thread then keeps F = 4 frames'
// features in registers (the feature loop fully unrolled) and reads the
// table as 16-byte loads: 14 LDS.128 per slot serve 4 x 25 x 3 = 300 FP32
// instructions. F = 4 was faster than 2 and 3 in a trial on the card (128
// registers, one spilled). Any other dim takes the
// generic instance: one frame a thread, read from shared memory, scalar
// broadcast table loads. The fused entry keeps the running minimum of the D
// slots in a register across the rounds and stores one value per (frame,
// mixture). The unfused entry stages its scores in shared memory and stores
// each frame's 32 slots as one 128-byte row. Frames lie along grid.x, slot
// groups along grid.y; shared memory is sized from dim (not D), above 48 KB
// through cudaFuncSetAttribute; at dim 128 it is about 116 KB.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 128;      // threads along frames
constexpr int TY = 2;        // slot groups per block (threadIdx.y)
constexpr int THREADS = TX * TY;
constexpr int GROUP = 16;    // slots per group of the unfused entry
constexpr int STAGE = 16;    // slots a group stages in shared memory at a time
constexpr int FRAMES = 4;    // frames a thread holds in registers (dim == 25)
constexpr float MIN_SCORE_INIT = 1e10f;  // Mixtures.cpp:699, exact in float32

// one term of the sum: acc + (x - mu)^2 * a, the square rounded, then one FMA
__device__ __forceinline__ float term(float acc, float x, float mu, float a) {
  const float d = __fsub_rn(x, mu);
  return __fmaf_rn(__fmul_rn(d, d), a, acc);
}

__device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// DIM: the feature dim, or 0 for any (dim_arg); F: frames per thread; FUSED:
// the minimum over each group's G slots, capped, one value per (frame,
// group), else every score (G = STAGE). J = S * G when FUSED.
template <int DIM, int F, bool FUSED>
__global__ void __launch_bounds__(THREADS, 2)
mahalanobis_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ a, const float* __restrict__ c,
                   float* __restrict__ out, int N, int J, int G, int dim_arg) {
  const int dim = DIM > 0 ? DIM : dim_arg;
  const int dimp = round4(dim);
  const int gs = min(G, STAGE);            // slots a group stages a round
  const int rows = TY * gs;                // slots the block stages a round
  const int xstride = dim | 1;             // odd: frame rows fall in distinct banks
  extern __shared__ float4 smem4[];
  float* s_mu = reinterpret_cast<float*>(smem4);   // [rows][dimp]
  float* s_a = s_mu + rows * dimp;                 // [rows][dimp]
  float* s_c = s_a + rows * dimp;                  // [rows]
  float* s_x = s_c + round4(rows);                 // [TX * F][xstride]
  // [TX * F][rows + 1], unfused; over s_x when the frames move to registers
  float* s_out = s_x + (DIM > 0 ? 0 : TX * F * xstride);

  const int tid = threadIdx.y * TX + threadIdx.x;
  const int g0 = blockIdx.y * TY;          // the block's first group

  // the block's frames nb .. nb + TX*F - 1, one contiguous run of x, staged
  // with coalesced loads; this thread's are nb + threadIdx.x + f*TX. Frames
  // past N score frame N-1 and are not written.
  const int nb = blockIdx.x * (TX * F);
  for (int e = tid; e < TX * F * dim; e += THREADS) {
    const int r = e / dim;
    s_x[r * xstride + (e - r * dim)] = x[(size_t)min(nb + r, N - 1) * dim + (e - r * dim)];
  }
  __syncthreads();
  constexpr int XR = DIM > 0 ? DIM : 1;
  float xr[F][XR];
  if (DIM > 0) {
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int i = 0; i < XR; ++i) xr[f][i] = s_x[(threadIdx.x + f * TX) * xstride + i];
  }

  // this group's slots: (g0 + ty)*G .. + ng - 1
  const int ng = min(G, J - (g0 + threadIdx.y) * G);
  float best[F];
  for (int k0 = 0; k0 < G; k0 += gs) {
    // the previous round's rows are read (and, unfused with the frames in
    // registers, s_x is) before this round's overwrite them
    __syncthreads();
    // round row r: slot k0 + (r mod gs) of group g0 + r / gs
    for (int e = tid; e < rows * dim; e += THREADS) {
      const int r = e / dim;
      const int i = e - r * dim;
      const int k = k0 + r % gs;
      const int j = (g0 + r / gs) * G + k;
      if (k < G && j < J) {
        s_mu[r * dimp + i] = mu[(size_t)j * dim + i];
        s_a[r * dimp + i] = a[(size_t)j * dim + i];
      }
    }
    for (int r = tid; r < rows; r += THREADS) {
      const int k = k0 + r % gs;
      const int j = (g0 + r / gs) * G + k;
      if (k < G && j < J) s_c[r] = c[j];
    }
    __syncthreads();

    const int nk = min(gs, ng - k0);
    for (int d = 0; d < nk; ++d) {
      const int r = threadIdx.y * gs + d;
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
      if (DIM > 0) {
        const float4* m4 = reinterpret_cast<const float4*>(s_mu + r * dimp);
        const float4* a4 = reinterpret_cast<const float4*>(s_a + r * dimp);
#pragma unroll
        for (int q = 0; q < (XR + 3) / 4; ++q) {
          const float4 m = m4[q];
          const float4 w = a4[q];
          const float mv[4] = {m.x, m.y, m.z, m.w};
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (4 * q + k < XR) {
#pragma unroll
              for (int f = 0; f < F; ++f)
                acc[f] = term(acc[f], xr[f][min(4 * q + k, XR - 1)], mv[k], wv[k]);
            }
          }
        }
      } else {
        const float* m = s_mu + r * dimp;
        const float* w = s_a + r * dimp;
        for (int i = 0; i < dim; ++i) {
          const float mv = m[i];
          const float wv = w[i];
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc[f] = term(acc[f], s_x[(threadIdx.x + f * TX) * xstride + i], mv, wv);
        }
      }
      const float cc = s_c[r];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float score = __fadd_rn(acc[f], cc);
        if (FUSED)
          best[f] = k0 + d == 0 ? score : fminf(best[f], score);
        else
          s_out[(threadIdx.x + f * TX) * (rows + 1) + r] = score;
      }
    }
  }

  if (FUSED) {
    const int s = g0 + threadIdx.y;
    if (ng <= 0) return;
    const int S = J / G;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int n = nb + threadIdx.x + f * TX;
      if (n < N) out[(size_t)n * S + s] = fminf(best[f], MIN_SCORE_INIT);
    }
  } else {
    // each frame's run of the block's slots is one contiguous row segment
    __syncthreads();
    const int j0 = g0 * G;
    const int cols = min(rows, J - j0);
    for (int e = tid; e < TX * F * rows; e += THREADS) {
      const int r = e / rows;
      const int col = e - r * rows;
      const int n = nb + r;
      if (n < N && col < cols) out[(size_t)n * J + j0 + col] = s_out[r * (rows + 1) + col];
    }
  }
}

template <int DIM, int F, bool FUSED>
cudaError_t launch(const float* x, const float* mu, const float* a, const float* c, float* out,
                   int N, int J, int G, int dim, cudaStream_t stream) {
  const size_t rows = (size_t)TY * (G < STAGE ? G : STAGE);
  const size_t frames = (size_t)TX * F * (dim | 1);
  const size_t scores = FUSED ? 0 : (size_t)TX * F * (rows + 1);
  const size_t floats = 2 * rows * ((dim + 3) & ~3) + ((rows + 3) & ~3) +
                        (DIM > 0 ? (frames > scores ? frames : scores) : frames + scores);
  const size_t smem = floats * sizeof(float);
  // above 48 KB only after opting in (at most about 116 KB, at dim 128)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(mahalanobis_kernel<DIM, F, FUSED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (J + G - 1) / G;
  const dim3 grid((N + TX * F - 1) / (TX * F), (groups + TY - 1) / TY);
  const dim3 block(TX, TY);
  mahalanobis_kernel<DIM, F, FUSED><<<grid, block, smem, stream>>>(x, mu, a, c, out, N, J, G,
                                                                    dim);
  return cudaGetLastError();
}

}  // namespace

// dim = 25, every SieTill model's, has its own instance with the features in
// registers; any other dim up to 128 takes the generic one
extern "C" int sr_mahalanobis_scores(const float* x, const float* mu,
                                     const float* a, const float* c,
                                     float* out, int N, int J, int dim,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || J == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  err = dim == 25 ? launch<25, FRAMES, false>(x, mu, a, c, out, N, J, GROUP, dim, st)
                  : launch<0, 1, false>(x, mu, a, c, out, N, J, GROUP, dim, st);
  return (int)err;
}

extern "C" int sr_mahalanobis_min(const float* x, const float* mu,
                                  const float* a, const float* c,
                                  float* out, int N, int S, int D, int dim,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || S == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int J = S * D;
  err = dim == 25 ? launch<25, FRAMES, true>(x, mu, a, c, out, N, J, D, dim, st)
                  : launch<0, 1, true>(x, mu, a, c, out, N, J, D, dim, st);
  return (int)err;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
