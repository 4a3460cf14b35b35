// Kernel A: diagonal-Mahalanobis GMM density scores.
//
//   out[n, j] = sum_i (x[n, i] - mu[j, i])^2 * a[j, i]  +  c[j]
//
// with a = 1/(2 sigma^2) and c = norm - log w (inactive density slots carry
// a = 0 and c = 5e17). Replaces the Pallas kernel of
// speechrecognition_tpu/ops/mahalanobis.py (_kernel, _call_kernel and the
// mahalanobis_scores wrapper) and computes the same function on row-major
// inputs: x [N, dim], mu and a [J, dim], c [J], out [N, J], all float32.
// There is no host-side transposition or padding to tile multiples; the
// kernel masks the ragged edges itself.
//
// What bounds it: per output element it does 3 * dim FP32 operations and
// stores 4 bytes. At the recognition path's shapes (N = 32768 frames per
// scoring chunk, J = 1696 density slots, dim = 25) that is about the same
// time on the FP32 pipe as on the N*J*4-byte store, so the kernel is bound
// about equally by both; this simple version sits well below that bound
// because its shared-memory loads take issue slots from the FP32 math
// (PERF.md has the measured rate). The centered form is not a matrix product (it is
// what keeps f32 accurate to ~1e-6 where the [x^2, x, 1] expansion loses
// ~1e-4 to cancellation), so tensor cores do not apply. Fusing the
// per-mixture minimum over the D densities, so that [N, J] never reaches
// device memory, is later work: this kernel computes exactly what the
// reference's mahalanobis_scores computes, so the tests compare like with
// like.
//
// Design: a 2-D grid of 64-frame x 64-density tiles, 256 threads each. The
// x, mu and a tiles are staged in shared memory as [dim][64] (19.2 KB at
// dim = 25), and each thread accumulates a 4 x 4 register micro-tile over
// i = 0 .. dim-1 in ascending order, the order of the Pallas fori_loop.
// Threads with neighbouring threadIdx.x own neighbouring density columns, so
// the output store is coalesced. nvcc contracts acc + d*d*a into an FMA,
// which is why the kernel agrees with its plain version to a tolerance
// (~1e-7 relative) and not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 64;
constexpr int TILE_J = 64;
constexpr int THREADS_X = 16;  // along densities
constexpr int THREADS_Y = 16;  // along frames
constexpr int MICRO_N = TILE_N / THREADS_Y;
constexpr int MICRO_J = TILE_J / THREADS_X;
constexpr int THREADS = THREADS_X * THREADS_Y;

__global__ void __launch_bounds__(THREADS)
mahalanobis_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                   const float* __restrict__ a, const float* __restrict__ c,
                   float* __restrict__ out, int N, int J, int dim) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [dim][TILE_N]
  float* ms = xs + dim * TILE_N;     // [dim][TILE_J]
  float* as = ms + dim * TILE_J;     // [dim][TILE_J]

  const int n0 = blockIdx.y * TILE_N;
  const int j0 = blockIdx.x * TILE_J;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * THREADS_X + tx;

  // Stage the tiles transposed. Rows n0 .. n0+63 of a row-major [*, dim]
  // array are one contiguous run, so consecutive threads read consecutive
  // addresses. Rows past the edge are filled with zeros.
  for (int e = tid; e < TILE_N * dim; e += THREADS) {
    const int r = e / dim;
    const int i = e - r * dim;
    const int n = n0 + r;
    xs[i * TILE_N + r] = n < N ? x[(size_t)n * dim + i] : 0.f;
  }
  for (int e = tid; e < TILE_J * dim; e += THREADS) {
    const int r = e / dim;
    const int i = e - r * dim;
    const int j = j0 + r;
    const bool in = j < J;
    ms[i * TILE_J + r] = in ? mu[(size_t)j * dim + i] : 0.f;
    as[i * TILE_J + r] = in ? a[(size_t)j * dim + i] : 0.f;
  }
  __syncthreads();

  float acc[MICRO_N][MICRO_J];
#pragma unroll
  for (int r = 0; r < MICRO_N; ++r)
#pragma unroll
    for (int k = 0; k < MICRO_J; ++k) acc[r][k] = 0.f;

  for (int i = 0; i < dim; ++i) {
    float xv[MICRO_N], mv[MICRO_J], av[MICRO_J];
#pragma unroll
    for (int r = 0; r < MICRO_N; ++r) xv[r] = xs[i * TILE_N + ty + r * THREADS_Y];
#pragma unroll
    for (int k = 0; k < MICRO_J; ++k) {
      mv[k] = ms[i * TILE_J + tx + k * THREADS_X];
      av[k] = as[i * TILE_J + tx + k * THREADS_X];
    }
#pragma unroll
    for (int r = 0; r < MICRO_N; ++r)
#pragma unroll
      for (int k = 0; k < MICRO_J; ++k) {
        const float d = xv[r] - mv[k];
        acc[r][k] = acc[r][k] + d * d * av[k];
      }
  }

  // Epilogue: add c (as the reference does after its kernel) and store.
#pragma unroll
  for (int r = 0; r < MICRO_N; ++r) {
    const int n = n0 + ty + r * THREADS_Y;
    if (n >= N) continue;
#pragma unroll
    for (int k = 0; k < MICRO_J; ++k) {
      const int j = j0 + tx + k * THREADS_X;
      if (j < J) out[(size_t)n * J + j] = acc[r][k] + c[j];
    }
  }
}

}  // namespace

extern "C" int sr_mahalanobis_scores(const float* x, const float* mu,
                                     const float* a, const float* c,
                                     float* out, int N, int J, int dim,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || J == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)dim * (TILE_N + 2 * TILE_J) * sizeof(float);
  const dim3 grid((J + TILE_J - 1) / TILE_J, (N + TILE_N - 1) / TILE_N);
  const dim3 block(THREADS_X, THREADS_Y);
  mahalanobis_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, mu, a, c, out, N, J, dim);
  return (int)cudaGetLastError();
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
