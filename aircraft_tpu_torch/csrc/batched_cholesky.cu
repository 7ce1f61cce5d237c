// Batched Cholesky factor-and-solve of small SPD systems: X = A^-1 rhs for
// A (B, m, m) and rhs (B, m, k), float32, row-major, any B, m <= 16.
//
// Replaces the TPU kernel aircraft_tpu/kernels/cholesky_kernel.py::
// make_batched_cholesky_solve (pl.pallas_call at :88).  It computes that
// kernel's _cholesky_solve_rows: pivots sqrt(max(s, 1e-12)) with the max
// propagating NaN, forward substitution L y = rhs, then back substitution
// L^T x = y, column by column, and no fail flag.  A matrix that is not
// positive definite gives non-finite or meaningless X; the caller
// (solvers/riccati.py) tests the whole batch for non-finite entries and
// falls back to the reference route, as the TPU path's lax.cond does.
//
// Bound on an H100: bytes.  At m = 7, k = 15 a system moves 1036 bytes and
// does about 1.7 kFLOP, so the card's 3.35 TB/s and 67 TFLOP/s meet near
// 20 FLOP/byte and the sweep's systems sit below that line; at B = 256
// both bounds are well under a microsecond, and the launch itself is the
// cost (chip_smoke.py computes the bound from its inputs).
//
// Design: one thread per system, the factor held in registers (m is a
// template parameter, so every loop over the matrix unrolls and L stays
// out of local memory), A and rhs read straight from global memory and X
// written straight back.  No 128-lane padding: the grid covers any B.
#include <cuda_runtime.h>

#define MAX_M 16
#define THREADS 32

// NaN-propagating max, as jnp.maximum
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

template <int M>
__global__ void __launch_bounds__(THREADS)
batched_cholesky_kernel(const float* __restrict__ A, const float* __restrict__ rhs,
                        float* __restrict__ X, int B, int k) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const float* a = A + (size_t)b * M * M;
  float L[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i * M + j];
#pragma unroll
      for (int p = 0; p < j; ++p) s = s - L[i][p] * L[j][p];
      L[i][j] = (i == j) ? sqrtf(nanmax(s, 1e-12f)) : s / L[j][j];
    }
  }
  const float* r = rhs + (size_t)b * M * k;
  float* x = X + (size_t)b * M * k;
  for (int col = 0; col < k; ++col) {
    float y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = r[i * k + col];
#pragma unroll
      for (int p = 0; p < i; ++p) s = s - L[i][p] * y[p];
      y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int p = i + 1; p < M; ++p) s = s - L[p][i] * y[p];
      y[i] = s / L[i][i];   // y[p > i] already holds x[p]
      x[i * k + col] = y[i];
    }
  }
}

template <int M>
static void launch(const float* A, const float* rhs, float* X, int B, int k,
                   cudaStream_t stream) {
  batched_cholesky_kernel<M><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(A, rhs, X,
                                                                                 B, k);
}

extern "C" const char* batched_cholesky_layout() { return ""; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int batched_cholesky_launch(const float* A, const float* rhs, float* X, int B, int m,
                                       int k, void* stream) {
  if (m < 1 || m > MAX_M || k < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
#define CASE(n) \
  case n:       \
    launch<n>(A, rhs, X, B, k, s); \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return (int)cudaGetLastError();
}
