// Batched Cholesky factor-and-solve of small SPD systems: X = A^-1 rhs for
// A (B, m, m) and rhs (B, m, k), float32, row-major, any B, 1 <= m <= 16,
// any k >= 1.
//
// Replaces the TPU kernel aircraft_tpu/kernels/cholesky_kernel.py::
// make_batched_cholesky_solve (pl.pallas_call at :88).  It computes that
// kernel's _cholesky_solve_rows: pivots sqrt(max(s, 1e-12)) with the max
// propagating NaN, forward substitution L y = rhs, then back substitution
// L^T x = y, column by column, and no fail flag.  A matrix that is not
// positive definite gives non-finite or meaningless X for that system
// only; the caller (solvers/riccati.py) tests the whole batch for
// non-finite entries and falls back to the reference route, as the TPU
// path's lax.cond does.
//
// Bound on an H100: bytes.  At m = 7, k = 15 a system moves 1036 bytes and
// does about 1.7 kFLOP, so the card's 3.35 TB/s and 67 TFLOP/s meet near
// 20 FLOP/byte and the sweep's systems sit below that line; at B = 256
// both bounds are well under a microsecond, and one dependent chain (the
// loads, the factor's square roots, one column's substitutions) is the
// cost (chip_smoke.py computes the bound from its inputs).
//
// Design: a group of G = 16 lanes per system and THREADS / G = 8 systems
// per block (G = 8 was measured too and lost at the sweep's B = 256:
// PERF.md).  The block first copies its systems' A matrices, and the rhs
// columns of the current chunk, into shared memory with consecutive
// threads on consecutive words (float4 where the block's span is 16-byte
// aligned), so every global load is coalesced.  Each lane of a group then
// factors its system's A redundantly from shared memory (broadcast reads)
// into registers, in the reference's order (s = a[i][j] - sum_p L[i][p]
// L[j][p], p ascending), keeping one IEEE reciprocal per pivot; lane c
// solves the chunk's columns c, c + G, ... (forward, then back
// substitution, a multiply by the pivot's reciprocal in place of each
// divide) and writes each solution over its rhs column in shared memory;
// the block copies the chunk of X out the way it came in.  m is a template
// parameter, so every loop over the matrix unrolls and L stays in
// registers.  Where k columns would not fit the block's shared memory the
// kernel walks them in chunks of `kc`, the widest that fits SMEM_BUDGET
// (the launcher computes it).
#include <cuda_runtime.h>

#include <algorithm>

#define MAX_M 16
#define THREADS 128
#define SMEM_BUDGET 49152  // bytes of shared memory per block (no opt-in needed)

constexpr int G = 16;            // lanes per system
constexpr int S = THREADS / G;   // systems per block

// NaN-propagating max, as jnp.maximum
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

// n contiguous floats from src to dst (global to shared or back) by the
// whole block; float4 where both ends are 16-byte aligned
__device__ __forceinline__ void block_copy(float* __restrict__ dst, const float* __restrict__ src,
                                           int n) {
  if ((((size_t)src | (size_t)dst) & 15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += THREADS) d4[i] = s4[i];
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS)
batched_cholesky_kernel(const float* __restrict__ A, const float* __restrict__ rhs,
                        float* __restrict__ X, int B, int k, int kc) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // (S, M, M)
  float* sR = sA + S * M * M;                    // (S, M, w): the chunk
  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);  // systems of this block
  const int g = threadIdx.x / G;  // system of this lane's group
  const int lane = threadIdx.x % G;

  block_copy(sA, A + (size_t)b0 * M * M, ns * M * M);
  __syncthreads();

  // the factor, every lane of the group alike
  float L[M][M], inv[M];
  if (g < ns) {
    const float* a = sA + g * M * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = a[i * M + j];
#pragma unroll
        for (int p = 0; p < j; ++p) s = s - L[i][p] * L[j][p];
        if (i == j) {
          L[i][i] = sqrtf(nanmax(s, 1e-12f));
          inv[i] = 1.f / L[i][i];
        } else {
          L[i][j] = s * inv[j];
        }
      }
    }
  }

  for (int c0 = 0; c0 < k; c0 += kc) {
    const int w = min(kc, k - c0);  // columns of this chunk
    const float* r = rhs + (size_t)b0 * M * k;
    if (w == k) {
      block_copy(sR, r, ns * M * k);
    } else {
      for (int e = threadIdx.x; e < ns * M * w; e += THREADS) {
        const int row = e / w;  // system * M + i
        sR[e] = r[(size_t)row * k + c0 + e % w];
      }
    }
    __syncthreads();
    if (g < ns) {
      float* sr = sR + g * M * w;
      for (int col = lane; col < w; col += G) {
        float y[M];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          float s = sr[i * w + col];
#pragma unroll
          for (int p = 0; p < i; ++p) s = s - L[i][p] * y[p];
          y[i] = s * inv[i];
        }
#pragma unroll
        for (int i = M - 1; i >= 0; --i) {
          float s = y[i];
#pragma unroll
          for (int p = i + 1; p < M; ++p) s = s - L[p][i] * y[p];
          y[i] = s * inv[i];  // y[p > i] already holds x[p]
          sr[i * w + col] = y[i];
        }
      }
    }
    __syncthreads();
    float* x = X + (size_t)b0 * M * k;
    if (w == k) {
      block_copy(x, sR, ns * M * k);
    } else {
      for (int e = threadIdx.x; e < ns * M * w; e += THREADS) {
        const int row = e / w;
        x[(size_t)row * k + c0 + e % w] = sR[e];
      }
    }
    __syncthreads();  // sR is refilled by the next chunk
  }
}

// S systems' A and the widest chunk of their rhs columns that fits
// SMEM_BUDGET (at least 80 columns: m = 16 leaves 1280 of 1536 floats)
template <int M>
static int launch(const float* A, const float* rhs, float* X, int B, int k,
                  cudaStream_t stream) {
  const int kc = std::min(k, (SMEM_BUDGET / (int)sizeof(float) / S - M * M) / M);
  const size_t smem = sizeof(float) * (size_t)S * (M * M + M * kc);
  batched_cholesky_kernel<M><<<(B + S - 1) / S, THREADS, smem, stream>>>(A, rhs, X, B, k, kc);
  return (int)cudaGetLastError();
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
    return launch<n>(A, rhs, X, B, k, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
