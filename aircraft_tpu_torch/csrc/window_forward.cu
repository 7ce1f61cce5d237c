// Line-search forward pass of one inner iLQR iteration of the MHTT
// window solve.
//
// Replaces the TPU kernel aircraft_tpu/kernels/window_kernel.py::
// make_forward_kernel (pl.pallas_call at :790).  For every scenario and
// every step size alpha of the schedule (1, 1/2, ..., 0): one closed-loop
// rollout w = w_ref + alpha k + K (x - x_ref) through the knot function,
// summing the AL stage cost, then the terminal cost.  A knot whose next
// state is non-finite or has |x| >= 1e6 freezes (keeps x) and the
// candidate pays FREEZE_PENALTY per frozen knot; a NaN cost becomes +inf.
// The best alpha per scenario starts at the first candidate and moves
// only on a strictly lower cost, in candidate order (the TPU kernel's
// tie rule), and its trajectory is stored.
//
// Bound on an H100: operations, ~0.6 GFLOP per call at B=256, N=50, six
// candidates (the MLP plant of every knot of every candidate) against
// ~7 MB moved: about ten microseconds at the 67 TFLOP/s fp32 peak
// (chip_smoke.py computes the bound from its inputs).
//
// Design: one warp per (scenario, candidate), the A candidates of a
// scenario in one block of A warps (B*A warps in all: 1536 at the headline
// shape).  The block first copies the scenario's reference (xs, ws, K, k,
// lam, mu_row) into shared memory, which every warp then reads as
// broadcasts.  Within a warp the MLP of the plant is spread across the
// lanes (LaneMLP): lane j keeps its own weights in registers, computes
// first-layer unit j mod 16, takes the 16 first-layer outputs by shuffle,
// computes second-layer unit j, and the six outputs are summed by a xor
// butterfly, which leaves the same bits in every lane.  Every lane then
// carries the rest of the plant, the knot function and the state
// redundantly, so the warp stays uniform and nothing else is exchanged.
// Lane i < 14 stores state element i of each knot and lanes 14..20 the
// controls, into a per-candidate scratch trajectory; after the pick in
// shared memory the block copies the winner out.  The default-aero model
// has no MLP: the same kernel computes its coefficients on every lane.
#include <cstring>

#include "window_physics.cuh"

#define FULL_MASK 0xffffffffu
#define SMEM_MAX 232448  // bytes of shared memory a block may use on sm_90

// the 5-16-32-6 MLP spread across a warp: lane j holds column j mod 16 of
// the first layer, column j of the second and row j of the third
struct LaneMLP {
  float w0[5], b0, w1[16], b1, w2[6], b2[6];

  __device__ __forceinline__ void load(const float* __restrict__ W, int lane) {
    const int j0 = lane & 15;
#pragma unroll
    for (int i = 0; i < 5; ++i) w0[i] = W[i * 16 + j0];
    b0 = W[80 + j0];
#pragma unroll
    for (int i = 0; i < 16; ++i) w1[i] = W[96 + i * 32 + lane];
    b1 = W[608 + lane];
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      w2[o] = W[640 + lane * 6 + o];
      b2[o] = W[832 + o];
    }
  }

  __device__ __forceinline__ void operator()(const float in[5], float out[6]) const {
    float h1 = in[0] * w0[0] + b0;
#pragma unroll
    for (int i = 1; i < 5; ++i) h1 = h1 + in[i] * w0[i];
    float acc = __shfl_sync(FULL_MASK, h1, 0) * w1[0] + b1;
#pragma unroll
    for (int i = 1; i < 16; ++i) acc = acc + __shfl_sync(FULL_MASK, h1, i) * w1[i];
    const float h2 = tanhf(acc);
    float p[6];
#pragma unroll
    for (int o = 0; o < 6; ++o) p[o] = h2 * w2[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int o = 0; o < 6; ++o) p[o] = p[o] + __shfl_xor_sync(FULL_MASK, p[o], off);
    }
#pragma unroll
    for (int o = 0; o < 6; ++o) out[o] = p[o] + b2[o];
  }
};

struct FwdSink {
  const float* lam;     // lam[k, :] of this scenario
  const float* mu_row;  // mu_row of this scenario
  float mu;
  float sr = 0.f, sg = 0.f, sl = 0.f;
  int jg = 0;
  __device__ void res(float v) { sr += v * v; }
  __device__ void ineq(float v) {
    const float mug = mu * mu_row[jg];
    const float lj = lam[jg];
    const float gp = max_(v + lj / mug, 0.f);
    sg += mug * gp * gp;
    sl += lj * lj / mug;
    ++jg;
  }
};

// floats of one scenario's reference in shared memory, then 2A + 1 words
// for the pick (window.py::forward_smem_bytes computes the same)
__host__ __device__ inline int forward_smem_floats(int N, int ng, int A) {
  return (N + 1) * XD + N * (UD + UD * XD + UD + ng) + ng + 2 * A + 1;
}

__global__ void __launch_bounds__(32 * A_MAX)
window_forward_kernel(const WinConst C, const float* __restrict__ xs,
                      const float* __restrict__ ws, const float* __restrict__ K,
                      const float* __restrict__ kff, const float* __restrict__ lam,
                      const float* __restrict__ mu, const float* __restrict__ mu_row,
                      const float* __restrict__ mlp, const float* __restrict__ table,
                      const float* __restrict__ restfac, float* __restrict__ xs_new,
                      float* __restrict__ ws_new, float* __restrict__ misc,
                      float* __restrict__ cand_xs, float* __restrict__ cand_ws) {
  extern __shared__ float smem[];
  const int N = (int)C.N[0];
  const int A = (int)C.n_alpha[0];
  const int ng = (int)C.ng[0];
  const int b = blockIdx.x;
  const int a = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthr = blockDim.x;

  float* sx = smem;                     // (N+1, 14)
  float* sw = sx + (N + 1) * XD;        // (N, 7)
  float* sK = sw + N * UD;              // (N, 7, 14)
  float* skf = sK + N * UD * XD;        // (N, 7)
  float* slam = skf + N * UD;           // (N, ng)
  float* smr = slam + N * ng;           // (ng)
  float* scost = smr + ng;              // (A)
  float* snfro = scost + A;             // (A)
  int* sbest = (int*)(snfro + A);

  {
    const float* gx = xs + (size_t)b * (N + 1) * XD;
    const float* gw = ws + (size_t)b * N * UD;
    const float* gK = K + (size_t)b * N * UD * XD;
    const float* gk = kff + (size_t)b * N * UD;
    const float* gl = lam + (size_t)b * N * ng;
    for (int i = threadIdx.x; i < (N + 1) * XD; i += nthr) sx[i] = gx[i];
    for (int i = threadIdx.x; i < N * UD; i += nthr) {
      sw[i] = gw[i];
      skf[i] = gk[i];
    }
    for (int i = threadIdx.x; i < N * UD * XD; i += nthr) sK[i] = gK[i];
    for (int i = threadIdx.x; i < N * ng; i += nthr) slam[i] = gl[i];
    for (int i = threadIdx.x; i < ng; i += nthr) smr[i] = mu_row[(size_t)b * ng + i];
  }
  LaneMLP aero;
  if (C.is_mlp[0] != 0.f) aero.load(mlp, lane);
  __syncthreads();

  const float alpha = C.alphas[a];
  const float mu_b = mu[b];
  float x[XD], xn[XD], w[UD];
#pragma unroll
  for (int i = 0; i < XD; ++i) x[i] = sx[i];
  float cost = 0.f, nfro = 0.f;
  float* cx = cand_xs + ((size_t)b * A + a) * (N + 1) * XD;
  float* cw = cand_ws + ((size_t)b * A + a) * N * UD;
  for (int k = 0; k < N; ++k) {
    const float* xr = sx + k * XD;
    const float* Kk = sK + k * UD * XD;
    float dx[XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) dx[i] = x[i] - xr[i];
#pragma unroll
    for (int c = 0; c < UD; ++c) {
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < XD; ++j) fb += Kk[c * XD + j] * dx[j];
      w[c] = (sw[k * UD + c] + alpha * skf[k * UD + c]) + fb;
    }
    FwdSink sink{slam + k * ng, smr, mu_b};
    const float rest = knot(C, aero, table, x, w, restfac[k], xn, sink);
    float c = 0.5f * sink.sr + rest;
    c = c + 0.5f * sink.sg;
    c = c - 0.5f * sink.sl;
    bool finite = true;
#pragma unroll
    for (int i = 0; i < XD; ++i) finite = finite && isfinite(xn[i]) && fabsf(xn[i]) < 1e6f;
    // lane i < 14 stores x[i], lanes 14..20 the controls
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      x[i] = finite ? xn[i] : x[i];
      if (lane == i) v = x[i];
    }
#pragma unroll
    for (int c2 = 0; c2 < UD; ++c2)
      if (lane == XD + c2) v = w[c2];
    if (lane < XD) cx[(k + 1) * XD + lane] = v;
    else if (lane < XD + UD) cw[k * UD + lane - XD] = v;
    cost += c;
    nfro += finite ? 0.f : 1.f;
  }
  cost = cost + terminal_cost(C, table, x);
  if (cost != cost) cost = INFINITY;
  cost = cost + FREEZE_PENALTY * nfro;
  if (lane == 0) {
    scost[a] = cost;
    snfro[a] = nfro;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float best = scost[0];
    int bi = 0;
    for (int q = 1; q < A; ++q) {
      if (scost[q] < best) {
        best = scost[q];
        bi = q;
      }
    }
    sbest[0] = bi;
    float* m = misc + (size_t)b * (A + 3);
    for (int q = 0; q < A; ++q) m[q] = scost[q];
    m[A] = best;
    m[A + 1] = snfro[bi];
    m[A + 2] = C.alphas[bi];
  }
  __syncthreads();

  const int bi = sbest[0];
  const float* bx = cand_xs + ((size_t)b * A + bi) * (N + 1) * XD;
  const float* bw = cand_ws + ((size_t)b * A + bi) * N * UD;
  float* xo = xs_new + (size_t)b * (N + 1) * XD;
  float* wo = ws_new + (size_t)b * N * UD;
  for (int e = threadIdx.x; e < (N + 1) * XD; e += nthr) xo[e] = e < XD ? sx[e] : bx[e];
  for (int e = threadIdx.x; e < N * UD; e += nthr) wo[e] = bw[e];
}

WINDOW_EXPORTS(window_forward)

extern "C" int window_forward_launch(const float* consts, int nconst, const float* xs,
                                     const float* ws, const float* K, const float* kff,
                                     const float* lam, const float* mu, const float* mu_row,
                                     const float* mlp, const float* table, const float* restfac,
                                     float* xs_new, float* ws_new, float* misc, float* cand_xs,
                                     float* cand_ws, int B, void* stream) {
  if ((size_t)nconst * sizeof(float) != sizeof(WinConst)) return (int)cudaErrorInvalidValue;
  WinConst C;
  memcpy(&C, consts, sizeof(WinConst));
  const int A = (int)C.n_alpha[0];
  if (A < 1 || A > A_MAX || C.ng[0] > NG_MAX || C.N[0] < 1.f) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const size_t smem = sizeof(float) * forward_smem_floats((int)C.N[0], (int)C.ng[0], A);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_forward_kernel<<<B, 32 * A, smem, (cudaStream_t)stream>>>(
      C, xs, ws, K, kff, lam, mu, mu_row, mlp, table, restfac, xs_new, ws_new, misc, cand_xs,
      cand_ws);
  return (int)cudaGetLastError();
}

// resident warps per SM at A candidates and `smem` bytes of shared memory
extern "C" int window_forward_occupancy(int A, int smem, int* warps) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, window_forward_kernel, 32 * A, smem);
  *warps = n * A;
  return (int)err;
}
