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
// Design: one thread per (scenario, candidate), 32 / A scenarios per warp
// and one warp per block, so the candidates of a scenario run side by side
// in one warp instead of one after another as on the TPU.  Each thread
// writes its candidate's trajectory to a scratch buffer as it rolls; after
// the pick the scenario's threads copy the winner out.  The copy is the
// same trajectory the TPU kernel re-rolls at the chosen alpha.  A thread
// rolls its N knots serially, so the kernel is latency-bound: a first,
// simple kernel.
#include <cstring>

#include "window_physics.cuh"

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

__global__ void __launch_bounds__(32)
window_forward_kernel(const WinConst C, const float* __restrict__ xs,
                      const float* __restrict__ ws, const float* __restrict__ K,
                      const float* __restrict__ kff, const float* __restrict__ lam,
                      const float* __restrict__ mu, const float* __restrict__ mu_row,
                      const float* __restrict__ mlp, const float* __restrict__ table,
                      const float* __restrict__ restfac, float* __restrict__ xs_new,
                      float* __restrict__ ws_new, float* __restrict__ misc,
                      float* __restrict__ cand_xs, float* __restrict__ cand_ws, int B) {
  __shared__ float sW[MLP_FLOATS];
  __shared__ float scost[32], snfro[32];
  __shared__ int sbest[32];

  const int N = (int)C.N[0];
  const int A = (int)C.n_alpha[0];
  const int ng = (int)C.ng[0];
  const int per = 32 / A;
  const int slot = threadIdx.x / A;
  const int a = threadIdx.x % A;
  const int b = blockIdx.x * per + slot;
  const bool active = slot < per && b < B;

  const int nmlp = C.is_mlp[0] != 0.f ? MLP_FLOATS : 0;
  for (int i = threadIdx.x; i < nmlp; i += 32) sW[i] = mlp[i];
  __syncthreads();

  if (active) {
    const float alpha = C.alphas[a];
    const float mu_b = mu[b];
    const float* murow_b = mu_row + (size_t)b * ng;
    float x[XD], xn[XD], w[UD];
    const float* x0 = xs + (size_t)b * (N + 1) * XD;
#pragma unroll
    for (int i = 0; i < XD; ++i) x[i] = x0[i];
    float cost = 0.f, nfro = 0.f;
    float* cx = cand_xs + ((size_t)b * A + a) * (N + 1) * XD;
    float* cw = cand_ws + ((size_t)b * A + a) * N * UD;
    for (int k = 0; k < N; ++k) {
      const float* xr = x0 + (size_t)k * XD;
      const float* wr = ws + ((size_t)b * N + k) * UD;
      const float* Kk = K + ((size_t)b * N + k) * UD * XD;
      const float* kk = kff + ((size_t)b * N + k) * UD;
      float dx[XD];
#pragma unroll
      for (int i = 0; i < XD; ++i) dx[i] = x[i] - xr[i];
#pragma unroll
      for (int c = 0; c < UD; ++c) {
        float fb = 0.f;
#pragma unroll
        for (int j = 0; j < XD; ++j) fb += Kk[c * XD + j] * dx[j];
        w[c] = (wr[c] + alpha * kk[c]) + fb;
      }
      FwdSink sink{lam + ((size_t)b * N + k) * ng, murow_b, mu_b};
      const float rest = knot(C, sW, table, x, w, restfac[k], xn, sink);
      float c = 0.5f * sink.sr + rest;
      c = c + 0.5f * sink.sg;
      c = c - 0.5f * sink.sl;
      bool finite = true;
#pragma unroll
      for (int i = 0; i < XD; ++i) finite = finite && isfinite(xn[i]) && fabsf(xn[i]) < 1e6f;
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        x[i] = finite ? xn[i] : x[i];
        cx[(k + 1) * XD + i] = x[i];
      }
#pragma unroll
      for (int c2 = 0; c2 < UD; ++c2) cw[k * UD + c2] = w[c2];
      cost += c;
      nfro += finite ? 0.f : 1.f;
    }
    cost = cost + terminal_cost(C, table, x);
    if (cost != cost) cost = INFINITY;
    cost = cost + FREEZE_PENALTY * nfro;
    scost[threadIdx.x] = cost;
    snfro[threadIdx.x] = nfro;
  }
  __syncthreads();

  if (active && a == 0) {
    const int base = slot * A;
    float best = scost[base];
    int bi = 0;
    for (int q = 1; q < A; ++q) {
      if (scost[base + q] < best) {
        best = scost[base + q];
        bi = q;
      }
    }
    sbest[slot] = bi;
    float* m = misc + (size_t)b * (A + 3);
    for (int q = 0; q < A; ++q) m[q] = scost[base + q];
    m[A] = best;
    m[A + 1] = snfro[base + bi];
    m[A + 2] = C.alphas[bi];
  }
  __syncthreads();

  if (active) {
    const int bi = sbest[slot];
    const float* cx = cand_xs + ((size_t)b * A + bi) * (N + 1) * XD;
    const float* cw = cand_ws + ((size_t)b * A + bi) * N * UD;
    float* xo = xs_new + (size_t)b * (N + 1) * XD;
    float* wo = ws_new + (size_t)b * N * UD;
    const float* x0 = xs + (size_t)b * (N + 1) * XD;
    for (int e = a; e < XD; e += A) xo[e] = x0[e];
    for (int e = XD + a; e < (N + 1) * XD; e += A) xo[e] = cx[e];
    for (int e = a; e < N * UD; e += A) wo[e] = cw[e];
  }
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
  if (A < 1 || A > A_MAX || C.ng[0] > NG_MAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int per = 32 / A;
  const int blocks = (B + per - 1) / per;
  window_forward_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
      C, xs, ws, K, kff, lam, mu, mu_row, mlp, table, restfac, xs_new, ws_new, misc, cand_xs,
      cand_ws, B);
  return (int)cudaGetLastError();
}
