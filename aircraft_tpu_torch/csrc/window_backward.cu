// Backward pass of one inner iLQR iteration of the MHTT window solve.
//
// Replaces the TPU kernel aircraft_tpu/kernels/window_kernel.py::
// make_backward_kernel (pl.pallas_call at :644).  Per scenario, for
// k = N-1..0: linearise the knot function (RK4 x substeps of the MLP or
// default-aero glider, Euler progress channel, residual rows, inequality
// rows, progress reward) on its 21 basis directions, assemble the residual
// Gauss-Newton AL curvature  g = Jr'r + Jg'y + grad(rest),
// H = Jr'Jr + Jg'W Jg  over the active set, sanitise it (1e8 on costs, 1e6
// on the step Jacobians), and run one Riccati step: an unrolled 7x7
// Cholesky whose pivot < -1e-6 flags the scenario, gains clipped to
// +-gain_clip, the value update clamped at 1e14.
//
// Bound on an H100: operations.  The 21 tangents of the knot function
// (4 RK4 stages of a 5-16-32-6 MLP each) plus the assembly and the
// Riccati products are ~4.8 GFLOP per call at B=256, N=50, against ~7 MB
// moved (the gains K dominate); at the 67 TFLOP/s fp32 peak that is about
// 70 microseconds (chip_smoke.py computes the bound from its inputs).
//
// Design: one warp per scenario, one block per warp.  Lane l < 21 carries
// the primal and the tangent of basis direction l through the templated
// knot function (a forward-mode Dual), so the linearisation is 21-wide
// parallel with no cross-lane traffic; lanes 21..31 compute the primal
// with a zero tangent.  The Jacobian rows then meet in shared memory,
// where the lanes split the JᵀJ assembly, the Riccati products, the 15
// right-hand sides of the 7x7 Cholesky and the value update.  The MLP
// weights sit in shared memory, the track table is indexed directly.  The
// sweep over k is serial inside the warp; 256 scenarios fill 256 warps,
// about two per SM, so the card is mostly idle: a first, simple kernel.
#include <cstring>

#include "window_physics.cuh"

#define HS 22  // row stride of the 21x21 shared matrices

struct BackSink {
  float* dr;  // this lane's tangent row of the residuals
  float* dg;  // this lane's tangent row of the inequalities
  float* r;   // primal residuals (lane 0 writes)
  float* g;   // primal inequalities (lane 0 writes)
  bool primal;
  int jr = 0, jg = 0;
  __device__ void res(Dual v) {
    dr[jr] = v.d;
    if (primal) r[jr] = v.v;
    ++jr;
  }
  __device__ void ineq(Dual v) {
    dg[jg] = v.d;
    if (primal) g[jg] = v.v;
    ++jg;
  }
};

__global__ void __launch_bounds__(32)
window_backward_kernel(const WinConst C, const float* __restrict__ xs,
                       const float* __restrict__ ws, const float* __restrict__ lam,
                       const float* __restrict__ mu, const float* __restrict__ reg,
                       const float* __restrict__ mu_row, const float* __restrict__ vx,
                       const float* __restrict__ vxx, const float* __restrict__ mlp,
                       const float* __restrict__ table, const float* __restrict__ restfac,
                       float* __restrict__ K_out, float* __restrict__ k_out,
                       float* __restrict__ dv1_out, float* __restrict__ dv2_out,
                       float* __restrict__ qumax_out, bool* __restrict__ fail_out) {
  __shared__ float sW[MLP_FLOATS];
  __shared__ float sdxn[32][XD];      // d x_next / d dir, then F = [A'; B'] sanitised
  __shared__ float sdr[32][NR_MAX];
  __shared__ float sdg[32][NG_MAX];
  __shared__ float sdrest[32];
  __shared__ float sr[NR_MAX], sg[NG_MAX], sy[NG_MAX], swgt[NG_MAX];
  __shared__ float sgrad[NDIR];
  __shared__ float sH[NDIR][HS];
  __shared__ float sVx[XD], sVxx[XD][XD];
  __shared__ float sQv[NDIR];         // [Qx; Qu]
  __shared__ float sQ[NDIR][HS];      // [[Qxx, Qxu]; [Qux, Quu]]
  __shared__ float sMF[NDIR][XD];     // F Vxx
  __shared__ float sK[UD][XD], skff[UD], sQuuk[UD];
  __shared__ float sKQ[XD][UD], sKQx[XD][XD];

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int N = (int)C.N[0];
  const int nr = (int)C.nr[0];
  const int ng = (int)C.ng[0];
  const float gclip = C.gain_clip[0];
  const float mu_b = mu[b];
  const float reg_b = reg[b];

  const int nmlp = C.is_mlp[0] != 0.f ? MLP_FLOATS : 0;
  for (int i = lane; i < nmlp; i += 32) sW[i] = mlp[i];
  for (int i = lane; i < XD; i += 32) sVx[i] = vx[b * XD + i];
  for (int i = lane; i < XD * XD; i += 32) sVxx[i / XD][i % XD] = vxx[b * XD * XD + i];
  __syncthreads();

  float dv1 = 0.f, dv2 = 0.f, qumax = 0.f;
  bool fail = false;

  for (int k = N - 1; k >= 0; --k) {
    // ---- linearise the knot function: lane l carries direction l
    const float* xk = xs + ((size_t)b * (N + 1) + k) * XD;
    const float* wk = ws + ((size_t)b * N + k) * UD;
    Dual x[XD], w[UD], xn[XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) x[i] = Dual(xk[i], lane == i ? 1.f : 0.f);
#pragma unroll
    for (int c = 0; c < UD; ++c) w[c] = Dual(wk[c], lane == XD + c ? 1.f : 0.f);
    BackSink sink{sdr[lane], sdg[lane], sr, sg, lane == 0};
    Dual rest = knot(C, sW, table, x, w, restfac[k], xn, sink);
#pragma unroll
    for (int i = 0; i < XD; ++i) sdxn[lane][i] = xn[i].d;
    sdrest[lane] = rest.d;
    __syncthreads();

    // ---- active set of the PHR terms
    if (lane < ng) {
      const float gj = sg[lane];
      const float lj = lam[((size_t)b * N + k) * ng + lane];
      const float mug = mu_b * mu_row[(size_t)b * ng + lane];
      const bool act = (gj + lj / mug) > 0.f;
      sy[lane] = act ? lj + mug * gj : 0.f;
      swgt[lane] = act ? mug : 0.f;
    }
    __syncthreads();

    // ---- Gauss-Newton gradient and curvature, row `lane`
    if (lane < NDIR) {
      const int t = lane;
      float gr = 0.f, gy = 0.f;
      for (int j = 0; j < nr; ++j) gr += sdr[t][j] * sr[j];
      for (int j = 0; j < ng; ++j) gy += sdg[t][j] * sy[j];
      sgrad[t] = sanitize(gr + gy + sdrest[t], 1e8f);
      for (int m = 0; m < NDIR; ++m) {
        float h = 0.f;
        for (int j = 0; j < nr; ++j) h += sdr[t][j] * sdr[m][j];
        for (int j = 0; j < ng; ++j) h += sdg[t][j] * sdg[m][j] * swgt[j];
        sH[t][m] = sanitize(h, 1e8f);
      }
    }
    __syncthreads();
    if (lane < NDIR) {
#pragma unroll
      for (int i = 0; i < XD; ++i) sdxn[lane][i] = sanitize(sdxn[lane][i], 1e6f);
    }
    __syncthreads();

    // ---- Riccati: Qv = grad + F Vx, MF = F Vxx, Q = H + MF F'
    for (int e = lane; e < NDIR * XD; e += 32) {
      const int t = e / XD, j = e % XD;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < XD; ++i) acc += sdxn[t][i] * sVxx[i][j];
      sMF[t][j] = acc;
    }
    if (lane < NDIR) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < XD; ++i) acc += sdxn[lane][i] * sVx[i];
      sQv[lane] = sgrad[lane] + acc;
    }
    __syncthreads();
    for (int e = lane; e < NDIR * NDIR; e += 32) {
      const int t = e / NDIR, m = e % NDIR;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < XD; ++j) acc += sMF[t][j] * sdxn[m][j];
      sQ[t][m] = sH[t][m] + acc;
    }
    __syncthreads();

    // ---- 7x7 Cholesky of sym(Quu) + reg I, every lane; lane c < 15
    //      solves right-hand side c of [Qu | Qux]
    float Lm[UD][UD];
    bool bad = false;
#pragma unroll
    for (int i = 0; i < UD; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = 0.5f * (sQ[XD + i][XD + j] + sQ[XD + j][XD + i]);
        if (i == j) s += reg_b;
#pragma unroll
        for (int p = 0; p < j; ++p) s -= Lm[i][p] * Lm[j][p];
        if (i == j) {
          bad |= s < -1e-6f;
          Lm[i][i] = sqrtf(max_(s, 1e-12f));
        } else {
          Lm[i][j] = s / Lm[j][j];
        }
      }
    }
    if (lane < 1 + XD) {
      float y[UD], xsol[UD];
#pragma unroll
      for (int i = 0; i < UD; ++i) {
        float s = lane == 0 ? sQv[XD + i] : sQ[XD + i][lane - 1];
#pragma unroll
        for (int p = 0; p < i; ++p) s -= Lm[i][p] * y[p];
        y[i] = s / Lm[i][i];
      }
#pragma unroll
      for (int i = UD - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int p = i + 1; p < UD; ++p) s -= Lm[p][i] * xsol[p];
        xsol[i] = s / Lm[i][i];
      }
#pragma unroll
      for (int i = 0; i < UD; ++i) {
        const float gain = min_(max_(-xsol[i], -gclip), gclip);
        if (lane == 0) skff[i] = gain;
        else sK[i][lane - 1] = gain;
      }
    }
    __syncthreads();

    // ---- store the gains; value-update products
    float* Kk = K_out + ((size_t)b * N + k) * UD * XD;
    for (int e = lane; e < UD * XD; e += 32) Kk[e] = sK[e / XD][e % XD];
    if (lane < UD) {
      k_out[((size_t)b * N + k) * UD + lane] = skff[lane];
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < UD; ++d) acc += sQ[XD + lane][XD + d] * skff[d];
      sQuuk[lane] = acc;
    }
    for (int e = lane; e < XD * UD; e += 32) {
      const int i = e / UD, c = e % UD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < UD; ++d) acc += sK[d][i] * sQ[XD + d][XD + c];
      sKQ[i][c] = acc;
    }
    for (int e = lane; e < XD * XD; e += 32) {
      const int i = e / XD, j = e % XD;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) acc += sK[c][i] * sQ[XD + c][j];
      sKQx[i][j] = acc;
    }
    __syncthreads();

    // ---- value update, symmetrised and clamped
    if (lane < XD) {
      const int i = lane;
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) {
        a1 += sK[c][i] * sQuuk[c];
        a2 += sK[c][i] * sQv[XD + c];
        a3 += sQ[XD + c][i] * skff[c];
      }
      sVx[i] = sanitize(sQv[i] + a1 + a2 + a3, 1e14f);
    }
    for (int e = lane; e < XD * XD; e += 32) {
      const int i = e / XD, j = e % XD;
      if (j < i) continue;
      float kq_ij = 0.f, kq_ji = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) {
        kq_ij += sKQ[i][c] * sK[c][j];
        kq_ji += sKQ[j][c] * sK[c][i];
      }
      const float vij = sQ[i][j] + kq_ij + sKQx[i][j] + sKQx[j][i];
      const float vji = sQ[j][i] + kq_ji + sKQx[j][i] + sKQx[i][j];
      const float v = sanitize(0.5f * (vij + vji), 1e14f);
      sVxx[i][j] = v;
      sVxx[j][i] = v;
    }
    if (lane == 0) {
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) {
        dv1 += skff[c] * sQv[XD + c];
        q = max_(q, fabsf(sQv[XD + c]));
      }
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) d2 += skff[c] * sQuuk[c];
      dv2 += 0.5f * d2;
      qumax = max_(qumax, q);
      fail |= bad;
    }
    __syncthreads();
  }
  if (lane == 0) {
    dv1_out[b] = dv1;
    dv2_out[b] = dv2;
    qumax_out[b] = qumax;
    fail_out[b] = fail;
  }
}

WINDOW_EXPORTS(window_backward)

extern "C" int window_backward_launch(
    const float* consts, int nconst, const float* xs, const float* ws, const float* lam,
    const float* mu, const float* reg, const float* mu_row, const float* vx, const float* vxx,
    const float* mlp, const float* table, const float* restfac, float* K, float* kff,
    float* dv1, float* dv2, float* qumax, bool* fail, int B, void* stream) {
  if ((size_t)nconst * sizeof(float) != sizeof(WinConst)) return (int)cudaErrorInvalidValue;
  WinConst C;
  memcpy(&C, consts, sizeof(WinConst));
  if (C.nr[0] > NR_MAX || C.ng[0] > NG_MAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  window_backward_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      C, xs, ws, lam, mu, reg, mu_row, vx, vxx, mlp, table, restfac, K, kff, dv1, dv2, qumax,
      fail);
  return (int)cudaGetLastError();
}
