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
// Design: two kernels on one stream.  Only the Riccati step is serial in
// k: a knot's linearisation, gradient, curvature and sanitised F = [A'; B']
// depend on xs, ws, lam, mu, mu_row and restfac alone (the active set
// comes from g and lam), as the TPU kernel's plain version computes them.
//
// * Phase A, window_linearize_kernel: one warp per (scenario, knot), all
//   B*N knots at once (12,800 warps at the headline shape), KPB warps per
//   block sharing the MLP weights in shared memory, three blocks per SM
//   (the launch bound holds the plant to 168 registers; uncapped it takes
//   189 and fits only two blocks, and at four blocks it spills more: both
//   ran slower on the card).  Lane l < 21 carries
//   the primal and the tangent of basis direction l through the templated
//   knot function (a forward-mode Dual), lanes 21..31 the primal with a
//   zero tangent; the Jacobian rows meet in the warp's shared scratch,
//   where the lanes split the 231 upper-triangle entries of H.  Each knot
//   writes [grad (21) | H (21x21) | F (21x14)] = QSTRIDE floats to `quad`.
// * Phase B, window_riccati_kernel: one block of RB_THREADS threads per
//   scenario sweeps k = N-1..0, one output element of each product per
//   thread (the largest product, Q, has 343 used elements), while knot
//   k-1's QSTRIDE floats come into the other half of a shared double
//   buffer by cp.async.  Warp 0 runs the 7x7 Cholesky redundantly on its
//   lanes and solves one right-hand side per lane.  The step is a serial
//   chain of divides, square roots and barriers: the thread count barely
//   moves it.
#include <cstring>

#include "window_physics.cuh"

#define HS 22          // row stride of the 21x21 shared matrix Q
#define KPB 4          // phase A: knots (warps) per block
#define KPB_BLOCKS_PER_SM 3  // phase A: 12 resident warps per SM, <= 168 registers
#define RS 21          // phase A: row stride of the residual/inequality tangents (odd)
#define FS 15          // phase A: row stride of the step tangents (odd)
#define NTRI 231       // entries of H on and above the diagonal
#define Q_H NDIR                       // offset of H in a knot's record
#define Q_F (NDIR + NDIR * NDIR)       // offset of F (21 x 14, row t = direction t)
#define QSTRIDE (Q_F + NDIR * XD)      // 756 floats = 189 chunks of 16 bytes
#define RB_THREADS 352 // phase B: threads per scenario, one element of each product

static_assert(QSTRIDE % 4 == 0, "a knot's record is whole 16-byte chunks");

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

// one warp's scratch in phase A
struct KnotScratch {
  float dxn[32][FS];  // d x_next / d direction
  float dr[32][RS];
  float dg[32][RS];
  float drest[32];
  float r[NR_MAX], g[NG_MAX], y[NG_MAX], wgt[NG_MAX];
};

__global__ void __launch_bounds__(KPB * 32, KPB_BLOCKS_PER_SM)
window_linearize_kernel(const WinConst C, const float* __restrict__ xs,
                        const float* __restrict__ ws, const float* __restrict__ lam,
                        const float* __restrict__ mu, const float* __restrict__ mu_row,
                        const float* __restrict__ mlp, const float* __restrict__ table,
                        const float* __restrict__ restfac, float* __restrict__ quad, int BN) {
  __shared__ float sW[MLP_FLOATS];
  __shared__ KnotScratch sk[KPB];

  const int nmlp = C.is_mlp[0] != 0.f ? MLP_FLOATS : 0;
  for (int i = threadIdx.x; i < nmlp; i += KPB * 32) sW[i] = mlp[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * KPB + warp;
  if (q >= BN) return;
  const int N = (int)C.N[0];
  const int b = q / N, k = q - b * N;
  const int nr = (int)C.nr[0];
  const int ng = (int)C.ng[0];
  KnotScratch& S = sk[warp];

  // ---- linearise the knot function: lane l carries direction l
  const float* xk = xs + ((size_t)b * (N + 1) + k) * XD;
  const float* wk = ws + (size_t)q * UD;
  Dual x[XD], w[UD], xn[XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) x[i] = Dual(xk[i], lane == i ? 1.f : 0.f);
#pragma unroll
  for (int c = 0; c < UD; ++c) w[c] = Dual(wk[c], lane == XD + c ? 1.f : 0.f);
  BackSink sink{S.dr[lane], S.dg[lane], S.r, S.g, lane == 0};
  const Dual rest = knot(C, SharedMLP{sW}, table, x, w, restfac[k], xn, sink);
#pragma unroll
  for (int i = 0; i < XD; ++i) S.dxn[lane][i] = xn[i].d;
  S.drest[lane] = rest.d;
  __syncwarp();

  // ---- active set of the PHR terms
  if (lane < ng) {
    const float gj = S.g[lane];
    const float lj = lam[(size_t)q * ng + lane];
    const float mug = mu[b] * mu_row[(size_t)b * ng + lane];
    const bool act = (gj + lj / mug) > 0.f;
    S.y[lane] = act ? lj + mug * gj : 0.f;
    S.wgt[lane] = act ? mug : 0.f;
  }
  __syncwarp();

  // ---- Gauss-Newton gradient, the step Jacobians, the curvature
  float* out = quad + (size_t)q * QSTRIDE;
  if (lane < NDIR) {
    float gr = 0.f, gy = 0.f;
    for (int j = 0; j < nr; ++j) gr += S.dr[lane][j] * S.r[j];
    for (int j = 0; j < ng; ++j) gy += S.dg[lane][j] * S.y[j];
    out[lane] = sanitize(gr + gy + S.drest[lane], 1e8f);
  }
  for (int e = lane; e < NDIR * XD; e += 32)
    out[Q_F + e] = sanitize(S.dxn[e / XD][e % XD], 1e6f);
  for (int e = lane; e < NTRI; e += 32) {
    int t = 0, m = e;
    while (m >= NDIR - t) {
      m -= NDIR - t;
      ++t;
    }
    m += t;
    float h = 0.f;
    for (int j = 0; j < nr; ++j) h += S.dr[t][j] * S.dr[m][j];
    for (int j = 0; j < ng; ++j) h += S.dg[t][j] * S.dg[m][j] * S.wgt[j];
    h = sanitize(h, 1e8f);
    out[Q_H + t * NDIR + m] = h;
    out[Q_H + m * NDIR + t] = h;
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// start the copy of one knot's record into shared memory
__device__ __forceinline__ void fetch_knot(float* dst, const float* src) {
  for (int c = threadIdx.x; c < QSTRIDE / 4; c += RB_THREADS) cp_async16(dst + 4 * c, src + 4 * c);
  cp_async_commit();
}

__global__ void __launch_bounds__(RB_THREADS)
window_riccati_kernel(const WinConst C, const float* __restrict__ quad,
                      const float* __restrict__ reg, const float* __restrict__ vx,
                      const float* __restrict__ vxx, float* __restrict__ K_out,
                      float* __restrict__ k_out, float* __restrict__ dv1_out,
                      float* __restrict__ dv2_out, float* __restrict__ qumax_out,
                      bool* __restrict__ fail_out) {
  __shared__ __align__(16) float sq[2][QSTRIDE];  // knot k and knot k-1 in flight
  __shared__ float sVx[XD], sVxx[XD][XD];
  __shared__ float sQv[NDIR];         // [Qx; Qu]
  __shared__ float sQ[NDIR][HS];      // [[Qxx, .]; [Qux, Quu]]
  __shared__ float sMF[NDIR][XD];     // F Vxx
  __shared__ float sK[UD][XD], skff[UD], sQuuk[UD];
  __shared__ float sKQ[XD][UD], sKQx[XD][XD];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = (int)C.N[0];
  const float gclip = C.gain_clip[0];
  const float reg_b = reg[b];
  const float* qb = quad + (size_t)b * N * QSTRIDE;

  fetch_knot(sq[(N - 1) & 1], qb + (size_t)(N - 1) * QSTRIDE);
  for (int i = tid; i < XD; i += RB_THREADS) sVx[i] = vx[b * XD + i];
  for (int i = tid; i < XD * XD; i += RB_THREADS) sVxx[i / XD][i % XD] = vxx[b * XD * XD + i];

  float dv1 = 0.f, dv2 = 0.f, qumax = 0.f;  // thread 0's
  bool fail = false;

  for (int k = N - 1; k >= 0; --k) {
    const float* grad = sq[k & 1];
    const float* H = grad + Q_H;
    const float* F = grad + Q_F;
    // every thread finished reading the other buffer one knot ago
    if (k > 0) fetch_knot(sq[(k - 1) & 1], qb + (size_t)(k - 1) * QSTRIDE);
    else cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // ---- Qv = grad + F Vx, MF = F Vxx
    for (int e = tid; e < NDIR * XD + NDIR; e += RB_THREADS) {
      if (e < NDIR * XD) {
        const int t = e / XD, j = e % XD;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < XD; ++i) acc += F[t * XD + i] * sVxx[i][j];
        sMF[t][j] = acc;
      } else {
        const int t = e - NDIR * XD;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < XD; ++i) acc += F[t * XD + i] * sVx[i];
        sQv[t] = grad[t] + acc;
      }
    }
    __syncthreads();

    // ---- Q = H + MF F' on the blocks the step reads: Qxx, then [Qux Quu]
    for (int e = tid; e < XD * XD + UD * NDIR; e += RB_THREADS) {
      int t, m;
      if (e < XD * XD) {
        t = e / XD;
        m = e % XD;
      } else {
        t = XD + (e - XD * XD) / NDIR;
        m = (e - XD * XD) % NDIR;
      }
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < XD; ++j) acc += sMF[t][j] * F[m * XD + j];
      sQ[t][m] = H[t * NDIR + m] + acc;
    }
    __syncthreads();

    // ---- warp 0: 7x7 Cholesky of sym(Quu) + reg I on every lane; lane
    //      c < 15 solves right-hand side c of [Qu | Qux]
    bool bad = false;
    if (tid < 32) {
      float Lm[UD][UD];
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
      if (tid < 1 + XD) {
        float y[UD], xsol[UD];
#pragma unroll
        for (int i = 0; i < UD; ++i) {
          float s = tid == 0 ? sQv[XD + i] : sQ[XD + i][tid - 1];
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
          if (tid == 0) skff[i] = gain;
          else sK[i][tid - 1] = gain;
        }
      }
    }
    __syncthreads();

    // ---- store the gains; value-update products
    float* Kk = K_out + ((size_t)b * N + k) * UD * XD;
    for (int e = tid; e < UD * XD; e += RB_THREADS) Kk[e] = sK[e / XD][e % XD];
    if (tid < UD) k_out[((size_t)b * N + k) * UD + tid] = skff[tid];
    for (int e = tid; e < UD + XD * UD + XD * XD; e += RB_THREADS) {
      if (e < UD) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < UD; ++d) acc += sQ[XD + e][XD + d] * skff[d];
        sQuuk[e] = acc;
      } else if (e < UD + XD * UD) {
        const int i = (e - UD) / UD, c = (e - UD) % UD;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < UD; ++d) acc += sK[d][i] * sQ[XD + d][XD + c];
        sKQ[i][c] = acc;
      } else {
        const int i = (e - UD - XD * UD) / XD, j = (e - UD - XD * UD) % XD;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < UD; ++c) acc += sK[c][i] * sQ[XD + c][j];
        sKQx[i][j] = acc;
      }
    }
    __syncthreads();

    // ---- value update, symmetrised and clamped; thread 0 the totals
    if (tid < XD) {
      const int i = tid;
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < UD; ++c) {
        a1 += sK[c][i] * sQuuk[c];
        a2 += sK[c][i] * sQv[XD + c];
        a3 += sQ[XD + c][i] * skff[c];
      }
      sVx[i] = sanitize(sQv[i] + a1 + a2 + a3, 1e14f);
    }
    for (int e = tid; e < XD * XD; e += RB_THREADS) {
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
    if (tid == 0) {
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
  if (tid == 0) {
    dv1_out[b] = dv1;
    dv2_out[b] = dv2;
    qumax_out[b] = qumax;
    fail_out[b] = fail;
  }
}

WINDOW_EXPORTS(window_backward)

// Launch phase A (phases & 1) and then phase B (phases & 2) on `stream`;
// `quad` holds B*N*QSTRIDE floats.  Returns the first launch error.
extern "C" int window_backward_launch(
    const float* consts, int nconst, const float* xs, const float* ws, const float* lam,
    const float* mu, const float* reg, const float* mu_row, const float* vx, const float* vxx,
    const float* mlp, const float* table, const float* restfac, float* quad, float* K,
    float* kff, float* dv1, float* dv2, float* qumax, bool* fail, int B, int phases,
    void* stream) {
  if ((size_t)nconst * sizeof(float) != sizeof(WinConst)) return (int)cudaErrorInvalidValue;
  WinConst C;
  memcpy(&C, consts, sizeof(WinConst));
  if (C.nr[0] > NR_MAX || C.ng[0] > NG_MAX || C.N[0] < 1.f) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int BN = B * (int)C.N[0];
  if (phases & 1) {
    window_linearize_kernel<<<(BN + KPB - 1) / KPB, KPB * 32, 0, (cudaStream_t)stream>>>(
        C, xs, ws, lam, mu, mu_row, mlp, table, restfac, quad, BN);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    window_riccati_kernel<<<B, RB_THREADS, 0, (cudaStream_t)stream>>>(
        C, quad, reg, vx, vxx, K, kff, dv1, dv2, qumax, fail);
    return (int)cudaGetLastError();
  }
  return 0;
}

// floats of the phase A -> B buffer per knot
extern "C" int window_backward_knot_floats() { return QSTRIDE; }

// resident warps per SM of phase A and phase B, as the occupancy
// calculator gives them for this build's registers and shared memory
extern "C" int window_backward_occupancy(int* warps_a, int* warps_b) {
  int na = 0, nb = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&na, window_linearize_kernel, KPB * 32, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, window_riccati_kernel, RB_THREADS, 0);
  *warps_a = na * KPB;
  *warps_b = nb * (RB_THREADS / 32);
  return (int)err;
}
