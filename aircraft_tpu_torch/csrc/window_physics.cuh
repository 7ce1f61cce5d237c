// Device code shared by the two window kernels (window_backward.cu,
// window_forward.cu): the constants block, a forward-mode dual number, the
// 13-state glider derivative with the MLP or default aero coefficients,
// RK4 with quaternion renormalisation, the Catmull-Rom track lookup, and
// the MHTT knot function (plant step, residual rows, inequality rows,
// progress reward) and terminal cost.
//
// It is the CUDA counterpart of the row physics and knot functions that
// the TPU kernels inline: aircraft_tpu/kernels/rollout_kernel.py
// (_derivative_core, _rk4_norm, fold_mlp_constants, make_default_coeff)
// and aircraft_tpu/kernels/window_kernel.py (_make_knot_fns).  Its plain
// PyTorch twin is aircraft_tpu_torch/kernels/window.py (knot_outputs,
// al_stage_cost, terminal_cost).
//
// Every function is templated on its scalar: float in the forward kernel,
// Dual (value + one tangent) in the backward kernel, which takes the
// derivative jax.linearize gave on the TPU.  The derivative rules are
// JAX's: maximum/minimum/clip split the tangent evenly at a tie, abs has
// derivative +1 at 0, sign and floor have none, a select takes the tangent
// of the branch it picks, and the track segment index carries no tangent.
//
// The plant is also templated on its MLP evaluator (`Aero`): SharedMLP
// reads the folded weights from shared memory in one thread; the forward
// kernel passes one that spreads the MLP across a warp's lanes.  The plant
// and the knot function are inlined whole, and RK4 runs its four stages as
// a loop over one copy of the derivative, so a kernel holds one copy of
// the plant's code and the compiler allocates its registers in one piece.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// ---------------------------------------------------------------------------
// constants: one block of floats passed by value, its layout named once
// here and read back by the Python wrapper through <kernel>_layout()
// ---------------------------------------------------------------------------

#define WINDOW_CONSTS(F)                                                      \
  F(mass, 1) F(area, 1) F(span, 1) F(chord, 1) F(eps, 1) F(Cn_rudder, 1)      \
  F(com, 3) F(gravity, 3) F(J, 9) F(Jinv, 9) F(is_mlp, 1) F(dflt, 11)         \
  F(N, 1) F(substeps, 1) F(M, 1) F(dt, 1) F(L, 1) F(progress_correction, 1)   \
  F(dim_mask, 3) F(v_ref, 1) F(w_speed, 1) F(w_rate, 1) F(alpha_guard, 1)     \
  F(beta_guard, 1) F(stall_margin, 1) F(stall_factor, 1) F(speed_lo2, 1)      \
  F(speed_hi2, 1) F(lo_scale, 1) F(hi_scale, 1) F(alpha_lim, 1)               \
  F(beta_lim, 1) F(squash, 1) F(squash_mid, 7) F(squash_half, 7)              \
  F(include_box, 1) F(box_lb, 7) F(box_ub, 7) F(nr, 1) F(ng, 1) F(rcoef, 9)   \
  F(gain_clip, 1) F(n_alpha, 1) F(alphas, 16)

struct WinConst {
#define WC_DECL(name, n) float name[n];
  WINDOW_CONSTS(WC_DECL)
#undef WC_DECL
};

#define WC_NAME(name, n) #name ":" #n ","
#define WINDOW_EXPORTS(prefix)                                               \
  extern "C" const char* prefix##_layout() { return WINDOW_CONSTS(WC_NAME); } \
  extern "C" const char* kernel_error_string(int err) {                      \
    return cudaGetErrorString((cudaError_t)err);                              \
  }

// residual coefficients rcoef[]: sqrt(2 w) of each row family
enum { RC_TRACK, RC_BACK, RC_LOWV, RC_CTRL, RC_OVER, RC_SPEED, RC_STALL,
       RC_RATE, RC_GUARD };

#define XD 14
#define UD 7
#define NDIR 21
#define NR_MAX 20
#define NG_MAX 21
#define A_MAX 16
#define MLP_FLOATS 838

#define RHO 1.225f
#define DEG2RAD_F 0.017453292519943295f
#define C_D_FLAPS -0.1f
#define C_Z_FLAPS -0.6f
#define W_PROGRESS 5.0f
#define W_PROGRESS_RATE 2.0f
#define W_TERMINAL_ALIGN 20.0f
#define FREEZE_PENALTY 1e7f

// ---------------------------------------------------------------------------
// scalars: float and a forward-mode dual number
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
  __device__ __forceinline__ Dual(float v_ = 0.f, float d_ = 0.f) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return Dual(a.v * b.v, a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return Dual(a.v + b, a.d); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a + b.v, b.d); }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return Dual(a.v - b, a.d); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, float b) { return Dual(a.v / b, a.d / b); }

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  float s = sqrtf(x.v);
  return Dual(s, x.d * (0.5f / s));
}
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ Dual tanh_(Dual x) {
  float t = tanhf(x.v);
  return Dual(t, x.d * (1.f - t * t));
}
// the control squash's tanh: exactly +-1 with zero slope from |x| =
// TANH_ONE, as the reference's float32 tanh is (ops/elementwise.py)
#define TANH_ONE 7.9989f
__device__ __forceinline__ float sat_tanh_(float x) {
  return fabsf(x) >= TANH_ONE ? copysignf(1.f, x) : tanhf(x);
}
__device__ __forceinline__ Dual sat_tanh_(Dual x) {
  return fabsf(x.v) >= TANH_ONE ? Dual(copysignf(1.f, x.v), 0.f) : tanh_(x);
}
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  float den = x.v * x.v + y.v * y.v;
  return Dual(atan2f(y.v, x.v), y.d * (x.v / den) - x.d * (y.v / den));
}
__device__ __forceinline__ float asin_(float x) { return asinf(x); }
__device__ __forceinline__ Dual asin_(Dual x) {
  return Dual(asinf(x.v), x.d * (1.f / sqrtf(1.f - x.v * x.v)));
}
// NaN-propagating max/min, tie splits the tangent
__device__ __forceinline__ float max_(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ Dual max_(Dual a, Dual b) {
  if (a.v > b.v || a.v != a.v) return a;
  if (a.v < b.v || b.v != b.v) return b;
  return Dual(a.v, 0.5f * (a.d + b.d));
}
__device__ __forceinline__ Dual min_(Dual a, Dual b) {
  if (a.v < b.v || a.v != a.v) return a;
  if (a.v > b.v || b.v != b.v) return b;
  return Dual(a.v, 0.5f * (a.d + b.d));
}
__device__ __forceinline__ Dual max_(Dual a, float b) { return max_(a, Dual(b)); }
__device__ __forceinline__ Dual min_(Dual a, float b) { return min_(a, Dual(b)); }
template <class T>
__device__ __forceinline__ T clip_(T x, float lo, float hi) { return min_(max_(x, lo), hi); }
template <class T>
__device__ __forceinline__ T abs_(T x) { return val(x) >= 0.f ? x : -x; }
__device__ __forceinline__ float sign_(float x) { return (float)((x > 0.f) - (x < 0.f)); }
// |t| <= lim and finite, else 0 for non-finite
__device__ __forceinline__ float sanitize(float t, float lim) {
  return isfinite(t) ? fminf(fmaxf(t, -lim), lim) : 0.f;
}

// ---------------------------------------------------------------------------
// plant
// ---------------------------------------------------------------------------

// the 5-16-32-6 tanh MLP with its scalers folded into the first and last
// layers; W = [w0f (5x16), b0f (16), w1 (16x32), b1 (32), w2f (32x6), b2f (6)]
template <class T>
__device__ __forceinline__ void mlp6(const float* __restrict__ W, const T in[5], T out[6]) {
  const float* w0 = W;
  const float* b0 = W + 80;
  const float* w1 = W + 96;
  const float* b1 = W + 608;
  const float* w2 = W + 640;
  const float* b2 = W + 832;
  T h1[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    T acc = in[0] * w0[j] + b0[j];
#pragma unroll
    for (int i = 1; i < 5; ++i) acc = acc + in[i] * w0[i * 16 + j];
    h1[j] = acc;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    T acc = h1[0] * w1[j] + b1[j];
#pragma unroll
    for (int i = 1; i < 16; ++i) acc = acc + h1[i] * w1[i * 32 + j];
    T h2 = tanh_(acc);
#pragma unroll
    for (int o = 0; o < 6; ++o)
      out[o] = (j == 0) ? h2 * w2[o] + b2[o] : out[o] + h2 * w2[j * 6 + o];
  }
}

// the MLP evaluated by one thread from the weights W (shared memory).  The
// weights are read through an offset the compiler cannot see is 0, fresh
// at every call: otherwise it hoists the 838 loop-invariant reads out of
// the RK4 stage loop into registers, which spill to local memory.
struct SharedMLP {
  const float* __restrict__ W;
  template <class T>
  __device__ __forceinline__ void operator()(const T in[5], T out[6]) const {
    int off;
    asm volatile("mov.b32 %0, 0;" : "=r"(off));
    mlp6(W + off, in, out);
  }
};

// body-frame relative flow (+eps), its squared norm, alpha and beta
template <class T>
__device__ __forceinline__ void rel_flow(const WinConst& C, const T* x, T& vr0, T& vsq,
                                         T& alpha, T& beta) {
  const float eps = C.eps[0];
  T v0 = x[3], v1 = x[4], v2 = x[5];
  T ux = -x[6], uy = -x[7], uz = -x[8], qw = x[9];
  T tx = 2.f * (uy * v2 - uz * v1);
  T ty = 2.f * (uz * v0 - ux * v2);
  T tz = 2.f * (ux * v1 - uy * v0);
  vr0 = v0 + qw * tx + (uy * tz - uz * ty) + eps;
  T vr1 = v1 + qw * ty + (uz * tx - ux * tz) + eps;
  T vr2 = v2 + qw * tz + (ux * ty - uy * tx) + eps;
  vsq = vr0 * vr0 + vr1 * vr1 + vr2 * vr2;
  T airspeed = sqrt_(vsq + eps);
  alpha = atan2_(vr2, vr0 + eps);
  beta = asin_(clip_(vr1 / airspeed, -1.f, 1.f));
}

// xdot of the 13-state plant: relative flow, aero coefficients, forces and
// moments with com x F, Newton-Euler with the precomputed J and J^-1
template <class T, class Aero>
__device__ __forceinline__ void derivative13(const WinConst& C, const Aero& aero, const T* x,
                                             const T* u, T* out) {
  T wx = x[10], wy = x[11], wz = x[12];
  T qx = x[6], qy = x[7], qz = x[8], qw = x[9];
  T vr0, vsq, alpha, beta;
  rel_flow(C, x, vr0, vsq, alpha, beta);
  T qbar = 0.5f * RHO * vsq;
  T co[6];
  if (C.is_mlp[0] != 0.f) {
    T in[5] = {qbar, alpha, beta, u[0], u[1]};
    aero(in, co);
    co[5] = co[5] + C.Cn_rudder[0] * 6.f * u[2] * DEG2RAD_F;
  } else {
    const float* d = C.dflt;  // CD0 CDa CL0 CLa CYb Clail Clp Cmel Cmq Cnrud Cnr
    co[0] = -(d[0] + d[1] * alpha * alpha);
    co[1] = d[4] * beta;
    co[2] = -(d[2] + d[3] * alpha);
    co[3] = d[5] * 4.f * u[0] * DEG2RAD_F + d[6] * wx;
    co[4] = d[7] * 5.f * u[1] * DEG2RAD_F + d[8] * wy;
    co[5] = d[9] * 6.f * u[2] * DEG2RAD_F + d[10] * wz;
  }
  T c0 = co[0] + C_D_FLAPS * u[6];
  T c2 = co[2] + C_Z_FLAPS * u[6];
  T qS = qbar * C.area[0];
  T f0 = c0 * qS * sign_(val(vr0));
  T f1 = co[1] * qS;
  T f2 = c2 * qS;
  const float cx = C.com[0], cy = C.com[1], cz = C.com[2];
  T m0 = co[3] * qS * C.span[0] + (cy * f2 - cz * f1);
  T m1 = co[4] * qS * C.chord[0] + (cz * f0 - cx * f2);
  T m2 = co[5] * qS * C.span[0] + (cx * f1 - cy * f0);
  T tx = 2.f * (qy * f2 - qz * f1);
  T ty = 2.f * (qz * f0 - qx * f2);
  T tz = 2.f * (qx * f1 - qy * f0);
  const float inv_m = 1.f / C.mass[0];
  out[0] = x[3];
  out[1] = x[4];
  out[2] = x[5];
  out[3] = (f0 + qw * tx + (qy * tz - qz * ty)) * inv_m + C.gravity[0];
  out[4] = (f1 + qw * ty + (qz * tx - qx * tz)) * inv_m + C.gravity[1];
  out[5] = (f2 + qw * tz + (qx * ty - qy * tx)) * inv_m + C.gravity[2];
  out[6] = 0.5f * (qw * wx + qy * wz - qz * wy);
  out[7] = 0.5f * (qw * wy - qx * wz + qz * wx);
  out[8] = 0.5f * (qw * wz + qx * wy - qy * wx);
  out[9] = 0.5f * (-qx * wx - qy * wy - qz * wz);
  const float* J = C.J;
  const float* Ji = C.Jinv;
  T Jw0 = J[0] * wx + J[1] * wy + J[2] * wz;
  T Jw1 = J[3] * wx + J[4] * wy + J[5] * wz;
  T Jw2 = J[6] * wx + J[7] * wy + J[8] * wz;
  T t0 = m0 - (wy * Jw2 - wz * Jw1);
  T t1 = m1 - (wz * Jw0 - wx * Jw2);
  T t2 = m2 - (wx * Jw1 - wy * Jw0);
  out[10] = Ji[0] * t0 + Ji[1] * t1 + Ji[2] * t2;
  out[11] = Ji[3] * t0 + Ji[4] * t1 + Ji[5] * t2;
  out[12] = Ji[6] * t0 + Ji[7] * t1 + Ji[8] * t2;
}

// one RK4 step of length h on x[0..12] in place, then renormalise q.  The
// four stages are a loop over one copy of the derivative: stage st reads
// xt = x + c_st k_(st-1) and adds w_st k_st to acc (w = 1, 2, 2, 1), so
// acc sums k1 + 2 k2 + 2 k3 + k4 in that order.
template <class T, class Aero>
__device__ __forceinline__ void rk4_norm(const WinConst& C, const Aero& aero, T* x, const T* u,
                                         float h) {
  T k[13], acc[13], xt[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) xt[i] = x[i];
#pragma unroll 1
  for (int st = 0; st < 4; ++st) {
    derivative13(C, aero, xt, u, k);
    const float c = st == 2 ? h : 0.5f * h;
#pragma unroll
    for (int i = 0; i < 13; ++i) {
      if (st == 0) acc[i] = k[i];
      else if (st == 3) acc[i] = acc[i] + k[i];
      else acc[i] = acc[i] + 2.f * k[i];
      xt[i] = x[i] + c * k[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = x[i] + (h / 6.f) * acc[i];
  T inv = 1.f / sqrt_(x[6] * x[6] + x[7] * x[7] + x[8] * x[8] + x[9] * x[9] + 1e-12f);
#pragma unroll
  for (int i = 6; i < 10; ++i) x[i] = x[i] * inv;
}

// Catmull-Rom position and d/ds at progress s: row i = clip(floor(u), 0,
// M-2) of the pre-shifted table (M, 12) read directly
template <class T>
__device__ __forceinline__ void track(const WinConst& C, const float* __restrict__ table, T s,
                                      T pos[3], T tng[3]) {
  const float Mf = C.M[0];
  T u = clip_(s, 0.f, 1.f) * (Mf - 1.f);
  float fi = fminf(fmaxf(floorf(val(u)), 0.f), Mf - 2.f);
  const float* row = table + (int)fi * 12;
  T t = u - fi;
  T t2 = t * t;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float p0 = __ldg(row + d), p1 = __ldg(row + 3 + d), p2 = __ldg(row + 6 + d),
          p3 = __ldg(row + 9 + d);
    float a1 = -p0 + p2, a2 = 2.f * p0 - 5.f * p1 + 4.f * p2 - p3,
          a3 = -p0 + 3.f * p1 - 3.f * p2 + p3;
    pos[d] = 0.5f * ((2.f * p1 + a1 * t) + a2 * t2 + a3 * (t2 * t));
    tng[d] = (0.5f * ((a1 + 2.f * a2 * t) + 3.f * a3 * t2)) * (Mf - 1.f);
  }
}

// ---------------------------------------------------------------------------
// the knot function
// ---------------------------------------------------------------------------

// Plant step, residual rows and inequality rows of one knot.  The next
// state goes to xn[14], each residual row to sink.res(), each inequality
// row to sink.ineq() (rows in envelope_ineq's order); returns the progress
// reward `rest`.  Everything that reads x comes before the plant step, so
// only u and the integrated state are live while it runs.
template <class T, class Aero, class Sink>
__device__ __forceinline__ T knot(const WinConst& C, const Aero& aero,
                                  const float* __restrict__ table, const T* x, const T* w,
                                  float rf, T* xn, Sink& sink) {
  T u[UD];
#pragma unroll
  for (int c = 0; c < UD; ++c) {
    if (C.squash[0] == 0.f) u[c] = w[c];
    else if (C.squash_half[c] == 0.f) u[c] = T(C.squash_mid[c]);
    else u[c] = C.squash_mid[c] + C.squash_half[c] * sat_tanh_(w[c]);
  }
  const float Linv = 1.f / C.L[0];
  const float* dm = C.dim_mask;
  T s = x[13];
  T pos[3], tng[3];
  track(C, table, s, pos, tng);
  T tg0 = tng[0] * (dm[0] * Linv), tg1 = tng[1] * (dm[1] * Linv), tg2 = tng[2] * (dm[2] * Linv);
  T tnorm = sqrt_(tg0 * tg0 + tg1 * tg1 + tg2 * tg2);
  T denom = val(tnorm) > 1e-3f ? tnorm : T(1.f);
  T td0 = tg0 / denom, td1 = tg1 / denom, td2 = tg2 / denom;
  T s_dot = (x[3] * td0 + x[4] * td1 + x[5] * td2) * Linv;
  T pe0 = (x[0] - pos[0]) * dm[0], pe1 = (x[1] - pos[1]) * dm[1], pe2 = (x[2] - pos[2]) * dm[2];
  T corr = (pe0 * td0 + pe1 * td1 + pe2 * td2) * Linv;

  // residual rows (build_mhtt_ocp's stage_residuals order)
  const float* rc = C.rcoef;
  T zero(0.f);
  T speed = sqrt_(x[3] * x[3] + x[4] * x[4] + x[5] * x[5]);
  T vr0, vsq, alpha, beta;
  rel_flow(C, x, vr0, vsq, alpha, beta);
  sink.res(rc[RC_TRACK] * pe0);
  sink.res(rc[RC_TRACK] * pe1);
  sink.res(rc[RC_TRACK] * pe2);
  sink.res(rc[RC_BACK] * max_(zero, -s_dot));
  sink.res(rc[RC_LOWV] * max_(0.1f - speed, zero));
#pragma unroll
  for (int c = 0; c < UD; ++c) sink.res(rc[RC_CTRL] * u[c]);
  sink.res(rc[RC_OVER] * max_(speed - 110.f, zero));
  if (C.w_speed[0] > 0.f) {
    sink.res(rc[RC_SPEED] * (speed - C.v_ref[0]));
    sink.res(rc[RC_STALL] * max_((C.v_ref[0] - C.stall_margin[0]) - speed, zero));
  }
  if (C.w_rate[0] > 0.f) {
    sink.res(rc[RC_RATE] * x[10]);
    sink.res(rc[RC_RATE] * x[11]);
    sink.res(rc[RC_RATE] * x[12]);
  }
  if (C.alpha_guard[0] > 0.f) sink.res(rc[RC_GUARD] * max_(abs_(alpha) - C.alpha_guard[0], zero));
  if (C.beta_guard[0] > 0.f) sink.res(rc[RC_GUARD] * max_(abs_(beta) - C.beta_guard[0], zero));

  // inequality rows (envelope_ineq): AL control box first when on
  if (C.include_box[0] != 0.f) {
#pragma unroll
    for (int c = 0; c < UD; ++c) sink.ineq(u[c] - C.box_ub[c]);
#pragma unroll
    for (int c = 0; c < UD; ++c) sink.ineq(C.box_lb[c] - u[c]);
  }
  sink.ineq((C.speed_lo2[0] - vsq) * C.lo_scale[0]);
  sink.ineq((vsq - C.speed_hi2[0]) * C.hi_scale[0]);
  sink.ineq(beta - C.beta_lim[0]);
  sink.ineq(-C.beta_lim[0] - beta);
  sink.ineq(alpha - C.alpha_lim[0]);
  sink.ineq(-C.alpha_lim[0] - alpha);
  sink.ineq(x[2]);

  const T rest = (-W_PROGRESS * s - W_PROGRESS_RATE * (0.5f * tanh_(s_dot / 0.5f))) * rf;

  // plant step: Euler progress, then RK4 x substeps of the 13-state plant
  xn[13] = clip_(s + s_dot * C.dt[0] + C.progress_correction[0] * corr, 0.f, 1.05f);
#pragma unroll
  for (int i = 0; i < 13; ++i) xn[i] = x[i];
  const int nsub = (int)C.substeps[0];
  const float h = C.dt[0] / C.substeps[0];
  for (int sub = 0; sub < nsub; ++sub) rk4_norm(C, aero, xn, u, h);
  return rest;
}

// W_TERMINAL_ALIGN * |(p - track(s)) * mask + 1e-9| - 10 W_PROGRESS s
__device__ __forceinline__ float terminal_cost(const WinConst& C, const float* __restrict__ table,
                                               const float* x) {
  float pos[3], tng[3];
  track(C, table, x[13], pos, tng);
  const float* dm = C.dim_mask;
  float e0 = (x[0] - pos[0]) * dm[0] + 1e-9f;
  float e1 = (x[1] - pos[1]) * dm[1] + 1e-9f;
  float e2 = (x[2] - pos[2]) * dm[2] + 1e-9f;
  return W_TERMINAL_ALIGN * sqrtf(e0 * e0 + e1 * e1 + e2 * e2) - W_PROGRESS * 10.f * x[13];
}
