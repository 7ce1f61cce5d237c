// Whole-horizon open-loop rollout of the 13-state glider with the MLP aero
// surrogate: xs (B, N+1, 13) from x0 (B, 13) and us (B, N, 7), float32.
//
// Replaces both TPU rollout kernels of aircraft_tpu/kernels/rollout_kernel.py:
// make_fused_rollout (pl.pallas_call at :320, batch on lanes, MLP on the
// MXU) and make_fused_rollout_tiles (:530, (group, 128) tiles, MLP as SMEM
// FMA chains).  Both compute the same function; their layouts are TPU
// occupancy choices, so one kernel backs both.  Each knot applies
// rk4_norm<float> of window_physics.cuh `substeps` times (RK4 of length
// dt / substeps, then the quaternion renormalised) and stores the state.
//
// Bound on an H100: operations.  One RK4 substep evaluates the plant four
// times (about 1.8 kFLOP each, mostly the 5-16-32-6 MLP), so B = 1024,
// N = 50, ten substeps is about 3.7 GFLOP against 4 MB moved: about 55 us
// at the 67 TFLOP/s fp32 peak (chip_smoke.py computes the bound from its
// inputs).  What bounds the kernel is the length of one scenario's chain:
// N * substeps * 4 plant evaluations, one after the other, while the
// scenarios all run at once.
//
// Design: a group of G = 8 lanes per scenario, ROLL_THREADS / G = 16
// scenarios per block (G = 16 and 32 were measured too and lost: PERF.md).
// The plant's MLP is spread across the group (GroupMLP): each lane keeps
// its share of the weights in registers, loaded once, computes its
// first-layer units, takes the 16 first-layer outputs by shuffles inside
// the group, computes its second-layer units and its part of the six
// outputs, and a xor butterfly inside the group sums them, which leaves
// the same bits in every lane.  Every lane carries the rest of the plant
// and the state redundantly, so the group never diverges.  Lane i of the
// group loads control i of each knot and the group shares them by
// shuffle; state element i of each knot is stored by lane i mod G.  A
// group past the end of the batch computes a copy of the last scenario and
// stores nothing, so every shuffle has its whole warp.  The constants
// block is WinConst with only its plant fields and N, dt, substeps filled.
#include <cstring>

#include "window_physics.cuh"

#define ROLL_THREADS 128
#define FULL_MASK 0xffffffffu

constexpr int G = 8;                   // lanes per scenario
constexpr int SPB = ROLL_THREADS / G;  // scenarios per block

// the 5-16-32-6 MLP spread across a group of G lanes.  Lane l holds
// first-layer units (l + G u) mod 16 for u < U1, second-layer units l + G v
// for v < U2 (their columns of w1 and rows of w2).  At G = 32 this would
// be window_forward.cu's LaneMLP.
struct GroupMLP {
  static constexpr int U1 = G >= 16 ? 1 : 16 / G;
  static constexpr int U2 = 32 / G;
  float w0[U1][5], b0[U1], w1[U2][16], b1[U2], w2[U2][6], b2[6];

  __device__ __forceinline__ void load(const float* __restrict__ W, int l) {
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      const int j = (l + G * u) & 15;
#pragma unroll
      for (int i = 0; i < 5; ++i) w0[u][i] = W[i * 16 + j];
      b0[u] = W[80 + j];
    }
#pragma unroll
    for (int v = 0; v < U2; ++v) {
      const int j = l + G * v;
#pragma unroll
      for (int i = 0; i < 16; ++i) w1[v][i] = W[96 + i * 32 + j];
      b1[v] = W[608 + j];
#pragma unroll
      for (int o = 0; o < 6; ++o) w2[v][o] = W[640 + j * 6 + o];
    }
#pragma unroll
    for (int o = 0; o < 6; ++o) b2[o] = W[832 + o];
  }

  __device__ __forceinline__ void operator()(const float in[5], float out[6]) const {
    float h1[U1];
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      float a = in[0] * w0[u][0] + b0[u];
#pragma unroll
      for (int i = 1; i < 5; ++i) a = a + in[i] * w0[u][i];
      h1[u] = a;
    }
    // first-layer unit j lives in lane j mod G, slot j / G
    float hin[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) hin[j] = __shfl_sync(FULL_MASK, h1[j / G], j % G, G);
    float p[6];
#pragma unroll
    for (int v = 0; v < U2; ++v) {
      float acc = hin[0] * w1[v][0] + b1[v];
#pragma unroll
      for (int i = 1; i < 16; ++i) acc = acc + hin[i] * w1[v][i];
      const float h2 = tanhf(acc);
#pragma unroll
      for (int o = 0; o < 6; ++o) p[o] = v == 0 ? h2 * w2[v][o] : p[o] + h2 * w2[v][o];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int o = 0; o < 6; ++o) p[o] = p[o] + __shfl_xor_sync(FULL_MASK, p[o], off, G);
    }
#pragma unroll
    for (int o = 0; o < 6; ++o) out[o] = p[o] + b2[o];
  }
};

__global__ void __launch_bounds__(ROLL_THREADS)
fused_rollout_kernel(const WinConst C, const float* __restrict__ x0,
                     const float* __restrict__ us, const float* __restrict__ mlp,
                     float* __restrict__ xs, int B) {
  const int b = blockIdx.x * SPB + threadIdx.x / G;
  const int l = threadIdx.x % G;
  const bool live = b < B;
  const int bs = live ? b : B - 1;  // past the end: a copy of the last

  GroupMLP aero;
  aero.load(mlp, l);
  const int N = (int)C.N[0];
  const int nsub = (int)C.substeps[0];
  const float h = C.dt[0] / C.substeps[0];
  const float* ub = us + (size_t)bs * N * UD;
  float* out = xs + (size_t)b * (N + 1) * 13;
  float x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = x0[(size_t)bs * 13 + i];
  if (live) {
#pragma unroll
    for (int i = 0; i < 13; ++i)
      if (i % G == l) out[i] = x[i];
  }
  for (int k = 0; k < N; ++k) {
    const float mine = l < UD ? ub[k * UD + l] : 0.f;
    float u[UD];
#pragma unroll
    for (int c = 0; c < UD; ++c) u[c] = __shfl_sync(FULL_MASK, mine, c, G);
    for (int s = 0; s < nsub; ++s) rk4_norm(C, aero, x, u, h);
    if (live) {
#pragma unroll
      for (int i = 0; i < 13; ++i)
        if (i % G == l) out[(k + 1) * 13 + i] = x[i];
    }
  }
}

WINDOW_EXPORTS(fused_rollout)

extern "C" int fused_rollout_launch(const float* consts, int nconst, const float* x0,
                                    const float* us, const float* mlp, float* xs, int B,
                                    void* stream) {
  if ((size_t)nconst * sizeof(float) != sizeof(WinConst)) return (int)cudaErrorInvalidValue;
  WinConst C;
  memcpy(&C, consts, sizeof(WinConst));
  if (C.is_mlp[0] == 0.f || C.N[0] < 1.f || C.substeps[0] < 1.f)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  fused_rollout_kernel<<<(B + SPB - 1) / SPB, ROLL_THREADS, 0, (cudaStream_t)stream>>>(
      C, x0, us, mlp, xs, B);
  return (int)cudaGetLastError();
}
