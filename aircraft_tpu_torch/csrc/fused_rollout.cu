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
// inputs).
//
// Design: one thread per scenario, the 838 folded MLP weights in shared
// memory (every thread of a block reads the same weight at the same time,
// a broadcast), the state in registers, each knot stored straight to its
// row of xs.  The knots of a scenario are serial, so the kernel is
// latency-bound at small B: a first, simple kernel.  Any B: the grid masks
// the ragged edge.  The constants block is WinConst with only its plant
// fields and N, dt, substeps filled.
#include <cstring>

#include "window_physics.cuh"

#define ROLL_THREADS 128

__global__ void __launch_bounds__(ROLL_THREADS)
fused_rollout_kernel(const WinConst C, const float* __restrict__ x0,
                     const float* __restrict__ us, const float* __restrict__ mlp,
                     float* __restrict__ xs, int B) {
  __shared__ float sW[MLP_FLOATS];
  for (int i = threadIdx.x; i < MLP_FLOATS; i += ROLL_THREADS) sW[i] = mlp[i];
  __syncthreads();
  const int b = blockIdx.x * ROLL_THREADS + threadIdx.x;
  if (b >= B) return;

  const int N = (int)C.N[0];
  const int nsub = (int)C.substeps[0];
  const float h = C.dt[0] / C.substeps[0];
  const float* xb = x0 + (size_t)b * 13;
  const float* ub = us + (size_t)b * N * UD;
  float* out = xs + (size_t)b * (N + 1) * 13;
  float x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    x[i] = xb[i];
    out[i] = x[i];
  }
  for (int k = 0; k < N; ++k) {
    float u[UD];
#pragma unroll
    for (int c = 0; c < UD; ++c) u[c] = ub[k * UD + c];
    for (int s = 0; s < nsub; ++s) rk4_norm(C, SharedMLP{sW}, x, u, h);
#pragma unroll
    for (int i = 0; i < 13; ++i) out[(k + 1) * 13 + i] = x[i];
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
  fused_rollout_kernel<<<(B + ROLL_THREADS - 1) / ROLL_THREADS, ROLL_THREADS, 0,
                         (cudaStream_t)stream>>>(C, x0, us, mlp, xs, B);
  return (int)cudaGetLastError();
}
