// One whole closed-loop MPC step per lane in one launch: one CUDA thread
// per lane.
//
// Replaces the TPU kernel _step_kernel (koopman_realizations_tpu/ops/
// pallas/step_fused.py:90, with _plant_freeze_epilogue :150 and
// _markers_rows :61; called at :299 by _step_call): poly lift, QP assembly,
// factored Gram, objective scale, banded A^T D A, Mehrotra with the
// sqrt-damped dual warm start, the ok mask, SDIRK2 of the arm on the
// PREVIOUS input, the marker outputs, the alive freeze and the carry
// advance (Pwarm @ x primal start, lam * obj dual carry).
//
// Bound on an H100: compute.  A lane-step needs ~7.0e4 operations (QP
// ~6.6e4 counting only the nonzeros of the shared operands, plant ~4e3)
// on ~0.6 KB of carry read and written, so at B=262144 the floor is
// ~0.28 ms of f32 arithmetic against ~0.05 ms of memory traffic.  As
// written the kernel does ~1.2e5: it also multiplies the structural
// zeros of the generators (stages no move reaches) and of A, Wd, Wo.
// The design is the simple one: the QP and the plant are independent
// within a step (the plant consumes the previous input), they run back to
// back in one thread with everything per lane in registers or thread-local
// memory, the shared generators are warp-uniform broadcasts through the
// read-only cache, and the carries stay lanes-minor across steps so no
// transposes exist between launches.  Carries may be updated in place:
// every lane reads all of its inputs before it writes the same elements.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct StepArgs {
  km::QP qp;
  const float* Pwarm;    // (KM_N, KM_N) receding-horizon primal shift
  const float* ysc;      // (KM_NY, B) scaled outputs == zeta
  const float* upsc;     // (KM_M, B) previous input, scaled
  const float* xpl;      // (KM_NX, B) plant state
  const float* w;        // (2, B) loads
  const float* alive;    // (B) 1 / 0
  const float* x0;       // (KM_N, B) primal start
  const float* lamc;     // (KM_MC, B) dual carry, row-equilibrated * obj
  const float* yp;       // (KM_NPROJ, B) tracked outputs
  const float* sqYr;     // (KM_P) shared or (KM_P, B) per lane
  float* ysc_o;
  float* upsc_o;
  float* xpl_o;
  float* alive_o;
  float* x0_o;
  float* lamc_o;
  float* yp_o;
  long long B;
  int sqYr_lanes;
  int iters;
};

__global__ void __launch_bounds__(KM_THREADS)
step_fused_kernel(const StepArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  constexpr float UF[KM_M] = KM_UF;
  constexpr float UO[KM_M] = KM_UO;
  constexpr float YF[KM_NY] = KM_YF;
  constexpr float YO[KM_NY] = KM_YO;
  constexpr int PROJ[KM_NPROJ] = KM_PROJ;

  // ---- QP (zeta == scaled y; the dual carry is damped toward cold)
  float zeta[KM_NZ], up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.ysc[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.upsc[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.x0[i * B + b];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) lam[c] = a.lamc[c * B + b];
  const float* sq = a.sqYr_lanes ? a.sqYr + b : a.sqYr;
  const long long sq_step = a.sqYr_lanes ? B : 1;
  const float obj = km::solve_qp(a.qp, a.iters, 1e-2f, true, zeta, up, sq,
                                 sq_step, x, s, lam, rhs);
  const bool ok = km::ok_mask(a.qp, rhs, x, s, lam);

  // ---- plant: SDIRK2 on the previous input (original units)
  float xs[KM_NX], u[KM_M];
#pragma unroll
  for (int i = 0; i < KM_NX; ++i) xs[i] = a.xpl[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) u[j] = up[j] * UF[j] + UO[j];
  km::sdirk2(xs, u, a.w[b], a.w[B + b]);
  bool fin = true;
#pragma unroll
  for (int i = 0; i < KM_NX; ++i) fin = fin && isfinite(xs[i]);
  float y[KM_NY];
  km::arm_outputs(xs, y);

  // ---- freeze dead lanes, advance the carries
  const bool keep = (a.alive[b] > 0.5f) && ok && fin;
  a.alive_o[b] = keep ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 0; i < KM_NX; ++i)
    a.xpl_o[i * B + b] = keep ? xs[i] : a.xpl[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_NY; ++j)
    a.ysc_o[j * B + b] = keep ? km::kdiv(y[j] - YO[j], YF[j]) : zeta[j];
#pragma unroll
  for (int j = 0; j < KM_NPROJ; ++j)
    a.yp_o[j * B + b] = keep ? y[PROJ[j]] : a.yp[j * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) a.upsc_o[j * B + b] = keep ? x[j] : up[j];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < KM_N; ++j) acc = fmaf(km::ldg(a.Pwarm + i * KM_N + j), x[j], acc);
    a.x0_o[i * B + b] = keep ? acc : a.x0[i * B + b];
  }
#pragma unroll
  for (int c = 0; c < KM_MC; ++c)
    a.lamc_o[c * B + b] = keep ? lam[c] * obj : a.lamc[c * B + b];
}

extern "C" int km_step_fused(const StepArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  step_fused_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
