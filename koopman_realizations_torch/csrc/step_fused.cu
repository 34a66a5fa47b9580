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
  const float* sqYr;     // (KM_P) shared or (KM_P, B) per lane
  km::StepIO io;         // carries; the dual carry in row-eq. * obj units
  long long B;
  int sqYr_lanes;
  int iters;
};

__global__ void __launch_bounds__(KM_THREADS)
step_fused_kernel(const StepArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;

  // ---- QP (zeta == scaled y; the dual carry is damped toward cold)
  float zeta[KM_NZ], up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.io.ysc[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.io.upsc[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.io.x0[i * B + b];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) lam[c] = a.io.lamc[c * B + b];
  const float* sq = a.sqYr_lanes ? a.sqYr + b : a.sqYr;
  const long long sq_step = a.sqYr_lanes ? B : 1;
  const float obj = km::solve_qp(a.qp, a.iters, 1e-2f, true,
                                 km::LiftFeatures{zeta}, up, sq, sq_step, x,
                                 s, lam, rhs);
  const bool ok = km::ok_mask(a.qp.con, rhs, x, s, lam);

  // ---- plant on the previous input, freeze, carry advance (lam * obj)
  km::plant_freeze_epilogue(a.io, a.Pwarm, b, B, ok, zeta, up, x, lam, obj);
}

extern "C" int km_step_fused(const StepArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  step_fused_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
