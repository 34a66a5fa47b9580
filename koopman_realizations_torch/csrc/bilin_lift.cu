// Lift-fused bilinear MPC QP, batched: one CUDA thread per lane.
//
// Replaces the TPU kernel _bilin_lift_kernel (koopman_realizations_tpu/
// ops/pallas/qp_ipm.py:772, called at :951 by
// solve_qp_bilinear_lifted_batched): poly lift of the raw zeta, QP
// assembly against the lane-shared generators, factored Gram, objective
// scale, banded A^T D A and the Mehrotra loop.  The ok mask and the
// multipliers' return to original units run in the wrapper
// (ops/kernels/bilin_lift.py), as they do in the JAX wrapper.
//
// Bound on an H100: compute.  At the bench shape (n=12, mc=48, p=22,
// 84 generator columns, 4 iterations) a lane needs ~6.6e4 operations
// (the kernel does ~1.1e5, structural zeros of the shared operands
// included) on ~0.5 KB of lane input and output, so the card's f32 rate
// (67 TFLOP/s outside the tensor cores), not its 3.35 TB/s, sets the
// floor.  The design keeps
// every per-lane intermediate in registers or thread-local memory (the
// p*n W block is streamed row by row into the Gram, never stored), reads
// the 118 KB of shared generators as warp-uniform 16-byte broadcasts
// through the read-only cache, and makes per-lane loads coalesced through
// the lanes-minor layout.  Occupancy and local-memory spills are what a
// later tuning pass has to work on.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct BilinLiftArgs {
  km::QP qp;
  const float* zeta;   // (KM_NZ, B)
  const float* up;     // (KM_M, B) previous input, scaled
  const float* x0;     // (KM_N, B) primal start
  const float* lam0;   // (KM_MC, B) dual start * row, or null (cold)
  const float* sqYr;   // (KM_P) shared or (KM_P, B) per lane
  float* x;            // (KM_N, B)
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
  float* obj;          // (B) objective scale
  long long B;
  int sqYr_lanes;
  int iters;
  float slack_floor;
};

__global__ void __launch_bounds__(KM_THREADS)
bilin_lift_kernel(const BilinLiftArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  float zeta[KM_NZ], up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.zeta[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.x0[i * B + b];
  const bool warm = a.lam0 != nullptr;
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) lam[c] = warm ? a.lam0[c * B + b] : 1.0f;
  const float* sq = a.sqYr_lanes ? a.sqYr + b : a.sqYr;
  const long long sq_step = a.sqYr_lanes ? B : 1;
  const float obj = km::solve_qp(a.qp, a.iters, a.slack_floor, warm, zeta, up,
                                 sq, sq_step, x, s, lam, rhs);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
  a.obj[b] = obj;
}

extern "C" int km_bilin_lift(const BilinLiftArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  bilin_lift_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
