// Assembly-fused bilinear MPC QP from the lifted state, batched: one CUDA
// thread per lane.
//
// Replaces the TPU kernel _bilin_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:998, called at :2089 by solve_qp_bilinear_batched),
// the first pass of the bilinear controller with iterated relinearization
// (bilinear_iters > 1, blocked): from the lane's lifted state z and
// previous input it assembles W = unflatten(PGWb z), v = PAsq z - sqYr +
// CB0 u_prev and b = cFr - F0r u_prev against the lane-shared generators,
// forms the factored Gram, the objective scale, the banded A^T D A and
// runs the Mehrotra loop with the sqrt-damped dual warm start.  The ok
// mask and the multipliers' return to original units run in the wrapper
// (ops/kernels/bilin.py), as in the JAX wrapper.  The TPU kernel's bf16
// hi/lo GEMMs (_split_bf16, _dot3) have no counterpart: the assembly is
// f32 FMAs.
//
// Bound on an H100: compute.  At the blocked shape (NL=28, p=22, n=12,
// mc=48, 4 iterations) a lane needs ~3.8e4 operations on ~0.8 KB of lane
// input and output.  The design is bilin_lift.cu's with the lifted state
// in place of the lift's features (km::StateFeatures): the 352 x 28
// generator stack is read as warp-uniform 16-byte broadcasts through the
// read-only cache, its all-zero rows skipped, W is streamed row by row
// into the Gram and never held, and every per-lane load and store is
// coalesced (lanes-minor).
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct BilinArgs {
  km::QP qp;
  const float* z;      // (KM_NZL, B) lifted state
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
bilin_kernel(const BilinArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  float up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.x0[i * B + b];
  const bool warm = a.lam0 != nullptr;
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) lam[c] = warm ? a.lam0[c * B + b] : 1.0f;
  const float* sq = a.sqYr_lanes ? a.sqYr + b : a.sqYr;
  const long long sq_step = a.sqYr_lanes ? B : 1;
  const float obj = km::solve_qp(a.qp, a.iters, a.slack_floor, warm,
                                 km::StateFeatures{a.z + b, B}, up, sq,
                                 sq_step, x, s, lam, rhs);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
  KM_ROWS
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
  a.obj[b] = obj;
}

extern "C" int km_bilin(const BilinArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  bilin_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
