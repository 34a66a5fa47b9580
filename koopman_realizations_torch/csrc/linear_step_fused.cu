// One whole closed-loop step of the LINEAR Koopman MPC per lane in one
// launch: one CUDA thread per lane.
//
// Replaces the TPU kernel _linear_step_kernel (koopman_realizations_tpu/
// ops/pallas/step_fused.py:185, with _plant_freeze_epilogue :150; called
// at :362 by _linear_step_call, built by build_linear_step_fused :393).
// The linear controller's Hessian is static and lane-shared, so there is
// no per-lane Gram and no per-lane objective scale: the host folds 1/obj
// into the shared Hessian Psh and into the gradient generators.  Per lane:
// the poly lift of zeta, the reduced gradient
//   q = G1 [zeta; monomials; 1] + fYr + P21 u_prev
// (the PCA projection folded into G1; fYr = G2 Yr is this step's
// lane-shared reference column), b = cFr - F0r u_prev, the Mehrotra loop
// from COLD duals (lam = 1) against the shared Hessian, the ok mask, then
// the shared plant/freeze/carry tail: SDIRK2 of the arm on the PREVIOUS
// input, the markers, the alive freeze, the Pwarm @ x primal start and
// the dual carry lam (equilibrated units, unused by the next step).
//
// Bound on an H100: compute.  A lane-step needs ~3.5e4 operations (six
// Mehrotra iterations ~3e4, the gradient ~1e3, the plant ~4e3) on ~0.6 KB
// of carry read and written, so the f32 rate (67 TFLOP/s outside the
// tensor cores), not the 3.35 TB/s, sets the floor.  The design is the
// step_fused.cu one: everything per lane in registers or thread-local
// memory, the lane-shared Hessian, generators and constraint tables read
// as warp-uniform broadcasts through the read-only cache (the Hessian is
// never copied into per-lane storage, which frees the 144 floats the
// bilinear kernels hold), carries lanes-minor across steps.  Carries may
// be updated in place: every lane reads all of its inputs before it
// writes the same elements.
#include "kmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct LinearStepArgs {
  km::Cons con;
  const float* Psh;      // (KM_N, KM_N) reduced Hessian / obj
  const float* G1;       // (KM_N, KM_NCP) [G1z | G1m | G1b | 0] / obj
  const float* P21;      // (KM_N, KM_M) u_prev coupling / obj
  const float* cFr;      // (KM_MC)
  const float* F0r;      // (KM_MC, KM_M)
  const float* Pwarm;    // (KM_N, KM_N) receding-horizon primal shift
  const float* fYr;      // (KM_N) G2 @ Yr of this step
  km::StepIO io;         // carries; the dual carry in equilibrated units
  long long B;
  int iters;
};

__global__ void __launch_bounds__(KM_THREADS)
linear_step_fused_kernel(const LinearStepArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;

  float zeta[KM_NZ], up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.io.ysc[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.io.upsc[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.io.x0[i * B + b];

  // ---- gradient: lift, generators, reference column, u_prev coupling
  float q[KM_N];
  {
    float f[KM_NCP];
    km::lift_features(zeta, f);
#pragma unroll
    for (int i = 0; i < KM_N; ++i)
      q[i] = km::gen_row(a.G1 + i * KM_NCP, f) + km::ldg(a.fYr + i);
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
#pragma unroll
    for (int j = 0; j < KM_M; ++j)
      q[i] = fmaf(km::ldg(a.P21 + i * KM_M + j), up[j], q[i]);
  }
  km::rhs_b(a.cFr, a.F0r, up, rhs);

  // ---- QP from cold duals against the lane-shared Hessian
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) lam[c] = 1.0f;
  km::mehrotra(a.con, a.iters, 1e-2f, km::SharedHessian{a.Psh}, q, rhs, x,
               s, lam);
  const bool ok = km::ok_mask(a.con, rhs, x, s, lam);

  // ---- plant on the previous input, freeze, carry advance (lam as is)
  km::plant_freeze_epilogue(a.io, a.Pwarm, b, B, ok, zeta, up, x, lam, 1.0f);
}

extern "C" int km_linear_step_fused(const LinearStepArgs* args,
                                    void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  linear_step_fused_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
