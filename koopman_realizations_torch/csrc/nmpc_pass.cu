// One SQP pass of the NMPC from shipped stage Jacobians and defects,
// batched: one CUDA thread per lane.
//
// Replaces the TPU kernel _nmpc_kernel (koopman_realizations_tpu/ops/
// pallas/qp_ipm.py:1144, called at :1340 by solve_qp_nmpc_batched), which
// the JAX controller's per-pass loop launches for chord passes
// (sqp_jac_period > 1, control/kmpc.py:1451-1457 and :1520-1525): the
// stage Jacobians are formed outside the kernel every jac_period passes
// and frozen in between, the defects fresh at every pass.  The kernel
// reads Jt (KN_NP, KN_NZA, KN_NZ) with Jt[k][i][o] = dF_o/dx_i and cv
// (KN_NP, KN_NZ) per lane, runs the sensitivity condensation streamed into
// the factored Gram with the pass's rdiag, the per-lane Levenberg term q0
// (optional), the objective scale and the Mehrotra loop from the shipped
// x0 with cold duals or a warm lam0 (row-equilibrated units,
// qp_ipm.py:1217-1220).  The wrapper (ops/kernels/nmpc_pass.py:
// solve_qp_nmpc_pass) scales lam0 by the rows, forms the ok mask and
// returns the multipliers in original units.
//
// Bound on an H100: memory, barely.  A lane needs ~0.05 M operations
// (the sweep and 8 Mehrotra iterations; chip_smoke.py:nmpc_onepass_ops)
// on ~3 KB of lane input and output (Jt alone is 540 floats): ~18
// operations per byte against the card's 67 TFLOP/s / 3.35 TB/s = 20.
// The Jacobians are read once each, in the order the sweep consumes them,
// coalesced over the lanes; the rest is the multipass kernel's design
// (nmpc_device.cuh).
#include "nmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct PassArgs {
  km::Nmpc op;         // rdiag: this pass's input cost + rho bsizes
  const float* Jt;     // (KN_NP * KN_NZA * KN_NZ, B) stage Jacobians
  const float* cv;     // (KN_NP * KN_NZ, B) defects
  const float* zeta;   // (KN_NZ, B) scaled outputs
  const float* up;     // (KM_M, B) previous input, scaled
  const float* sqRef;  // (KN_P) shared or (KN_P, B) per lane
  const float* x0;     // (KM_N, B) primal start
  const float* q0;     // (KM_N, B) Levenberg term, or null
  const float* lam0;   // (KM_MC, B) dual start, row-equilibrated, or null
  float* x;            // (KM_N, B)
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
  float* obj;          // (B) objective scale
  long long B;
  int sqRef_lanes;
  int iters;
  float slack_floor;
};

__global__ void __launch_bounds__(KM_THREADS)
nmpc_pass_kernel(const PassArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  const km::Nmpc& op = a.op;
  float zeta[KN_NZ], up[KM_M], x[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) zeta[i] = a.zeta[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + b];
#pragma unroll
  for (int i = 0; i < KM_N; ++i) x[i] = a.x0[i * B + b];
  const float* sq = a.sqRef_lanes ? a.sqRef + b : a.sqRef;
  const long long sq_step = a.sqRef_lanes ? B : 1;
  km::rhs_b(op.cFr, op.F0r, up, rhs);
  float Pr[KM_N][KM_N], q[KM_N];
  {
    km::ShippedJacobians stages{a.Jt + b, a.cv + b, B};
    km::condense_sweep(op, stages, zeta, up, sq, sq_step, Pr, q);
  }
  const float obj = km::solve_pass(
      op.con, a.iters, a.slack_floor, Pr, q,
      km::LaneTerm{a.q0 ? a.q0 + b : nullptr, B},
      km::LaneDuals{a.lam0 ? a.lam0 + b : nullptr, B}, rhs, x, s, lam);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = x[i];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
  a.obj[b] = obj;
}

extern "C" int km_nmpc_pass(const PassArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  nmpc_pass_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
