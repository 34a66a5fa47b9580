// One SQP pass of the NMPC with the stage Jacobians and defects formed in
// the kernel, batched: one CUDA thread per lane.
//
// Replaces the TPU kernel _nmpc_stage_kernel (koopman_realizations_tpu/
// ops/pallas/qp_ipm.py:1560, called at :1961 by
// solve_qp_nmpc_stages_batched), which the JAX controller's per-pass loop
// (control/kmpc.py:_solve_from, :1439-1568) launches once per SQP pass
// when the whole-SQP route does not apply: warm SQP duals, a damping
// decay, a line search, best-of-passes, the multistart's second solve.
// The linearization trajectory has one of three sources, fixed per build
// (KN_STAGE_MODE): 0 'ship', the lane's Zl/Ul/Fv (J formed here, F not);
// 1 'hold', every stage at (zeta, u_prev) with F and J formed once; 2
// 'roll', the lane's plan Ul rolled through F from zeta.  Then the
// sensitivity condensation streamed into the factored Gram with the
// pass's rdiag, the per-lane Levenberg term q0 (optional), the objective
// scale and the Mehrotra loop from the shipped x0 with cold duals or a
// warm lam0 (row-equilibrated units; sqrt(clip(lam0 / obj, 1e-4, 1e4)),
// qp_ipm.py:1710-1711).  The wrapper (ops/kernels/nmpc_stage.py:
// solve_qp_nmpc_stages) scales lam0 by the rows, forms the ok mask and
// returns the multipliers in original units, as the JAX wrapper does.
//
// Bound on an H100: compute.  A 'roll' pass needs ~0.14 M operations per
// lane (ten F and J evaluations, the sweep, 8 Mehrotra iterations), a
// 'ship' pass ~0.11 M and a 'hold' pass ~0.06 M (chip_smoke.py:
// nmpc_onepass_ops), on 0.5-1.1 KB of lane input and output, so the f32
// rate (67 TFLOP/s outside the tensor cores) sets the floor.  The design is
// the multipass kernel's (nmpc_device.cuh): one forward sweep over the
// stages with the W block never stored, statically indexed per-lane
// arrays, lane-shared operands as warp-uniform broadcasts through the
// read-only cache, the shipped trajectory read coalesced over the lanes.
#include "nmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif
#ifndef KN_STAGE_MODE
#error "nmpc_stage.cu needs KN_STAGE_MODE (0 ship, 1 hold, 2 roll)"
#endif

struct StageArgs {
  km::Nmpc op;         // rdiag: this pass's input cost + rho bsizes
  const float* Zl;     // (KN_NP * KN_NZ, B) 'ship'
  const float* Ul;     // (KN_NP * KM_M, B) 'ship', 'roll'
  const float* Fv;     // (KN_NP * KN_NZ, B) 'ship'
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
nmpc_stage_kernel(const StageArgs a) {
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
#if KN_STAGE_MODE == 0
    km::ShippedStages stages{op, a.Zl + b, a.Ul + b, a.Fv + b, B};
#elif KN_STAGE_MODE == 1
    km::RolledStages<km::HeldInput> stages(op, km::HeldInput{up}, true, zeta);
#else
    km::RolledStages<km::LaneInput> stages(op, km::LaneInput{a.Ul + b, B},
                                           false, zeta);
#endif
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

extern "C" int km_nmpc_stage(const StageArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  nmpc_stage_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
