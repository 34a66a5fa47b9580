// Whole-SQP NMPC solve, batched: every relinearization pass in one
// launch, one CUDA thread per lane.
//
// Replaces the TPU kernel _nmpc_multipass_kernel (koopman_realizations_tpu/
// ops/pallas/qp_ipm.py:1422, called at :1801 by
// solve_qp_nmpc_multipass_batched) in the default SQP regime the JAX
// controller routes to it: pass 0 linearizes about the held state (or the
// rollout of the held plan), every later pass along the rollout of the
// previous pass's moves through the composed F; each pass condenses its
// stage Jacobians and defects into the factored QP, adds the Levenberg
// term q0c * x_prev and runs the Mehrotra loop from x_prev with cold duals
// and the slack floor 1e-2 (hard-coded, as in the TPU kernel).  The inter-
// pass glue is in-kernel: the pass-0 plan is Gup u_prev, the stage inputs
// are row slices of x_prev.  The stage sweep and the pass's QP are the
// device functions the one-pass kernels share (nmpc_device.cuh:
// condense_sweep with the rolled source, solve_pass).  The wrapper (ops/kernels/nmpc_multipass.py:
// solve_qp_nmpc_multipass) does the ok mask and the multipliers' return
// to original units, as the JAX wrapper does.
//
// Bound on an H100: compute.  At the NMPC configuration (nz=6, m=3, poly-3
// over 9 inputs: A1 6x9, A2 6x210, G 54x54; n=12, mc=48, horizon 10, 5
// passes, 8 iterations) a lane needs ~0.7 M operations on ~0.4 KB of lane
// input and output, so the f32 rate (67 TFLOP/s outside the tensor
// cores), not the 3.35 TB/s, sets the floor.  The design fuses each pass
// into one forward sweep over the stages (F, J, defects, propagation and
// the projected rows' Gram terms per stage; the W block is never stored),
// forms F and J once in the 'hold' pass, keeps every per-lane array
// statically indexed (stage-dependent columns by selects, not by
// addresses), and reads the ~17 KB of lane-shared operands as
// warp-uniform broadcasts through the read-only cache (G as 16-byte
// loads).  The G g_low products (~40 % of the work) are where tensor cores
// would enter in a later tuning pass; spills and occupancy are the other.
#include "nmpc_device.cuh"

#ifndef KM_THREADS
#define KM_THREADS 128
#endif

struct NmpcArgs {
  km::Nmpc op;
  const float* zeta;   // (KN_NZ, B) scaled outputs
  const float* up;     // (KM_M, B) previous input, scaled
  const float* sqRef;  // (KN_P) shared or (KN_P, B) per lane
  float* x;            // (KM_N, B) last pass's moves
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
  float* obj;          // (B) last pass's objective scale
  long long B;
  int sqRef_lanes;
  int iters;
  int passes;
  int hold0;
};

__global__ void __launch_bounds__(KM_THREADS)
nmpc_multipass_kernel(const NmpcArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long B = a.B;
  const km::Nmpc& op = a.op;
  float zeta[KN_NZ], up[KM_M], xp[KM_N], s[KM_MC], lam[KM_MC], rhs[KM_MC];
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) zeta[i] = a.zeta[i * B + b];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + b];
  const float* sq = a.sqRef_lanes ? a.sqRef + b : a.sqRef;
  const long long sq_step = a.sqRef_lanes ? B : 1;
  km::rhs_b(op.cFr, op.F0r, up, rhs);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < KM_M; ++j) acc = fmaf(km::ldg(op.Gup + i * KM_M + j), up[j], acc);
    xp[i] = acc;
  }
  float obj = 1.0f;
#pragma unroll 1
  for (int pass = 0; pass < a.passes; ++pass) {
    float Pr[KM_N][KM_N], q[KM_N];
    {
      km::RolledStages<km::PlanInput> stages(op, km::PlanInput{up, xp},
                                             pass == 0 && a.hold0, zeta);
      km::condense_sweep(op, stages, zeta, up, sq, sq_step, Pr, q);
    }
    // the Levenberg term q0c * x_prev, cold duals; the primal start is
    // the previous pass's x; x_prev <- x
    obj = km::solve_pass(op.con, a.iters, 1e-2f, Pr, q,
                         km::LevenbergTerm{op.q0c, xp}, km::ColdDuals{}, rhs,
                         xp, s, lam);
  }
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = xp[i];
#pragma unroll
  for (int c = 0; c < KM_MC; ++c) {
    a.s[c * B + b] = s[c];
    a.lam[c * B + b] = lam[c];
  }
  a.obj[b] = obj;
}

extern "C" int km_nmpc_multipass(const NmpcArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  const unsigned grid = (unsigned)((args->B + KM_THREADS - 1) / KM_THREADS);
  nmpc_multipass_kernel<<<grid, KM_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
