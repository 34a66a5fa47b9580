// One SQP pass of the NMPC from shipped stage Jacobians and defects,
// batched: the stage sweep a thread per lane, the pass's QP a group of
// threads per lane (nmpc_group.cuh, ipm_group.cuh).
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
//
// Design: the skeleton of nmpc_group.cuh in two launches (nmpc_stage.cu's,
// with another stage source).  The sweep launch runs each lane over its
// shipped Jacobians -- read once each, in the order the sweep consumes
// them, coalesced over the lanes -- a thread per lane, and writes the
// pass's scaled Hessian and q (with the per-lane q0) to the lane's device
// scratch row; the solve launch then solves the lanes' QPs a group of
// KG_GROUP threads a lane, from x0 with cold duals or the warm lam0.  The
// plan is ops/kernels/ipm_group.py:onepass_plan; its wide builds (n=27)
// hand the projected rows over and form the Gram by the group
// (nmpc_stage.cu's note).
#include "nmpc_group.cuh"

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
  float* scratch;      // (grid * KG_LANES, KG_T + KM_N) hand-over
  long long B;
  int sqRef_lanes;
  int iters;
  float slack_floor;
};

// Lane b's sweep over its shipped Jacobians and defects.
struct PassSweep {
  const PassArgs& a;
  template <class Sink>
  __device__ __forceinline__ void operator()(long long b,
                                             const float (&zeta)[KN_NZ],
                                             const float (&up)[KM_M],
                                             const Sink& sink) const {
    km::ShippedJacobians stages{a.Jt + b, a.cv + b, a.B};
    km::condense_sweep(a.op, stages, zeta, sink);
  }
};

__global__ void __launch_bounds__(KG_THREADS)
nmpc_pass_sweep(const PassArgs a) {
  kn::sweep_pass(a, PassSweep{a});
}

__global__ void KG_BOUNDS nmpc_pass_kernel(const PassArgs a) {
  kn::one_pass(a);
}

extern "C" int km_nmpc_pass(const PassArgs* args, void* stream) {
  return kl::launch_front_solve<PassArgs>(nmpc_pass_sweep, nmpc_pass_kernel,
                                          args, stream);
}
