// One SQP pass of the NMPC with the stage Jacobians and defects formed in
// the kernel, batched: the stage sweep a thread per lane, the pass's QP a
// group of threads per lane (nmpc_group.cuh, ipm_group.cuh).
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
// rate (67 TFLOP/s outside the tensor cores) sets the floor.
//
// Design: the skeleton of nmpc_group.cuh, in two launches.  The sweep
// (nmpc_stage_sweep, a thread per lane, no cap on its registers) runs
// each lane's stages along the build's trajectory source
// (nmpc_device.cuh:condense_sweep: one forward sweep, the W block never
// stored, lane-shared operands as warp-uniform broadcasts through the
// read-only cache, the shipped trajectory read coalesced over the
// lanes), forms the pass's QP with the per-lane q0 and writes the scaled
// Hessian and q to the lane's device scratch row and obj to its output.
// The solve (nmpc_stage_kernel) takes KG_LANES lanes a block: each thread
// writes its lane's u_prev, shipped x0 and obj into the lane's shared
// region (loads coalesced over the lanes), then the block solves its
// lanes' QPs KG_THREADS / KG_GROUP at a time, a group of KG_GROUP threads
// a lane, from x0 with cold duals or the warm lam0; the groups store s
// and lam, the threads x.  The plan (group, lanes a block, launch
// bounds, layout) is ops/kernels/ipm_group.py:onepass_plan.  The wide
// builds (the unblocked stack, n=27: KG_S_W) hand the pass's projected
// rows over instead of the Hessian, and a warp a lane forms the Gram,
// obj and the Levenberg term in the solve launch (nmpc_group.cuh).
#include "nmpc_group.cuh"

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
  float* scratch;      // (grid * KG_LANES, KG_T + KM_N) hand-over
  long long B;
  int sqRef_lanes;
  int iters;
  float slack_floor;
};

// Lane b's sweep along the build's trajectory source.
struct StageSweep {
  const StageArgs& a;
  template <class Sink>
  __device__ __forceinline__ void operator()(long long b,
                                             const float (&zeta)[KN_NZ],
                                             const float (&up)[KM_M],
                                             const Sink& sink) const {
#if KN_STAGE_MODE == 0
    km::ShippedStages stages{a.op, a.Zl + b, a.Ul + b, a.Fv + b, a.B};
#elif KN_STAGE_MODE == 1
    km::RolledStages<km::HeldInput> stages(a.op, km::HeldInput{up}, true,
                                           zeta);
#else
    km::RolledStages<km::LaneInput> stages(
        a.op, km::LaneInput{a.Ul + b, a.B}, false, zeta);
#endif
    km::condense_sweep(a.op, stages, zeta, sink);
  }
};

__global__ void __launch_bounds__(KG_THREADS)
nmpc_stage_sweep(const StageArgs a) {
  kn::sweep_pass(a, StageSweep{a});
}

__global__ void KG_BOUNDS nmpc_stage_kernel(const StageArgs a) {
  kn::one_pass(a);
}

extern "C" int km_nmpc_stage(const StageArgs* args, void* stream) {
  return kl::launch_front_solve<StageArgs>(nmpc_stage_sweep,
                                           nmpc_stage_kernel, args, stream);
}
