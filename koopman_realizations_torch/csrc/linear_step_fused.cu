// One whole closed-loop step of the LINEAR Koopman MPC per lane, in two
// launches: the gradient and plant a thread per lane, then the QP a group
// of threads per lane against one copy of the lane-shared Hessian a block
// (step_group.cuh, lane_group.cuh, ipm_group.cuh).
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
// the plant/freeze/carry tail of the bilinear step: SDIRK2 of the arm on
// the PREVIOUS input, the markers, the alive freeze, the Pwarm @ x primal
// start and the dual carry lam (equilibrated units, unused by the next
// step).
//
// Bound on an H100: compute.  A lane-step needs ~3.5e4 operations (six
// Mehrotra iterations ~3e4, the gradient ~2e3, the plant ~4e3;
// chip_smoke.py:mehrotra_ops, linear_grad_ops, plant_ops) on ~0.6 KB of
// carry read and written, so the f32 rate (67 TFLOP/s outside the tensor
// cores), not the 3.35 TB/s, sets the floor.
//
// Design.  The front launch (linear_step_front: 128-thread blocks, a
// thread a lane, no cap on its registers) runs the plant, writing the new
// plant state, the marker outputs and the finite flag to the lane's
// scratch row.  The solve launch (linear_step_fused_kernel, under the
// plan's launch bounds) loads the constraint operands and the packed
// lower triangle of Psh, regularized on its diagonal, into shared memory
// once a block -- every group's Hessian, with no per-lane or per-group
// copy, so Psh must be symmetric bitwise (the host checks it) -- puts
// each lane's u_prev and x0 into its lane region and solves the block's
// lanes' QPs a group of KG_GROUP threads a lane from cold duals: each
// thread of the group lifts the lane's zeta and forms the gradient
// entries it owns (the generators, fYr and P21 read as broadcasts through
// the read-only cache; measured 0.1 ms faster at B=262144 than the
// gradient formed in the front launch and carried in the scratch row,
// PERF.md §6); the group forms the ok mask and the freeze decision and
// stores the dual carry; then each thread freezes its lane and advances
// the carry.  The plan is ops/kernels/ipm_group.py:step_plan.
//
// Aliasing: the front launch writes only the scratch, so the output carry
// may alias the input carry (Ksim.fused_runner updates ysc, upsc, xpl,
// x0 and lamc in place); in the solve launch every element is read
// before it is written, by the thread that writes it.
#include "step_group.cuh"

struct LinearStepArgs {
  km::Cons con;
  const float* Psh;      // (KM_N, KM_N) reduced Hessian / obj, symmetric
  const float* G1;       // (KM_N, KM_NCP) [G1z | G1m | G1b | 0] / obj
  const float* P21;      // (KM_N, KM_M) u_prev coupling / obj
  const float* cFr;      // (KM_MC)
  const float* F0r;      // (KM_MC, KM_M)
  const float* Pwarm;    // (KM_N, KM_N) receding-horizon primal shift
  const float* fYr;      // (KM_N) G2 @ Yr of this step
  km::StepIO io;         // carries; the dual carry in equilibrated units
  float* scratch;        // (grid * KG_LANES, KG_SCRATCH) hand-over
  long long B;
  int iters;
};

// The gradient formed by the group in the solve launch: every thread
// lifts the lane's zeta and forms the entries it owns,
//   q_i = G1_i f + fYr_i + P21_i u_prev
// (u_prev from the lane region).
struct LiftGradient {
  const LinearStepArgs& a;
  __device__ __forceinline__ void operator()(const float* H, const float*,
                                             long long bl, int g,
                                             float (&q)[KG_NO]) const {
    float zeta[KM_NZ], f[KM_NCP];
#pragma unroll
    for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.io.ysc[i * a.B + bl];
    km::lift_features(zeta, f);
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      if (i >= KM_N) {
        q[o] = 0.0f;
        continue;
      }
      float qi = km::gen_row(a.G1 + i * KM_NCP, f) + km::ldg(a.fYr + i);
#pragma unroll
      for (int j = 0; j < KM_M; ++j)
        qi = fmaf(km::ldg(a.P21 + i * KM_M + j), H[KG_H_UP + j], qi);
      q[o] = qi;
    }
  }
};

__global__ void __launch_bounds__(KG_THREADS)
linear_step_front(const LinearStepArgs a) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const long long bl = b < B ? b : B - 1;
  float up[KM_M];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.io.upsc[j * B + bl];
  kst::plant_front(a.io, bl, B, up, kl::scratch_row(a.scratch, b));
}

__global__ void KG_BOUNDS linear_step_fused_kernel(const LinearStepArgs a) {
  kl::solve_block(
      a.con, a.B,
      kst::StepLanes<LinearStepArgs, kl::BlockHessian, LiftGradient,
                     kl::ColdDuals>{a, a.cFr, a.F0r, {a.Psh}, {a}, {}});
}

extern "C" int km_linear_step_fused(const LinearStepArgs* args,
                                    void* stream) {
  return kl::launch_front_solve<LinearStepArgs>(
      linear_step_front, linear_step_fused_kernel, args, stream);
}
