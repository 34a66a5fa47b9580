// One whole closed-loop MPC step of the bilinear controller per lane, in
// two launches: the lift, assembly, Gram and plant a thread per lane,
// then the QP a group of threads per lane (step_group.cuh, lane_group.cuh,
// ipm_group.cuh).
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
// ~6.6e4 counting only the nonzeros of the shared operands, plant ~4e3;
// chip_smoke.py:qp_ops, plant_ops) on ~0.6 KB of carry read and written,
// so at B=262144 the floor is ~0.28 ms of f32 arithmetic against ~0.05 ms
// of memory traffic.  The assembly skips the generator stack's all-zero
// rows (stages no move reaches: kmpc_device.cuh:assemble).
//
// Design.  The front launch (step_fused_front: 128-thread blocks, a
// thread a lane, no cap on its registers) runs the lift, the assembly
// against the lane-shared generators (warp-uniform broadcasts through the
// read-only cache), the factored Gram (kmpc_device.cuh:assemble, which
// includes the Gram's factor 2) and the objective scale, and writes the
// packed, scaled, regularized Hessian, the scaled q and obj to the lane's
// scratch row; then it runs the plant, which does not depend on this
// step's QP, and writes the new plant state, the marker outputs and the
// finite flag to the same row.  The solve launch (step_fused_kernel,
// under the plan's launch bounds) loads the constraint operands into
// shared memory, puts each lane's u_prev, x0 and obj into its lane
// region, and solves the block's lanes' QPs a group of KG_GROUP threads a
// lane from the warm duals sqrt(clip(lamc / obj, 1e-4, 1e4)) (lanes past
// the batch from cold duals: lamc may be the output); the group
// forms the ok mask and the freeze decision and stores the dual carry;
// then each thread freezes its lane and advances the carry.  The plan
// (group, lanes a block, launch bounds, layout) is ops/kernels/
// ipm_group.py:step_plan.
//
// Aliasing: the front launch writes only the scratch, so the output carry
// may alias the input carry (Ksim.fused_runner updates ysc, upsc, xpl,
// x0 and lamc in place); in the solve launch every element is read
// before it is written, by the thread that writes it.
#include "step_group.cuh"

struct StepArgs {
  km::QP qp;
  const float* Pwarm;    // (KM_N, KM_N) receding-horizon primal shift
  const float* sqYr;     // (KM_P) shared or (KM_P, B) per lane
  km::StepIO io;         // carries; the dual carry in row-eq. * obj units
  float* scratch;        // (grid * KG_LANES, KG_SCRATCH) hand-over
  long long B;
  int sqYr_lanes;
  int iters;
};

__global__ void __launch_bounds__(KG_THREADS)
step_fused_front(const StepArgs a) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const long long bl = b < B ? b : B - 1;
  float zeta[KM_NZ], up[KM_M];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.io.ysc[i * B + bl];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.io.upsc[j * B + bl];
  float* hs = kl::scratch_row(a.scratch, b);
  {
    const float* sq = a.sqYr_lanes ? a.sqYr + bl : a.sqYr;
    const long long sq_step = a.sqYr_lanes ? B : 1;
    float P[KM_N][KM_N], q[KM_N], rhs[KM_MC];
    km::assemble(a.qp, km::LiftFeatures{zeta}, up, sq, sq_step, P, q, rhs);
    hs[KG_S_OBJ] = kl::pack_scaled(P, q, hs);
  }
  kst::plant_front(a.io, bl, B, up, hs);
}

__global__ void KG_BOUNDS step_fused_kernel(const StepArgs a) {
  kl::solve_block(
      a.qp.con, a.B,
      kst::StepLanes<StepArgs, kl::ScratchHessian, kl::ScratchGradient,
                     kl::CarryDuals>{a, a.qp.cFr, a.qp.F0r, {}, {},
                                     {{a.io.lamc, a.B}}});
}

extern "C" int km_step_fused(const StepArgs* args, void* stream) {
  return kl::launch_front_solve<StepArgs>(step_fused_front, step_fused_kernel,
                                          args, stream);
}
