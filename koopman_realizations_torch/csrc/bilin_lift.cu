// Lift-fused bilinear MPC QP, batched, in two launches: the lift,
// assembly, Gram and objective scale a thread per lane, then the QP a
// group of threads per lane (lane_group.cuh, ipm_group.cuh).
//
// Replaces the TPU kernel _bilin_lift_kernel (koopman_realizations_tpu/
// ops/pallas/qp_ipm.py:772, called at :951 by
// solve_qp_bilinear_lifted_batched): poly lift of the raw zeta, QP
// assembly against the lane-shared generators, factored Gram, objective
// scale, banded A^T D A and the Mehrotra loop with the sqrt-damped dual
// warm start.  The ok mask and the multipliers' return to original units
// run in the wrapper (ops/kernels/bilin_lift.py), as they do in the JAX
// wrapper.
//
// Bound on an H100: compute.  At the bench shape (n=12, mc=48, p=22,
// 84 generator columns, 4 iterations) a lane needs ~6.6e4 operations,
// counting only the nonzeros of the shared operands (chip_smoke.py:
// qp_ops), on ~0.5 KB of lane input and output, so the card's f32 rate
// (67 TFLOP/s outside the tensor cores), not its 3.35 TB/s, sets the
// floor.
//
// Design: step_fused.cu without the plant and the freeze.  The front
// launch (bilin_lift_front: 128-thread blocks, a thread a lane, no cap on
// its registers) runs the lift, the assembly against the lane-shared
// generators without their all-zero rows (warp-uniform broadcasts through
// the read-only cache), the factored Gram (kmpc_device.cuh:assemble) and
// the objective scale, and writes the packed, scaled, regularized
// Hessian, the scaled q and obj to the lane's scratch row.  The solve
// launch (bilin_lift_kernel, under the plan's launch bounds) loads the
// constraint operands into shared memory, puts each lane's u_prev, x0 and
// obj into its lane region, and solves the block's lanes' QPs a group of
// KG_GROUP threads a lane from the warm duals sqrt(clip(lam0 / obj, 1e-4,
// 1e4)) (cold where lam0 is null) and b = cFr - F0r u_prev; the group
// stores s and lam, then each thread x and obj.  The front's lane and the
// solve's lanes are lane_group.cuh's bilin_front and BilinLanes, shared
// with bilin.cu, which differs only in its features.  The plan (group,
// lanes a block, launch bounds, layout) is ops/kernels/ipm_group.py:
// bilin_lift_plan.
//
// Aliasing: the outputs are fresh tensors of the wrapper, never an input,
// so no launch reads what it writes.
#include "lane_group.cuh"

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
  float* scratch;      // (grid * KG_LANES, KG_SCRATCH) hand-over
  long long B;
  int sqYr_lanes;
  int iters;
  float slack_floor;
};

__global__ void __launch_bounds__(KG_THREADS)
bilin_lift_front(const BilinLiftArgs a) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const long long bl = b < B ? b : B - 1;
  float zeta[KM_NZ];
#pragma unroll
  for (int i = 0; i < KM_NZ; ++i) zeta[i] = a.zeta[i * B + bl];
  kl::bilin_front(a, km::LiftFeatures{zeta}, b, bl);
}

__global__ void KG_BOUNDS bilin_lift_kernel(const BilinLiftArgs a) {
  kl::solve_block(a.qp.con, a.B, kl::BilinLanes<BilinLiftArgs>{a});
}

extern "C" int km_bilin_lift(const BilinLiftArgs* args, void* stream) {
  return kl::launch_front_solve<BilinLiftArgs>(bilin_lift_front,
                                               bilin_lift_kernel, args,
                                               stream);
}
