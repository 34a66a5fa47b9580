// Assembly-fused bilinear MPC QP from the lifted state, batched, in two
// launches: the assembly, Gram and objective scale a thread per lane,
// then the QP a group of threads per lane (lane_group.cuh,
// ipm_group.cuh).
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
// input and output.
//
// Design: bilin_lift.cu's with the lifted state in place of the lift's
// features (km::StateFeatures).  The front launch (bilin_front: 128-thread
// blocks, a thread a lane, no cap on its registers) reads the 352 x 28
// generator stack as warp-uniform 16-byte broadcasts through the
// read-only cache, its all-zero rows skipped, streams W row by row into
// the Gram and never holds it, and writes the packed, scaled, regularized
// Hessian, the scaled q and obj to the lane's scratch row.  The solve
// launch (bilin_kernel, under the plan's launch bounds) solves the
// block's lanes' QPs a group of KG_GROUP threads a lane from the warm
// duals (cold where lam0 is null); the group stores s and lam, then each
// thread x and obj.  Every per-lane load and store is coalesced
// (lanes-minor).  The plan is ops/kernels/ipm_group.py:bilin_lift_plan,
// measured fastest for this QP.
//
// Aliasing: the outputs are fresh tensors of the wrapper, never an input,
// so no launch reads what it writes.
#include "lane_group.cuh"

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
  float* scratch;      // (grid * KG_LANES, KG_SCRATCH) hand-over
  long long B;
  int sqYr_lanes;
  int iters;
  float slack_floor;
};

__global__ void __launch_bounds__(KG_THREADS)
bilin_front(const BilinArgs a) {
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + threadIdx.x;
  const long long bl = b < B ? b : B - 1;
  kl::bilin_front(a, km::StateFeatures{a.z + bl, B}, b, bl);
}

__global__ void KG_BOUNDS bilin_kernel(const BilinArgs a) {
  kl::solve_block(a.qp.con, a.B, kl::BilinLanes<BilinArgs>{a});
}

extern "C" int km_bilin(const BilinArgs* args, void* stream) {
  return kl::launch_front_solve<BilinArgs>(bilin_front, bilin_kernel, args,
                                           stream);
}
