// Whole-SQP NMPC solve, batched: every relinearization pass in one
// launch; the stage sweep a thread per lane, each pass's QP a group of
// threads per lane (ipm_group.cuh).
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
// are row slices of x_prev.  The wrapper (ops/kernels/nmpc_multipass.py:
// solve_qp_nmpc_multipass) does the ok mask and the multipliers' return
// to original units, as the JAX wrapper does.
//
// Bound on an H100: compute.  At the NMPC configuration (nz=6, m=3, poly-3
// over 9 inputs: A1 6x9, A2 6x210, G 54x54; n=12, mc=48, horizon 10, 5
// passes, 8 iterations) a lane needs ~0.7 M operations on ~0.4 KB of lane
// input and output, so the f32 rate (67 TFLOP/s outside the tensor
// cores), not the 3.35 TB/s, sets the floor.
//
// Design (the skeleton of nmpc_group.cuh, shared with the one-pass
// kernels nmpc_stage.cu and nmpc_pass.cu): a block takes KG_LANES lanes,
// one a thread.  Each pass, every thread runs its lane's forward sweep
// over the stages (nmpc_device.cuh:condense_sweep with the rolled source:
// F, J, defects, propagation and the projected rows' Gram terms; the W
// block is never stored), forms the pass's QP -- P = 2 (W^T W + diag r),
// q = 2 W^T v + q0c x_prev, the objective scale and the regularization
// (kn::hand_over) -- and hands the scaled Hessian (packed, 78 floats at
// n=12) and q over through a device scratch row of its own (x_prev and
// u_prev through shared memory).  The block then solves its lanes' QPs KG_THREADS /
// KG_GROUP at a time with the cooperative Mehrotra loop (a group of
// KG_GROUP threads a lane, the Hessian copied into the group's shared
// work region, the factor beside it), each from x_prev with cold duals;
// x goes back to the lane's thread as the next pass's x_prev, and after
// the last pass the groups store s and lam.  The sweep keeps the
// thread-per-lane form: its per-stage products are 6-15 wide and serial
// over the stages.  The wide build (the unblocked stack, n=27, mc=108:
// 30 sensitivity columns) cannot keep the Gram's 378 entries in a
// thread's registers beside them: its sweep writes the pass's 22
// projected rows [w | v] (616 floats) to the lane's scratch row instead,
// x_prev stays in the lane region, and a warp a lane copies the rows into
// its work region and forms the Gram, the objective scale and the scaled
// Hessian there (nmpc_group.cuh:GramHessian, ipm_factored's Gram) before
// its Mehrotra loop.  It reads ~17 KB of lane-shared operands and spills
// through the L1 cache, which shares the SM's 256 KB with shared memory:
// hence the hand-over through device memory (written and read back
// within the pass, an L2 round trip) rather than a shared tile of all the
// block's lanes.
#include "nmpc_group.cuh"

struct NmpcArgs {
  km::Nmpc op;
  const float* zeta;   // (KN_NZ, B) scaled outputs
  const float* up;     // (KM_M, B) previous input, scaled
  const float* sqRef;  // (KN_P) shared or (KN_P, B) per lane
  float* x;            // (KM_N, B) last pass's moves
  float* s;            // (KM_MC, B)
  float* lam;          // (KM_MC, B) equilibrated multipliers
  float* obj;          // (B) last pass's objective scale
  float* scratch;      // (grid * KG_LANES, KG_T + KM_N) hand-over
  long long B;
  int sqRef_lanes;
  int iters;
  int passes;
  int hold0;
};

__global__ void KG_BOUNDS
nmpc_multipass_kernel(const NmpcArgs a) {
  float* sm = kg::dynamic_smem();
  const int tid = threadIdx.x;
  const int grp = tid / KG_GROUP, g = tid % KG_GROUP;
  const long long B = a.B;
  const long long b = (long long)blockIdx.x * KG_LANES + tid;
  const bool live = b < B;
  // a lane past the batch sweeps a copy of the last lane and stores
  // nothing: every thread takes part in the block's solves
  const long long bl = live ? b : B - 1;
  const km::Nmpc& op = a.op;
  const kg::Shared sh = kg::shared_view(sm);
  float* H = kg::lane_region(sm, tid);
  kg::load_shared(op.con, sh, tid);

  float zeta[KN_NZ], up[KM_M];
#pragma unroll
  for (int i = 0; i < KN_NZ; ++i) zeta[i] = a.zeta[i * B + bl];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) {
    up[j] = a.up[j * B + bl];
    H[KG_H_UP + j] = up[j];
  }
  const float* sq = a.sqRef_lanes ? a.sqRef + bl : a.sqRef;
  const long long sq_step = a.sqRef_lanes ? B : 1;
#ifndef KG_S_W
  float xp[KM_N];
#endif
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < KM_M; ++j) acc = fmaf(km::ldg(op.Gup + i * KM_M + j), up[j], acc);
#ifndef KG_S_W
    xp[i] = acc;
#endif
    H[KG_L_X + i] = acc;
  }
#ifdef KG_S_W
  // the wide build: x_prev stays in the lane region, the sweep writes the
  // pass's projected rows and the groups form each lane's QP
#pragma unroll 1
  for (int pass = 0; pass < a.passes; ++pass) {
    {
      km::RolledStages<km::SharedPlanInput> stages(
          op, km::SharedPlanInput{up, H + KG_L_X}, pass == 0 && a.hold0,
          zeta);
      km::condense_sweep(op, stages, zeta,
                         km::RowSink{op, up, sq, sq_step,
                                     kl::scratch_row(a.scratch, b) + KG_S_W});
    }
    __syncthreads();
    const bool last = pass + 1 == a.passes;
#pragma unroll 1
    for (int round = 0; round < KG_ROUNDS; ++round) {
      const int ql = round * KG_GROUPS + grp;
      kn::solve_lane(a, sh, sm, ql, grp, g, last, 1e-2f,
                     kn::XprevTerm{op.q0c, kg::lane_region(sm, ql)},
                     kl::ColdDuals{});
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = H[KG_L_X + i];
  a.obj[b] = H[KG_L_OBJ];
#else
  float obj = 1.0f;
#pragma unroll 1
  for (int pass = 0; pass < a.passes; ++pass) {
    {
      float Pr[KM_N][KM_N], q[KM_N];
      km::RolledStages<km::PlanInput> stages(op, km::PlanInput{up, xp},
                                             pass == 0 && a.hold0, zeta);
      km::condense_sweep(op, stages, zeta,
                         km::GramSink(op, up, sq, sq_step, Pr, q));
      obj = kn::hand_over(Pr, q, kn::LevenbergTerm{op.q0c, xp},
                          kl::scratch_row(a.scratch, b));
    }
    __syncthreads();
    const bool last = pass + 1 == a.passes;
#pragma unroll 1
    for (int round = 0; round < KG_ROUNDS; ++round)
      kn::solve_lane(a, sh, sm, round * KG_GROUPS + grp, grp, g, last, 1e-2f,
                     0, kl::ColdDuals{});
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KM_N; ++i) xp[i] = H[KG_L_X + i];
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < KM_N; ++i) a.x[i * B + b] = xp[i];
  a.obj[b] = obj;
#endif
}

extern "C" int km_nmpc_multipass(const NmpcArgs* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      nmpc_multipass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((args->B + KG_LANES - 1) / KG_LANES);
  nmpc_multipass_kernel<<<grid, KG_THREADS, KG_SMEM_BYTES,
                          (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
