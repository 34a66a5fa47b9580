// The skeleton of the kernels that hand each lane's QP from one thread to
// a group of threads: a thread per lane forms the lane's QP (and, in the
// step kernels, runs its plant) and writes it to a row of device scratch
// of its own; the block then solves its lanes' QPs KG_THREADS / KG_GROUP
// at a time, a group of KG_GROUP threads a lane, on the cooperative
// interior point (ipm_group.cuh).  Eight kernels use it: through
// nmpc_group.cuh nmpc_multipass.cu (thread-per-lane sweep and group solve
// in one launch, pass after pass), nmpc_stage.cu and nmpc_pass.cu; through
// step_group.cuh step_fused.cu and linear_step_fused.cu; bilin_lift.cu and
// bilin.cu (their fronts a thread per lane, bilin_front and BilinLanes
// below) and ipm_shared.cu (no front: the solve alone, its QPs from the
// caller).  All but nmpc_multipass and ipm_shared run in two launches on
// the stream: the front launch (a thread per lane, 128-thread launch
// bounds, no cap on its registers), then the solve launch under the
// plan's launch bounds.  Under those bounds (128 registers at 4 blocks an
// SM) a thread-per-lane front in the solve's launch spills: the NMPC
// sweep took 2-4x its thread-per-lane time there (PERF.md §5, §6).
//
// What differs between the kernels is a parameter here:
// - the Hessian: copied from the lane's scratch row into the group's work
//   region (ScratchHessian), the block's one lane-shared copy in shared
//   memory (BlockHessian: the linear step, ipm_shared's lane-shared
//   build), or the lane's own P staged by the block into the group's work
//   region, both triangles (ipm_shared's per-lane build);
// - the gradient q: from the lane's scratch row (ScratchGradient), formed
//   by the group (the linear step), or per lane from memory, read by each
//   entry's owner (LaneGradient: ipm_shared);
// - the right-hand side: b = cFr - F0r u_prev (UprevRhs), or per lane
//   from memory, read by each row's owner (LaneRhs: ipm_shared);
// - the dual start: cold (lam = 1) or warm from a per-lane lam0 in
//   row-equilibrated units, sqrt(clip(lam0_row / obj, 1e-4, 1e4));
// - what the group does with the lane's solution (the NMPC kernels,
//   bilin_lift, bilin and ipm_shared store s and lam; the step kernels
//   form the ok mask and advance the dual carry) and what the lane's
//   thread does after the block's solves.
//
// Layout (ops/kernels/ipm_group.py, the compact plan): the lane region
// holds [x: n][obj: 1][u_prev: m] (the step kernels: [keep: 1] after); the
// lane's scratch row (row b of the scratch, b the lane's place in the
// grid) the sections KG_S_* of the build (the NMPC kernels [Pr: T][q: n];
// bilin_lift and bilin [Pr: T][q: n][obj: 1]; the bilinear step [Pr: T]
// [q: n][obj: 1][plant]; the linear step [plant]); the group's work
// region [M: T][dx: n][vec: mc] and, where the Hessian comes from the
// scratch row, [Pr: T] after.  The
// scratch row is written and read back within a launch or by the next
// launch (an L2 round trip), so that the thread-per-lane code keeps the
// SM's L1 cache for its lane-shared operands and spills.
//
// A plan may also take one round of KG_GROUPS lanes a block (KG_LANES <
// KG_THREADS, ipm_shared): a thread past KG_LANES has no lane of its own
// and only helps load the block's shared operands.
//
// Lanes past the batch run a copy of the last lane: they write their
// scratch rows, take part in every barrier and shuffle of the block's
// solves, and store nothing.  Their dual start is the last lane's, except
// from CarryDuals (the step kernels), where it is cold: there the output
// dual carry may be the input, which the last lane's group may already
// have overwritten.
#pragma once

#include "ipm_group.cuh"

#define KG_H_UP KG_L_REST                   // lane region: u_prev (KM_M)
#define KG_W_PR (KG_T + KM_N + KM_MC)       // work region: the Hessian

namespace kl {

// Lane b's scratch row.
__device__ __forceinline__ float* scratch_row(float* scratch, long long b) {
  return scratch + b * KG_SCRATCH;
}

#ifdef KG_S_PR
// ---------------------------- a lane's own QP in its scratch row: Pr, q
// The QP's objective scale, then its scaled, regularized Hessian (lower
// triangle, packed) and scaled q into the lane's scratch row H, as the
// TPU kernels' factored tail forms them (qp_ipm.py:760-769: obj = max
// |P|, the largest diagonal of the PSD Gram; Pr = P / obj + reg I).
// Returns obj.
__device__ __forceinline__ float pack_scaled(const float (&Pr)[KM_N][KM_N],
                                             const float (&q)[KM_N],
                                             float* H) {
  const float obj = km::diag_obj_scale(Pr);
  const float iobj = km::kdiv(1.0f, obj);
#pragma unroll
  for (int i = 0; i < KM_N; ++i) {
    H[KG_S_Q + i] = q[i] * iobj;
#pragma unroll
    for (int k = 0; k <= i; ++k)
      H[KG_S_PR + kg::tidx(i, k)] =
          Pr[i][k] * iobj + (i == k ? km::kReg : 0.0f);
  }
  return obj;
}

// The Hessian from the lane's scratch row into the group's work region.
struct ScratchHessian {
  __device__ __forceinline__ void load(float*, int) const {}
  __device__ __forceinline__ float* operator()(float* w, const float* hs,
                                               int g) const {
    for (int t = g; t < KG_T; t += KG_GROUP) w[KG_W_PR + t] = hs[KG_S_PR + t];
    return w + KG_W_PR;
  }
};

// q to its owners from the lane's scratch row.
struct ScratchGradient {
  __device__ __forceinline__ void operator()(const float*, const float* hs,
                                             long long, int g,
                                             float (&q)[KG_NO]) const {
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      q[o] = i < KM_N ? hs[KG_S_Q + i] : 0.0f;
    }
  }
};
#endif

#ifdef KG_OFF_PSH
// The block's one copy of a lane-shared Hessian (the linear step's and
// ipm_shared's P / obj, (KM_N, KM_N), symmetric): its packed lower
// triangle with the regularization on the diagonal (the JAX kernel's
// Psh + reg * eye), loaded by every thread of the block before the
// solves; every group points at it.
struct BlockHessian {
  const float* P;
  __device__ __forceinline__ void load(float* sm, int tid) const {
    for (int t = tid; t < KG_T; t += KG_THREADS) {
      const int k = kg::tcol(t), i = k + t - kg::off(k);
      const float v = km::ldg(P + i * KM_N + k);
      sm[KG_OFF_PSH + t] = i == k ? v + km::kReg : v;
    }
  }
  __device__ __forceinline__ float* operator()(float*, const float*,
                                               int) const {
    return kg::dynamic_smem() + KG_OFF_PSH;
  }
};
#endif

// ----------------------------------------------------------- the dual start
// Each source gives, for lane bl (the lane, or for a lane past the batch
// the last lane; live: the lane is in the batch), a row function
// c -> lam_c.
struct ColdDuals {
  struct Lane {
    __device__ __forceinline__ float operator()(int) const { return 1.0f; }
  };
  __device__ __forceinline__ Lane lane(long long, const float*, bool) const {
    return Lane{};
  }
};
// lam0 (KM_MC rows, lanes-minor, row-equilibrated) or, where null, cold:
// sqrt(clip(lam0_row * (1 / obj), 1e-4, 1e4)), obj from the lane region.
struct LaneDuals {
  const float* lam0;
  long long B;
  struct Lane {
    const float* p;
    long long B;
    float iobj;
    __device__ __forceinline__ float operator()(int c) const {
      return p ? km::ksqrt(km::nclip(p[c * B] * iobj, 1e-4f, 1e4f)) : 1.0f;
    }
  };
  __device__ __forceinline__ Lane lane(long long b, const float* H,
                                       bool) const {
    return Lane{lam0 ? lam0 + b : nullptr, B,
                lam0 ? km::kdiv(1.0f, H[KG_L_OBJ]) : 1.0f};
  }
};
// LaneDuals for the lanes in the batch, cold past it: the source of the
// kernels whose output dual carry may alias lam0.
struct CarryDuals {
  LaneDuals warm;
  __device__ __forceinline__ LaneDuals::Lane lane(long long b,
                                                  const float* H,
                                                  bool live) const {
    return live ? warm.lane(b, H, live) : LaneDuals::Lane{nullptr, 0, 1.0f};
  }
};

// ------------------------------------------------ the right-hand side
// Each source gives row c's b_c for lane bl, H its lane region.
#ifdef KM_M
// b = cFr - F0r u_prev, u_prev from the lane region.
struct UprevRhs {
  const float* cFr;
  const float* F0r;
  __device__ __forceinline__ float operator()(const float* H, long long,
                                              int c) const {
    float bc = km::ldg(cFr + c);
#pragma unroll
    for (int j = 0; j < KM_M; ++j)
      bc = bc - km::ldg(F0r + c * KM_M + j) * H[KG_H_UP + j];
    return bc;
  }
};
#endif
// b per lane (KM_MC rows, lanes-minor), read by the row's owner.
struct LaneRhs {
  const float* b;
  long long B;
  __device__ __forceinline__ float operator()(const float*, long long bl,
                                              int c) const {
    return b[c * B + bl];
  }
};

// q per lane (KM_N rows, lanes-minor), read by each entry's owner.
struct LaneGradient {
  const float* q;
  long long B;
  __device__ __forceinline__ void operator()(const float*, const float*,
                                             long long bl, int g,
                                             float (&qo)[KG_NO]) const {
#pragma unroll
    for (int o = 0; o < KG_NO; ++o) {
      const int i = g + KG_GROUP * o;
      qo[o] = i < KM_N ? q[i * B + bl] : 0.0f;
    }
  }
};

// What the group of bilin_lift, bilin or ipm_shared does with its lane's
// solution: s and lam of a lane in the batch, stored by the rows' owners
// (KM_MC rows, lanes-minor).
struct StoreRows {
  float* s;
  float* lam;
  long long B;
  __device__ __forceinline__ void operator()(
      const kg::Shared&, const kg::Lane&, float*, const float*, long long b,
      int g, const float (&)[KG_R], const float (&sv)[KG_R],
      const float (&lv)[KG_R]) const {
    if (b >= B) return;
#pragma unroll
    for (int k = 0; k < KG_R; ++k) {
      const int c = g + KG_GROUP * k;
      if (c < KM_MC) {
        s[c * B + b] = sv[k];
        lam[c * B + b] = lv[k];
      }
    }
  }
};

// One lane's QP by its group: the Hessian and q from their sources (hdot:
// how r_d = Pr x reads the Hessian, ipm_group.cuh), b and the dual start
// for the group's rows, the Mehrotra loop from the lane region's x
// (updated in place), then done(sh, L, H, hs, b, g, rhs, s, lam) on the
// group.  scratch holds the lanes' scratch rows (KG_SCRATCH floats each,
// none in ipm_shared); ql is the lane's place in the block.
template <class Rhs, class Hess, class HDot, class Grad, class Duals,
          class Done>
__device__ __forceinline__ void solve_lane_from(
    float* scratch, long long B, int iters, const Rhs& rhs,
    const kg::Shared& sh, float* sm, int ql, int grp, int g,
    float slack_floor, const Hess& hess, const HDot& hdot, const Grad& grad,
    const Duals& duals, const Done& done) {
  float* H = kg::lane_region(sm, ql);
  float* w = kg::work_region(sm, grp);
  const long long b = (long long)blockIdx.x * KG_LANES + ql;
  const long long bl = b < B ? b : B - 1;
  const float* hs = scratch_row(scratch, b);
  const kg::Lane L{hess(w, hs, g), H + KG_L_X, w, w + KG_T, w + KG_T + KM_N};
  float q[KG_NO], rhs_b[KG_R], s[KG_R], lam[KG_R];
  grad(H, hs, bl, g, q);
  const auto lam0 = duals.lane(bl, H, b < B);
#pragma unroll
  for (int k = 0; k < KG_R; ++k) {
    const int c = g + KG_GROUP * k;
    float bc = 0.0f, lc = 1.0f;
    if (c < KM_MC) {
      bc = rhs(H, bl, c);
      lc = lam0(c);
    }
    rhs_b[k] = bc;
    lam[k] = lc;
  }
  kg::gsync();
  kg::mehrotra(sh, L, g, iters, slack_floor, q, rhs_b, s, lam, hdot);
  done(sh, L, H, hs, b, g, rhs_b, s, lam);
}

#ifdef KM_M
// solve_lane_from with b = cFr - F0r u_prev and the symmetric Hessian
// product; Args has scratch, B and iters.
template <class Args, class Hess, class Grad, class Duals, class Done>
__device__ __forceinline__ void solve_lane(
    const Args& a, const float* cFr, const float* F0r, const kg::Shared& sh,
    float* sm, int ql, int grp, int g, float slack_floor, const Hess& hess,
    const Grad& grad, const Duals& duals, const Done& done) {
  solve_lane_from(a.scratch, a.B, a.iters, UprevRhs{cFr, F0r}, sh, sm, ql,
                  grp, g, slack_floor, hess, kg::SymmetricHessian{}, grad,
                  duals, done);
}
#endif

#if defined(KG_S_OBJ) && defined(KM_NCP)
// ------------------------------------------- the bilinear QP kernels
// bilin_lift.cu and bilin.cu differ only in the features the generator
// columns act on (km::LiftFeatures, km::StateFeatures).  Args has qp, up,
// x0, lam0, sqYr, x, s, lam, obj, scratch, B, sqYr_lanes, iters and
// slack_floor.

// The front launch's lane b (bl: b, or the last lane past the batch): the
// QP assembled from feat and u_prev against the lane-shared generators,
// its scaled Hessian, q and obj into b's scratch row.
template <class Args, class Feat>
__device__ __forceinline__ void bilin_front(const Args& a, const Feat& feat,
                                            long long b, long long bl) {
  const long long B = a.B;
  float up[KM_M];
#pragma unroll
  for (int j = 0; j < KM_M; ++j) up[j] = a.up[j * B + bl];
  const float* sq = a.sqYr_lanes ? a.sqYr + bl : a.sqYr;
  const long long sq_step = a.sqYr_lanes ? B : 1;
  float P[KM_N][KM_N], q[KM_N], rhs[KM_MC];
  km::assemble(a.qp, feat, up, sq, sq_step, P, q, rhs);
  float* hs = scratch_row(a.scratch, b);
  hs[KG_S_OBJ] = pack_scaled(P, q, hs);
}

// The solve launch's lanes: each lane's u_prev, x0 and obj (from the
// front) into its lane region; its QP from the scratch row, warm or cold
// duals; s and lam by the rows' owners, then x and obj by the lane's
// thread.
template <class Args>
struct BilinLanes {
  const Args& a;
  __device__ __forceinline__ void load(float*, float* H, long long bl,
                                       int) const {
    const long long B = a.B;
#pragma unroll
    for (int j = 0; j < KM_M; ++j) H[KG_H_UP + j] = a.up[j * B + bl];
#pragma unroll
    for (int i = 0; i < KM_N; ++i) H[KG_L_X + i] = a.x0[i * B + bl];
    H[KG_L_OBJ] = scratch_row(a.scratch, bl)[KG_S_OBJ];
  }
  __device__ __forceinline__ void solve(const kg::Shared& sh, float* sm,
                                        int ql, int grp, int g) const {
    solve_lane(a, a.qp.cFr, a.qp.F0r, sh, sm, ql, grp, g, a.slack_floor,
               ScratchHessian{}, ScratchGradient{}, LaneDuals{a.lam0, a.B},
               StoreRows{a.s, a.lam, a.B});
  }
  __device__ __forceinline__ void store(const float* H, long long b) const {
#pragma unroll
    for (int i = 0; i < KM_N; ++i) a.x[i * a.B + b] = H[KG_L_X + i];
    a.obj[b] = H[KG_L_OBJ];
  }
};
#endif

// The solve launch's block: the lane-shared operands into shared memory,
// lanes.load(sm, H, bl, tid) for each thread's lane (H its lane region;
// in a plan of one round a block, a thread past KG_LANES has no lane and
// its load takes part only in the block's shared loads),
// the block's lanes' QPs a round of KG_GROUPS lanes at a time
// (lanes.solve(sh, sm, ql, grp, g)), then lanes.store(H, b) by each
// thread for its lane in the batch.
template <class Lanes>
__device__ __forceinline__ void solve_block(const km::Cons& con, long long B,
                                            const Lanes& lanes) {
  float* sm = kg::dynamic_smem();
  const int tid = threadIdx.x;
  const int grp = tid / KG_GROUP, g = tid % KG_GROUP;
  const long long b = (long long)blockIdx.x * KG_LANES + tid;
#if KG_LANES < KG_THREADS
  const bool live = tid < KG_LANES && b < B;
#else
  const bool live = b < B;
#endif
  const kg::Shared sh = kg::shared_view(sm);
  float* H = kg::lane_region(sm, tid);
  kg::load_shared(con, sh, tid);
  lanes.load(sm, H, live ? b : B - 1, tid);
  __syncthreads();
#pragma unroll 1
  for (int round = 0; round < KG_ROUNDS; ++round)
    lanes.solve(sh, sm, round * KG_GROUPS + grp, grp, g);
  __syncthreads();
  if (live) lanes.store(H, b);
}

// The two-launch C entry: the front launch (a thread a lane), then the
// block's solves on the same stream.
template <class Args>
int launch_front_solve(void (*front)(Args), void (*solve)(Args),
                       const Args* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, KG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((args->B + KG_LANES - 1) / KG_LANES);
  const cudaStream_t st = (cudaStream_t)stream;
  front<<<grid, KG_THREADS, 0, st>>>(*args);
  solve<<<grid, KG_THREADS, KG_SMEM_BYTES, st>>>(*args);
  return (int)cudaGetLastError();
}

// The one-launch C entry: the block's solves alone (ipm_shared).
template <class Args>
int launch_solve(void (*solve)(Args), const Args* args, void* stream) {
  if (args->B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      solve, cudaFuncAttributeMaxDynamicSharedMemorySize, KG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((args->B + KG_LANES - 1) / KG_LANES);
  solve<<<grid, KG_THREADS, KG_SMEM_BYTES, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace kl
